"""`train_tokens_per_s` of the four-card FSDP-Norm cells: their rate carries the collectives' and four hosts' spread, which the one-card cells' bound of 1 % does not hold (PERF.md §2)."""

from benchkit.manifest import metric_reader

read = metric_reader("train_tokens_per_s")
