"""`grad_accum_ms` of the four-card FSDP-Norm cells (moves `train_tokens_per_s.fsdp`)."""

from benchkit.manifest import metric_reader

read = metric_reader("grad_accum_ms")
