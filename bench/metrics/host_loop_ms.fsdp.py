"""`host_loop_ms` of the four-card FSDP-Norm cells, rank 0's loop (moves `train_tokens_per_s.fsdp`)."""

from benchkit.manifest import metric_reader

read = metric_reader("host_loop_ms")
