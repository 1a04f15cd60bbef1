"""`fused_adamw_stats_roofline` of the four-card FSDP-Norm cells, over the ranks' shards (moves `train_tokens_per_s.fsdp`)."""

from benchkit.manifest import metric_reader

read = metric_reader("fused_adamw_stats_roofline")
