"""nemotron-4-15b [dense] — GQA, squared-ReLU MLP [arXiv:2402.16819]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", arch_type="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=24576, vocab_size=256000, head_dim=128,
    rope_theta=10000.0, mlp_kind="relu2", norm_kind="layernorm",
    tie_embeddings=False, source="arXiv:2402.16819",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="nemotron-4-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512)
