"""TinyLlama 1.1B — the paper's FSDP-Norm experiment model (Table 4/6)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b", arch_type="dense",
    num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=5632, vocab_size=32000, head_dim=64,
    rope_theta=10000.0, mlp_kind="swiglu", tie_embeddings=False,
    source="paper Table 4; arXiv:2401.02385",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="tinyllama-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512)
