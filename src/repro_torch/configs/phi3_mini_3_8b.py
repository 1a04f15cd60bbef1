"""phi3-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", arch_type="dense",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064, head_dim=96,
    rope_theta=10000.0, mlp_kind="swiglu", tie_embeddings=False,
    source="arXiv:2404.14219",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="phi3-mini-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512)
