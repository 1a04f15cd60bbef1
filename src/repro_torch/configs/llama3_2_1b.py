"""llama3.2-1b [dense] — small Llama 3 [hf:meta-llama/Llama-3.2-1B]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", arch_type="dense",
    num_layers=16, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab_size=128256, head_dim=64,
    rope_theta=500000.0, mlp_kind="swiglu", tie_embeddings=True,
    source="hf:meta-llama/Llama-3.2-1B",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="llama3.2-1b-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512)
