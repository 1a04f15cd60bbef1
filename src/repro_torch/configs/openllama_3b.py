"""OpenLlama 3B — the paper's largest experiment model (Table 4/7).
d_model follows n_heads*d_head = 32*100 = 3200 (Table 4's 2048 is a typo)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="openllama-3b", arch_type="dense",
    num_layers=26, d_model=3200, num_heads=32, num_kv_heads=32,
    d_ff=8640, vocab_size=32000, head_dim=100,
    rope_theta=10000.0, mlp_kind="swiglu", tie_embeddings=False,
    source="paper Table 4; github.com/openlm-research/open_llama",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="openllama-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512)
