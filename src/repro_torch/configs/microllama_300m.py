"""MicroLlama 300M — the paper's smallest experiment model (Table 4/5).

Paper Table 4 lists d_model=2048/n_heads=12/d_head=64, which is internally
inconsistent and yields ~550M params; the released MicroLlama-300M
(github.com/keeeeenw/MicroLlama) uses hidden_size=1024, intermediate=5632,
which reproduces the paper's stated 304.6M.  We follow the released model.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="microllama-300m", arch_type="dense",
    num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=5632, vocab_size=32000, head_dim=64,
    rope_theta=10000.0, mlp_kind="swiglu", tie_embeddings=True,
    source="paper Table 4; github.com/keeeeenw/MicroLlama",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="microllama-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512)
