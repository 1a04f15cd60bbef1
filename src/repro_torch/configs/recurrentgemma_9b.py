"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2 recurrent : 1
attention [arXiv:2402.19427].

38 layers = 2 prefix recurrent blocks + 12 x (rglru, rglru, local); same 2:1
ratio and spacing as the released model (which starts the pattern at layer 0).
"""
from repro_torch.models.config import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", arch_type="hybrid",
    num_layers=38, d_model=4096, num_heads=16, num_kv_heads=1,
    d_ff=12288, vocab_size=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "local"), prefix_pattern=("rglru", "rglru"),
    rglru=RGLRUConfig(lru_width=4096, conv_width=4),
    sliding_window=2048, scale_embed=True,
    rope_theta=10000.0, mlp_kind="geglu", tie_embeddings=True,
    native_subquadratic=True, source="arXiv:2402.19427",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="recurrentgemma-smoke", num_layers=3, d_model=128, num_heads=4,
        num_kv_heads=1, head_dim=32, d_ff=256, vocab_size=512,
        prefix_pattern=(), rglru=RGLRUConfig(lru_width=128, conv_width=4),
        sliding_window=16)
