"""gemma2-27b [dense] — local+global alternating attention, logit softcaps,
post-norms, scaled embeddings [arXiv:2408.00118]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", arch_type="dense",
    num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16,
    d_ff=36864, vocab_size=256000, head_dim=128,
    block_pattern=("local", "attn"), sliding_window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    post_attn_norm=True, scale_embed=True,
    rope_theta=10000.0, mlp_kind="geglu", tie_embeddings=True,
    source="arXiv:2408.00118",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="gemma2-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        sliding_window=16)
