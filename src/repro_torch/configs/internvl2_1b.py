"""internvl2-1b [vlm] — InternViT frontend STUB (patch embeddings via
input_specs) + InternLM2-style LM backbone [arXiv:2404.16821]."""
from repro_torch.models.config import ModelConfig, FrontendConfig

CONFIG = ModelConfig(
    name="internvl2-1b", arch_type="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151655, head_dim=64,
    frontend=FrontendConfig(kind="vision_stub", num_prefix_tokens=256),
    rope_theta=1000000.0, mlp_kind="swiglu", tie_embeddings=True,
    source="arXiv:2404.16821",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="internvl2-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512,
        frontend=FrontendConfig(kind="vision_stub", num_prefix_tokens=16))
