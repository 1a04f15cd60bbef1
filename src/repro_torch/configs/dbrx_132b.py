"""dbrx-132b [moe] — 16 experts top-4, fine-grained MoE
[hf:databricks/dbrx-base]."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b", arch_type="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=10752, vocab_size=100352, head_dim=128,
    moe=MoEConfig(num_experts=16, top_k=4, d_expert=10752),
    rope_theta=500000.0, mlp_kind="swiglu", norm_kind="layernorm",
    tie_embeddings=False, source="hf:databricks/dbrx-base",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="dbrx-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=2, head_dim=32, d_ff=128, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=128, capacity_factor=2.0))
