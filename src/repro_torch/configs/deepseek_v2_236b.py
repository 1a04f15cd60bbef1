"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed experts
top-6, dense first layer [arXiv:2405.04434]."""
from repro_torch.models.config import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", arch_type="moe",
    num_layers=60, d_model=5120, num_heads=128, num_kv_heads=128,
    d_ff=1536, vocab_size=102400, head_dim=128,
    block_pattern=("mla",), prefix_pattern=("mla",),  # layer 0 dense
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, d_expert=1536,
                  num_shared_experts=2, shared_d_expert=1536, first_dense=1),
    rope_theta=10000.0, mlp_kind="swiglu", tie_embeddings=False,
    source="arXiv:2405.04434",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="deepseek-v2-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=128, vocab_size=512,
        prefix_pattern=("mla",),
        mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(num_experts=4, top_k=2, d_expert=64,
                      num_shared_experts=1, shared_d_expert=64, first_dense=1,
                      capacity_factor=2.0))
