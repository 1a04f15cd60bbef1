"""mamba2-370m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m", arch_type="ssm",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280, head_dim=1,
    block_pattern=("ssd",), mlp_kind="none",
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=128),
    tie_embeddings=True, native_subquadratic=True,
    source="arXiv:2405.21060",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="mamba2-smoke", num_layers=2, d_model=128, vocab_size=512,
        ssm=SSMConfig(state_dim=16, head_dim=32, expand=2, conv_width=4,
                      chunk_size=8))
