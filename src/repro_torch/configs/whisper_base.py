"""whisper-base [audio] — encoder-decoder; mel+conv frontend is a STUB
(input_specs provides frame embeddings) [arXiv:2212.04356]."""
from repro_torch.models.config import ModelConfig, EncoderConfig, FrontendConfig

CONFIG = ModelConfig(
    name="whisper-base", arch_type="audio",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865, head_dim=64,
    pos_embed="sinusoidal", mlp_kind="gelu", norm_kind="layernorm",
    encoder=EncoderConfig(num_layers=6, num_frames=1500),
    frontend=FrontendConfig(kind="audio_stub"),
    tie_embeddings=True, source="arXiv:2212.04356",
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        name="whisper-smoke", num_layers=2, d_model=128, num_heads=4,
        num_kv_heads=4, head_dim=32, d_ff=256, vocab_size=512,
        encoder=EncoderConfig(num_layers=2, num_frames=16))
