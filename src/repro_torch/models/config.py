"""Model configuration covering every assigned architecture family.

Counterpart of `repro/models/config.py`; the only change is that
`act_dtype` / `p_dtype` are `torch` dtypes.

One `ModelConfig` describes dense, MoE, SSM, hybrid (RG-LRU), encoder–decoder
(audio) and VLM backbones.  Per-layer heterogeneity (gemma2 local/global
alternation, recurrentgemma 2:1 recurrent:attention) is expressed with
`block_pattern`: the stack is `num_layers / len(block_pattern)` repeats of the
pattern, scanned over repeats for O(1) trace size.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

# Layer kinds usable in block_pattern.
ATTN = "attn"            # full/causal GQA attention
LOCAL_ATTN = "local"     # sliding-window GQA attention
MLA_ATTN = "mla"         # DeepSeek-V2 multi-head latent attention
RGLRU = "rglru"          # RecurrentGemma recurrent block
SSD = "ssd"              # Mamba-2 state-space duality block

LAYER_KINDS = (ATTN, LOCAL_ATTN, MLA_ATTN, RGLRU, SSD)


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int              # routed experts held here
    top_k: int
    d_expert: int                 # ffn width of each routed expert
    num_shared_experts: int = 0
    shared_d_expert: int = 0
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25
    # Which layers are MoE: every layer by default; first_dense skips layer 0
    # (DeepSeek-V2 keeps layer 0 dense).
    first_dense: int = 0
    # The router's width, the published expert count (0 => num_experts),
    # and the first of them held here: experts [first_expert,
    # first_expert + num_experts), one expert-parallel rank's share.
    router_experts: int = 0
    first_expert: int = 0
    # Group-limited greedy routing (DeepSeek-V2): the experts fall into
    # n_group equal groups; a token picks its top_k among the topk_group
    # groups of highest maximum score.  n_group 1 is plain top-k.
    n_group: int = 1
    topk_group: int = 1
    routed_scaling_factor: float = 1.0  # multiplies every gate
    norm_topk_prob: bool = True   # gates divided by their sum before scaling
    # DeepSeek-V2's device- and communication-level balance losses over the
    # n_group groups, a group standing for a device (arXiv:2405.04434
    # §2.2.3; 0 => left out)
    device_aux_coef: float = 0.0
    comm_aux_coef: float = 0.0

    @property
    def num_routed(self) -> int:
        """The router's width: every expert a token can be sent to."""
        return self.router_experts or self.num_experts


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 => no q compression
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0            # 0 => d_model
    conv_width: int = 4
    c_constant: float = 8.0       # the fixed `c` in a = exp(-c*softplus(Λ)*r)


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for encoder-decoder (audio) models."""

    num_layers: int = 6
    num_frames: int = 1500        # stub frontend output length
    # encoder reuses d_model/num_heads/d_ff of the main config


@dataclass(frozen=True)
class FrontendConfig:
    """Stubbed modality frontend: input_specs() provides embeddings directly."""

    kind: str = "none"            # none | audio_stub | vision_stub
    num_prefix_tokens: int = 0    # VLM: patch tokens prepended to text


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 => d_model // num_heads

    block_pattern: tuple[str, ...] = (ATTN,)
    # unscanned layers before the scanned repeats; used for heterogeneous
    # prefixes (DeepSeek-V2 dense layer 0, RecurrentGemma's 38 = 2 + 12*3).
    # Prefix layers are always dense (never MoE).
    prefix_pattern: tuple[str, ...] = ()
    pos_embed: str = "rope"       # rope | sinusoidal | none
    mlp_kind: str = "swiglu"      # swiglu | geglu | gelu | relu2 | none
    norm_kind: str = "rmsnorm"    # rmsnorm | layernorm
    post_attn_norm: bool = False  # gemma2-style extra norms
    tie_embeddings: bool = True

    rope_theta: float = 10000.0
    sliding_window: int = 4096
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    scale_embed: bool = False     # gemma: embed * sqrt(d_model)
    qk_norm: bool = False

    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encoder: Optional[EncoderConfig] = None
    frontend: FrontendConfig = FrontendConfig()

    # structure: scan over layer repeats (O(1) trace) or python-unroll
    # (O(L) trace; required for faithful HLO cost analysis — XLA counts a
    # while-loop body once, so the dry-run unrolls).
    scan_layers: bool = True

    # numerics
    dtype: str = "float32"        # activation dtype
    param_dtype: str = "float32"
    remat: str = "none"           # none | full
    xent_chunk: int = 0           # 0 => unchunked cross-entropy

    # serving
    long_context_window: int = 4096   # sliding-window serving mode for long_500k
    native_subquadratic: bool = False # SSM/hybrid: long_500k without windowing

    # citation for the config (source paper / model card)
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        scanned = self.num_layers - len(self.prefix_pattern)
        assert scanned % len(self.block_pattern) == 0, (
            f"{self.name}: {scanned} scanned layers not divisible by "
            f"pattern length {len(self.block_pattern)}"
        )
        for kind in self.block_pattern + self.prefix_pattern:
            assert kind in LAYER_KINDS, kind

    @property
    def num_repeats(self) -> int:
        return (self.num_layers - len(self.prefix_pattern)) // len(self.block_pattern)

    @property
    def act_dtype(self) -> torch.dtype:
        return _torch_dtype(self.dtype)

    @property
    def p_dtype(self) -> torch.dtype:
        return _torch_dtype(self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---- parameter counting (for roofline MODEL_FLOPS = 6*N*D) ----
    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count; active_only counts MoE top-k experts."""
        d = self.d_model
        layers = [(k, False) for k in self.prefix_pattern]
        layers += [(k, self.moe is not None) for k in self.block_pattern] * self.num_repeats
        n = self.vocab_size * d            # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d
        n += sum(self._layer_params(k, m, active_only) for k, m in layers)
        n += d                             # final norm
        if self.encoder is not None:
            enc_layer = self._layer_params(ATTN, False, active_only) \
                - (d * self.num_heads * self.head_dim
                   + 2 * d * self.num_kv_heads * self.head_dim
                   + self.num_heads * self.head_dim * d + d)  # no cross-attn in encoder
            n += self.encoder.num_layers * enc_layer + d
        return int(n)

    def _layer_params(self, kind: str, moe_layer: bool, active_only: bool) -> int:
        d = self.d_model
        p = 2 * d
        if kind in (ATTN, LOCAL_ATTN):
            q = self.num_heads * self.head_dim
            kv = self.num_kv_heads * self.head_dim
            p += d * q + 2 * d * kv + q * d
        elif kind == MLA_ATTN:
            m = self.mla
            qd = self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            if m.q_lora_rank:
                p += d * m.q_lora_rank + m.q_lora_rank * qd
            else:
                p += d * qd
            p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            p += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
            p += self.num_heads * m.v_head_dim * d
        elif kind == RGLRU:
            w = self.rglru.lru_width or d
            p += 2 * d * w + w * d + 2 * w * w + 3 * w + self.rglru.conv_width * w
        elif kind == SSD:
            s = self.ssm
            di = s.d_inner(d)
            nh = s.num_heads(d)
            p += d * (2 * di + 2 * s.state_dim + nh) + di * d
            p += s.conv_width * (di + 2 * s.state_dim)
        if kind != SSD and self.mlp_kind != "none":
            p += self._mlp_params(active_only, moe_layer)
        if self.encoder is not None:
            q = self.num_heads * self.head_dim
            kv = self.num_kv_heads * self.head_dim
            p += d * q + 2 * d * kv + q * d + d
        return p

    def _mlp_params(self, active_only: bool, moe_layer: bool = True) -> int:
        d = self.d_model
        if self.moe is not None and moe_layer:
            m = self.moe
            n_routed = m.top_k if active_only else m.num_experts
            per_expert = 3 * d * m.d_expert if self.mlp_kind in ("swiglu", "geglu") else 2 * d * m.d_expert
            n = n_routed * per_expert + d * m.num_routed  # router
            if m.num_shared_experts:
                n += m.num_shared_experts * 3 * d * m.shared_d_expert
            return n
        mult = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        return mult * d * self.d_ff
