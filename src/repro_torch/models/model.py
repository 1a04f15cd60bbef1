"""Public model API: a thin functional wrapper around the transformer stack
(counterpart of `repro/models/model.py`)."""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.common import count_params


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, seed: int = 0, device=None) -> dict:
        """Random parameters on `device` (default: the CUDA card; raises
        when there is none)."""
        return tfm.init_params(self.cfg, seed=seed, device=device)

    def loss(self, params, batch):
        return tfm.loss_fn(params, batch, self.cfg)

    def logits(self, params, batch):
        """Logits of the text positions (a vision prefix's are dropped)."""
        hidden, _, offset = tfm.forward(params, batch, self.cfg)
        return tfm._logits(params, hidden[:, offset:], self.cfg)

    def prefill(self, params, batch):
        return tfm.prefill(params, batch, self.cfg)

    def init_cache(self, batch: int, cache_len: int, ring: bool = False,
                   device=None):
        return tfm.init_decode_cache(self.cfg, batch, cache_len, ring=ring,
                                     device=device)

    def decode_step(self, params, cache, tokens, pos, ring: bool = False,
                    seq_shards=None):
        return tfm.decode_step(params, cache, tokens, pos, self.cfg, ring=ring,
                               seq_shards=seq_shards)

    def num_params(self, params=None) -> int:
        if params is not None:
            return count_params(params)
        return self.cfg.param_count()


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
