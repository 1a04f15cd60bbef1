"""Architecture registry of the port: every config of `repro/configs`
(dense, local/global, MoE, MLA, SSM, RG-LRU hybrid, encoder-decoder and
VLM): `ASSIGNED_ARCHS` (the assigned pool, the dry-run's default set),
`PAPER_ARCHS` (the paper's experiment models) and `ALL_ARCHS`.
`get_config(name)` / `get_smoke_config(name)`; an unknown name raises
`KeyError`.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

# arch id -> module name; the first ten are the assigned architecture
# pool, in the reference's order
_REGISTRY = {
    "dbrx-132b": "dbrx_132b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "whisper-base": "whisper_base",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "internvl2-1b": "internvl2_1b",
    "gemma2-27b": "gemma2_27b",
    "nemotron-4-15b": "nemotron_4_15b",
    "mamba2-370m": "mamba2_370m",
    "llama3.2-1b": "llama3_2_1b",
    # the paper's own experiment models
    "microllama-300m": "microllama_300m",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "openllama-3b": "openllama_3b",
}

ASSIGNED_ARCHS = tuple(list(_REGISTRY)[:10])
PAPER_ARCHS = tuple(list(_REGISTRY)[10:])
ALL_ARCHS = tuple(_REGISTRY)


def _module(name: str):
    if name not in _REGISTRY:
        raise KeyError(f"arch {name!r} is not supported by the port; "
                       f"supported: {sorted(_REGISTRY)}")
    return importlib.import_module(f"repro_torch.configs.{_REGISTRY[name]}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()
