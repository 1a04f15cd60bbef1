"""PyTorch + CUDA port of the adaptive batch-size reproduction (`repro`).

Module paths mirror `src/repro/`; each module names its reference
counterpart.  The package imports `torch` and numpy, never `jax` and
nothing of `repro`.
"""
