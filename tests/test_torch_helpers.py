"""Shared helpers for the PyTorch-port parity tests (no tests here).

Inputs are made with numpy from a seed and handed to both packages; results
come back as numpy and are compared in float32.  JAX stays on the CPU and
torch runs with two threads, because the suite runs under several workers.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(2)


def rng(seed: int = 0) -> np.random.Generator:
    return np.random.default_rng(seed)


def to_jax(x: np.ndarray, dtype=None):
    a = jnp.asarray(x)
    return a.astype(dtype) if dtype is not None else a


def to_torch(x: np.ndarray, dtype=None):
    t = torch.from_numpy(np.array(x))
    return t.to(dtype) if dtype is not None else t


def np32(x) -> np.ndarray:
    """Any jax array or torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def jax_tree_np(tree):
    """A jax pytree with numpy leaves (dtypes kept)."""
    return jax.tree.map(np.asarray, tree)
