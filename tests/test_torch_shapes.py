"""The port's input shapes for the dry-run (`repro_torch/configs/shapes.py`)
held against the reference's (`repro/configs/shapes.py`): the shape table,
the assigned architectures, every (assigned arch × input shape)'s specs —
tokens, labels, the stub front ends' inputs and every decode-cache leaf,
meta tensors against `jax.ShapeDtypeStruct`s, exactly — and the full
models' element counts, meta tensors against `jax.eval_shape`.  Nothing is
allocated on either side."""

import dataclasses

import numpy as np
import pytest

import jax

from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED
from repro.configs import PAPER_ARCHS as J_PAPER
from repro.configs import get_config as jget_config
from repro.configs.shapes import INPUT_SHAPES as J_SHAPES
from repro.configs.shapes import input_specs as jinput_specs
from repro.models import build_model as jbuild
from repro_torch.configs import ASSIGNED_ARCHS, PAPER_ARCHS, get_config
from repro_torch.configs.shapes import INPUT_SHAPES, input_specs
from repro_torch.models.model import build_model
from repro_torch.tree import tree_leaves


def _bf16(cfg):
    return cfg.replace(dtype="bfloat16", param_dtype="bfloat16")


def _sig(x):
    """(shape, dtype name) of a meta tensor or a ShapeDtypeStruct."""
    dtype = x.dtype
    name = str(dtype).removeprefix("torch.") if not hasattr(dtype, "name") \
        else np.dtype(dtype).name
    return tuple(x.shape), name


def _ref_cache_layers(cache, cfg):
    """The reference's decode cache ({"prefix", "scanned"} and the cross
    groups) as the port lays it out: one dict a layer, prefix layers then
    the scanned repeats, a layer's cross k / v as "cross_k" / "cross_v"."""
    def layers(prefix, scanned):
        out = [{k: _sig(v) for k, v in c.items()} for c in prefix]
        for r in range(cfg.num_repeats):
            for sub in scanned:
                out.append({k: (tuple(v.shape[1:]), _sig(v)[1])
                            for k, v in sub.items()})
        return out

    own = layers(cache.get("prefix", []), cache["scanned"])
    if "cross_scanned" in cache:
        cross = layers(cache.get("cross_prefix", []), cache["cross_scanned"])
        own = [dict(c, cross_k=x["k"], cross_v=x["v"]) for c, x in zip(own, cross)]
    return own


def test_shape_table_and_assigned_archs_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}
    assert list(INPUT_SHAPES) == list(J_SHAPES)
    assert ASSIGNED_ARCHS == J_ASSIGNED and len(ASSIGNED_ARCHS) == 10
    assert PAPER_ARCHS == J_PAPER


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
def test_input_specs_equal_the_reference(arch, shape):
    cfg, jcfg = _bf16(get_config(arch)), _bf16(jget_config(arch))
    got, want = input_specs(cfg, shape), jinput_specs(jcfg, shape)
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "cache":
            layers = got["cache"]
            assert all(x.device.type == "meta" for x in tree_leaves(layers))
            assert [{n: _sig(x) for n, x in c.items()} for c in layers] == \
                _ref_cache_layers(v, jcfg)
        elif k == "ring":
            assert got["ring"] is v
        else:
            assert got[k].device.type == "meta"
            assert _sig(got[k]) == _sig(v), k
    sh = INPUT_SHAPES[shape]
    if shape == "long_500k" and not cfg.native_subquadratic:
        # the ring serving mode: attention caches bounded by the window
        max_seq = max(x.shape[-3] for x in tree_leaves(got["cache"]) if x.dim() >= 3)
        assert max_seq <= max(cfg.long_context_window, 4096 + 1) < sh.seq_len


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_meta_init_counts_the_references_elements(arch):
    """`model.init(device="meta")` at full size: exactly the elements of
    the reference's `jax.eval_shape(model.init)`, and no storage."""
    cfg = get_config(arch).replace(param_dtype="bfloat16")
    leaves = tree_leaves(build_model(cfg).init(device="meta"))
    assert all(x.device.type == "meta" for x in leaves)
    jtree = jax.eval_shape(jbuild(jget_config(arch).replace(param_dtype="bfloat16")).init,
                           jax.random.PRNGKey(0))
    assert sum(x.numel() for x in leaves) == \
        sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jtree))
