"""Port `FlatLayout` against the reference's: the same numpy tree gives the
same slots, sizes, pads and dtypes; flatten/unflatten round-trips exactly
and unflatten returns views."""

import ml_dtypes
import numpy as np
import pytest
import torch

import test_torch_helpers  # noqa: F401  (thread cap)

from repro.distributed.flatbuf import FlatLayout as JLayout
from repro_torch.distributed.flatbuf import FlatLayout, default_bucket_bytes
from repro_torch.tree import tree_leaves, tree_map

BF16 = ml_dtypes.bfloat16


def _tree(seed=0):
    """Mixed f32/bf16, nested dicts and lists, size-0 and scalar leaves, and
    one leaf larger than a small bucket."""
    r = np.random.default_rng(seed)
    a = lambda *s, dt=np.float32: r.standard_normal(s).astype(dt)
    return {
        "zeta": {"w": a(40, 3), "empty": a(0, 5)},
        "alpha": [a(7), a(3, 3, dt=BF16), {"s": np.float32(2.5)}],
        "big": a(300, 10),
        "mid": {"b": a(33, dt=BF16), "a": a(64, 2), "none": None},
        "empty_bf16": a(0, dt=BF16),
    }


def _torch_tree(tree):
    def conv(x):
        x = np.asarray(x)
        if x.dtype == BF16:
            return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(x.copy())
    return tree_map(conv, tree)


def _bits(x):
    if x.numel() == 0:
        return torch.zeros(0, dtype=torch.uint8)
    return x.reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("bucket_bytes", [64, 256, 1024, 1 << 20])
@pytest.mark.parametrize("shard_divisor", [1, 2, 3])
def test_layout_matches_reference(bucket_bytes, shard_divisor):
    tree = _tree()
    want = JLayout.from_tree(tree, bucket_bytes=bucket_bytes,
                             shard_divisor=shard_divisor)
    got = FlatLayout.from_tree(tree, bucket_bytes=bucket_bytes,
                               shard_divisor=shard_divisor)
    assert [tuple(vars(s).values()) for s in got.slots] == \
        [tuple(vars(s).values()) for s in want.slots]
    assert got.buffer_sizes == want.buffer_sizes
    assert got.buffer_pads == want.buffer_pads
    assert [str(d).removeprefix("torch.") for d in got.buffer_dtypes] == \
        [str(d) for d in want.buffer_dtypes]
    assert got.num_buffers == want.num_buffers
    assert got.total_size == want.total_size


def test_layout_of_converted_model_params():
    """A converted smoke model's parameters (the port's per-layer tree, in
    its own leaf order) pack into a layout as large as the reference's and
    unflatten back to the same tensors."""
    import jax
    from repro.configs import get_smoke_config
    from repro.models import build_model
    from repro_torch.models.convert import params_from_jax
    cfg = get_smoke_config("tinyllama-1.1b")
    jp = jax.tree.map(np.asarray, build_model(cfg).init(jax.random.PRNGKey(0)))
    tp = params_from_jax(jp, cfg)
    lay = FlatLayout.from_tree(tp, bucket_bytes=64 << 10)
    assert lay.total_size == sum(x.size for x in jax.tree.leaves(jp))
    assert lay.total_size == JLayout.from_tree(jp, bucket_bytes=64 << 10).total_size
    bufs = lay.flatten(tp)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(lay.unflatten(bufs)), tree_leaves(tp)))


@pytest.mark.parametrize("shard_divisor", [1, 2])
def test_flatten_unflatten_round_trip_is_exact_and_views(shard_divisor):
    tt = _torch_tree(_tree(1))
    lay = FlatLayout.from_tree(tt, bucket_bytes=256, shard_divisor=shard_divisor)
    bufs = lay.flatten(tt)
    assert [b.numel() for b in bufs] == list(lay.buffer_sizes)
    assert [b.dtype for b in bufs] == list(lay.buffer_dtypes)
    for b, pad in zip(bufs, lay.buffer_pads):
        if pad:
            assert torch.count_nonzero(b[-pad:]) == 0
    back = lay.unflatten(bufs)
    for x, y in zip(tree_leaves(back), tree_leaves(tt)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))
    # unflatten returns views: a write through a view lands in the buffer
    leaf = back["big"]
    leaf.add_(1.0)
    assert torch.equal(lay.unflatten(bufs)["big"], tt["big"] + 1.0)
    # the same slots pack f32 cotangents of bf16 leaves
    ct = tree_map(lambda x: torch.ones(x.shape, dtype=torch.float32), tt)
    with pytest.raises(ValueError, match="mixes dtypes"):
        lay.flatten(tree_map(lambda x: torch.ones(x.shape, dtype=torch.float32)
                             if x.dtype == torch.bfloat16 and x.numel() == 9
                             else x, tt))
    packed = lay.pack_cotangents(ct)
    assert all(b.dtype == torch.float32 for b in packed)
    assert [b.numel() for b in packed] == list(lay.buffer_sizes)
    zs = lay.zeros()
    assert [z.numel() for z in zs] == list(lay.buffer_sizes)


def test_layout_errors_and_defaults():
    tt = _torch_tree(_tree(2))
    lay = FlatLayout.from_tree(tt, bucket_bytes=256)
    with pytest.raises(ValueError, match="layout expects"):
        lay.unflatten(lay.flatten(tt)[:-1])
    with pytest.raises(ValueError, match="shard_divisor"):
        FlatLayout.from_tree(tt, shard_divisor=0)
    assert default_bucket_bytes("cuda") == 4 << 20
    assert default_bucket_bytes("cpu") == 128 << 10
    assert FlatLayout.from_tree(tt).bucket_bytes == 128 << 10
    assert FlatLayout.from_tree(tt, device="cuda").bucket_bytes == 4 << 20
    assert lay == FlatLayout.from_tree(tt, bucket_bytes=256)
    assert hash(lay) == hash(FlatLayout.from_tree(tt, bucket_bytes=256))


@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
@pytest.mark.parametrize("shard_divisor", [1, 16])
def test_adamw_update_flat_matches_reference(grad_clip, shard_divisor):
    """`adamw_update_flat` (a params tree and a gradient tree over flat
    buffers) against the reference's from the same numpy inputs: params,
    moments, the norm and Σg² to 1e-6; the pads of the moments stay zero;
    the input params are left as they were."""
    import jax
    import jax.numpy as jnp
    from repro.optim import adamw as jadamw
    from repro_torch.optim import adamw as tadamw

    r = np.random.default_rng(int(10 * grad_clip) + shard_divisor)
    a = lambda *s, dt=np.float32: r.standard_normal(s).astype(dt)
    params = {"w1": a(64, 33), "b": a(65), "w2": a(200, 3), "h": a(9, dt=BF16)}
    grads = {k: 0.02 * a(*v.shape) + 0.1 for k, v in params.items()}
    moments = {k: 0.05 * a(*v.shape) for k, v in params.items()}
    jp, jg = jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads)
    jm = jax.tree.map(jnp.asarray, moments)
    jst = {"m": jm, "v": jax.tree.map(jnp.abs, jm), "count": jnp.asarray(5, jnp.int32)}
    jlayout = JLayout.from_tree(params, shard_divisor=shard_divisor)
    want = jadamw.adamw_update_flat(
        jp, jg, jadamw.flat_opt_state(jp, jst, shard_divisor=shard_divisor),
        jadamw.AdamWConfig(grad_clip=grad_clip), 1e-3, layout=jlayout)

    tp, tg, tm = _torch_tree(params), _torch_tree(grads), _torch_tree(moments)
    before = {k: v.clone() for k, v in tp.items()}
    tst = {"m": tm, "v": tree_map(torch.abs, tm), "count": torch.tensor(5, dtype=torch.int32)}
    layout = FlatLayout.from_tree(tp, shard_divisor=shard_divisor)
    got = tadamw.adamw_update_flat(
        tp, tg, tadamw.flat_opt_state(tp, tst, shard_divisor=shard_divisor),
        tadamw.AdamWConfig(grad_clip=grad_clip), torch.tensor(1e-3), layout=layout)
    for k in params:
        np.testing.assert_allclose(got[0][k].float().numpy(),
                                   np.asarray(want[0][k], np.float32), rtol=1e-6, atol=1e-7)
        assert torch.equal(tp[k], before[k])
    for mv in ("m", "v"):
        for g, w, pad, size in zip(got[1][mv], want[1][mv], layout.buffer_pads,
                                   layout.buffer_sizes):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-9)
            assert not pad or bool((g[size - pad:] == 0).all())
    assert int(got[1]["count"]) == int(want[1]["count"]) == 6
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
