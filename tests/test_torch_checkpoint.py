"""Port checkpoint store (`repro_torch/checkpoint/store.py`) against the
cases of tests/test_checkpoint.py, and checkpoints crossing between the
packages: a checkpoint written by either restores in the other with
bit-equal arrays (tree and flat residency, bf16 bits included), and a
training run resumed across packages continues the reference's losses to
rtol 1e-5 with the controller state exactly equal.  `FlatParams`,
`flatten_tree`, `flat_opt_state` and `unflat_opt_state` give exactly the
reference's buffers, slots and pads."""

import json
import os
import shutil

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import jax_tree_np
from test_torch_model import _batch

from repro.checkpoint import store as jstore
from repro.configs import get_smoke_config as jget
from repro.distributed.flatbuf import (FlatParams as JFlatParams,
                                       flatten_tree as jflatten_tree)
from repro.launch.train import TrainJob as JJob, run_training as jrun
from repro.models import build_model as jbuild
from repro.optim.adamw import (flat_opt_state as jflat_opt,
                               init_adamw as jinit_adamw,
                               unflat_opt_state as junflat_opt)
from repro_torch.checkpoint.store import (
    CheckpointError, FLAT_PARAMS_META, flat_params_metadata, latest_step,
    restore_checkpoint, restore_params, restore_params_flat, save_checkpoint)
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.flatbuf import FlatParams, flatten_tree
from repro_torch.launch.train import TrainJob, run_training
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import flat_opt_state, unflat_opt_state
from repro_torch.testing.faults import FaultRule, InjectedFault, inject
from repro_torch.tree import tree_leaves, tree_map

BF16 = ml_dtypes.bfloat16


def _t(x):
    return torch.from_numpy(np.array(x))


def _equal(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.dtype == np.asarray(b).dtype and np.array_equal(a, np.asarray(b))


def test_roundtrip(tmp_path):
    tree = {
        "params": {"w": torch.arange(6.0).reshape(2, 3),
                   "blocks": [{"a": torch.ones(4)}, {"a": torch.zeros(4)}]},
        "count": torch.tensor(7, dtype=torch.int32),
    }
    d = str(tmp_path)
    save_checkpoint(d, 42, tree, metadata={"note": "hi"})
    assert latest_step(d) == 42
    restored, meta = restore_checkpoint(d, 42, tree_map(torch.zeros_like, tree))
    assert meta["step"] == 42 and meta["note"] == "hi"
    for a, b in zip(tree_leaves(restored), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_of_many(tmp_path):
    d = str(tmp_path)
    for s in (1, 5, 3):
        save_checkpoint(d, s, {"x": torch.zeros(2)})
    assert latest_step(d) == 5


# ---------------------------------------- flat-resident interop (§10) ----

def _params_tree():
    r = np.random.default_rng(3)
    a = lambda *s: torch.from_numpy(r.standard_normal(s).astype(np.float32))
    return {"w": a(37, 5), "blocks": [{"a": a(23)}, {"a": a(23)}],
            "scale": torch.tensor(1.5)}


def test_flat_resident_checkpoint_restores_into_tree_job(tmp_path):
    tree = _params_tree()
    fp = FlatParams.from_tree(tree, bucket_bytes=256, shard_divisor=4)
    d = str(tmp_path)
    save_checkpoint(d, 7, {"params": fp.buffers,
                           "opt": {"count": torch.zeros((), dtype=torch.int32)}},
                    metadata={FLAT_PARAMS_META: flat_params_metadata(fp.layout)})
    restored, meta = restore_params(d, 7, tree_map(torch.zeros_like, tree))
    assert meta[FLAT_PARAMS_META] == {"bucket_bytes": 256, "shard_divisor": 4}
    for a, b in zip(tree_leaves(restored), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_flat_resident_checkpoint_restores_across_bucket_sizes(tmp_path):
    tree = _params_tree()
    writer = FlatParams.from_tree(tree, bucket_bytes=256, shard_divisor=4)
    d = str(tmp_path)
    save_checkpoint(d, 3, {"params": writer.buffers},
                    metadata={FLAT_PARAMS_META:
                              flat_params_metadata(writer.layout)})
    reader, _ = restore_params_flat(d, 3, tree_map(torch.zeros_like, tree),
                                    bucket_bytes=64, shard_divisor=2)
    assert reader.layout.bucket_bytes == 64
    assert reader.layout.shard_divisor == 2
    assert reader.layout.buffer_sizes != writer.layout.buffer_sizes
    want = FlatParams.from_tree(tree, bucket_bytes=64, shard_divisor=2)
    assert len(reader.buffers) == len(want.buffers)
    for a, b in zip(reader.buffers, want.buffers):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(tree_leaves(reader.to_tree()), tree_leaves(tree)):
        assert torch.equal(a, b)


def test_tree_checkpoint_restores_into_flat_job(tmp_path):
    tree = _params_tree()
    d = str(tmp_path)
    save_checkpoint(d, 11, {"params": tree})
    fp, meta = restore_params_flat(d, 11, tree_map(torch.zeros_like, tree),
                                   bucket_bytes=128, shard_divisor=3)
    assert FLAT_PARAMS_META not in meta
    for a, b in zip(tree_leaves(fp.to_tree()), tree_leaves(tree)):
        assert torch.equal(a, b)


# ------------------------------------------- crash atomicity (§12) ----

def test_crash_before_commit_leaves_previous_checkpoint(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, {"x": torch.arange(4.0)})
    with inject(FaultRule(site="ckpt.save.before_commit")):
        with pytest.raises(InjectedFault):
            save_checkpoint(d, 2, {"x": torch.arange(4.0) + 1})
    assert latest_step(d) == 1
    assert any(".tmp" in f for f in os.listdir(d))      # the litter
    restored, _ = restore_checkpoint(d, 1, {"x": torch.zeros(4)})
    assert torch.equal(restored["x"], torch.arange(4.0))
    save_checkpoint(d, 3, {"x": torch.arange(4.0) + 2})
    assert latest_step(d) == 3
    assert not any(".tmp" in f for f in os.listdir(d))  # litter cleaned


def test_lone_json_is_not_a_checkpoint(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 4, {"x": torch.zeros(2)})
    (tmp_path / "ckpt_00000009.json").write_text("{}")
    assert latest_step(d) == 4


def test_truncated_npz_raises_typed_error(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 6, {"x": torch.arange(128.0)})
    with inject(FaultRule(site="ckpt.saved", action="truncate",
                          keep_bytes=40)):
        save_checkpoint(d, 7, {"x": torch.arange(128.0)})
    assert latest_step(d) == 7       # pair exists; the tear is inside the npz
    with pytest.raises(CheckpointError, match="truncated or corrupt"):
        restore_checkpoint(d, 7, {"x": torch.zeros(128)})
    restore_checkpoint(d, 6, {"x": torch.zeros(128)})     # older pair intact


def test_missing_and_mismatched_entries_are_loud(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, {"x": torch.zeros(3)})
    with pytest.raises(CheckpointError, match="does not exist"):
        restore_checkpoint(d, 99, {"x": torch.zeros(3)})
    with pytest.raises(CheckpointError, match="no entry"):
        restore_checkpoint(d, 1, {"y": torch.zeros(3)})
    with pytest.raises(CheckpointError, match="shape"):
        restore_checkpoint(d, 1, {"x": torch.zeros(4)})


# ------------------------------------------------ across the packages ----

def _np_state(seed=0):
    """A training-state-shaped numpy tree: f32 params, f32 moments, an
    int32 count."""
    r = np.random.default_rng(seed)
    p = {"embed": {"table": r.standard_normal((11, 4)).astype(np.float32)},
         "blocks": [{"w": r.standard_normal((3, 4, 4)).astype(np.float32)}],
         "final_norm": {"scale": r.standard_normal(4).astype(np.float32)}}
    m = jax.tree.map(lambda x: r.standard_normal(x.shape).astype(np.float32), p)
    return {"params": p, "opt": {"m": m, "v": jax.tree.map(np.abs, m),
                                 "count": np.int32(5)}}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tree_checkpoint_crosses_packages(tmp_path, writer):
    state = _np_state()
    d = str(tmp_path)
    if writer == "jax":
        jstore.save_checkpoint(d, 3, jax.tree.map(jnp.asarray, state),
                               metadata={"note": "x"})
        got, meta = restore_checkpoint(d, 3, state)
        pairs = zip(jax.tree.leaves(got), jax.tree.leaves(state))
    else:
        save_checkpoint(d, 3, tree_map(_t, state), metadata={"note": "x"})
        got, meta = jstore.restore_checkpoint(d, 3, state)
        pairs = zip(jax.tree.leaves(got), jax.tree.leaves(state))
    assert meta == {"step": 3, "note": "x"}
    for a, b in pairs:
        assert _equal(a, b)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_flat_checkpoint_crosses_packages(tmp_path, writer):
    """Flat-resident params (buffers + layout recipe) written by one package
    come back bit-exact in the other, as a tree and re-packed at another
    bucket size."""
    tree = _np_state()["params"]
    d = str(tmp_path)
    if writer == "jax":
        fp = JFlatParams.from_tree(jax.tree.map(jnp.asarray, tree),
                                   bucket_bytes=64, shard_divisor=2)
        jstore.save_checkpoint(d, 2, {"params": fp.buffers}, metadata={
            jstore.FLAT_PARAMS_META: jstore.flat_params_metadata(fp.layout)})
        got, _ = restore_params(d, 2, tree)
        flat, _ = restore_params_flat(d, 2, tree, bucket_bytes=128)
        want = JFlatParams.from_tree(jax.tree.map(jnp.asarray, tree),
                                     bucket_bytes=128)
    else:
        fp = FlatParams.from_tree(tree_map(_t, tree), bucket_bytes=64,
                                  shard_divisor=2)
        save_checkpoint(d, 2, {"params": fp.buffers}, metadata={
            FLAT_PARAMS_META: flat_params_metadata(fp.layout)})
        got, _ = jstore.restore_params(d, 2, tree)
        flat, _ = jstore.restore_params_flat(d, 2, tree, bucket_bytes=128)
        want = FlatParams.from_tree(tree_map(_t, tree), bucket_bytes=128)
    for a, b in zip(jax.tree.leaves(got) if writer == "port" else tree_leaves(got),
                    jax.tree.leaves(tree)):
        assert _equal(a, b)
    assert len(flat.buffers) == len(want.buffers)
    for a, b in zip(flat.buffers, want.buffers):
        assert _equal(a, b if writer == "port" else np.asarray(b))


def test_bf16_bits_cross_packages_or_raise(tmp_path):
    """A bf16 leaf is written as the reference writes it (its raw 2-byte
    bits) and restores bit-exactly as bf16; into any other dtype it is a
    CheckpointError naming the dtype."""
    x = np.random.default_rng(1).standard_normal(9).astype(BF16)
    bits = x.view(np.uint16)
    jstore.save_checkpoint(str(tmp_path / "j"), 1, {"x": jnp.asarray(x)})
    save_checkpoint(str(tmp_path / "t"), 1,
                    {"x": torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)})
    for sub in ("j", "t"):
        raw = np.load(tmp_path / sub / "ckpt_00000001.npz")["x"]
        assert raw.dtype == np.dtype("V2") and np.array_equal(raw.view(np.uint16), bits)
        got, _ = restore_checkpoint(str(tmp_path / sub), 1,
                                    {"x": torch.zeros(9, dtype=torch.bfloat16)})
        assert np.array_equal(got["x"].view(torch.int16).numpy().view(np.uint16), bits)
        with pytest.raises(CheckpointError, match="bfloat16"):
            restore_checkpoint(str(tmp_path / sub), 1, {"x": torch.zeros(9)})


@pytest.mark.parametrize("bucket_bytes,shard_divisor", [(64, 1), (256, 3)])
def test_flat_helpers_match_reference(bucket_bytes, shard_divisor):
    """FlatParams, flatten_tree, flat_opt_state and unflat_opt_state: the
    same buffers (bit for bit), slots and pads as the reference's."""
    state = _np_state(2)
    jtree = jax.tree.map(jnp.asarray, state)
    ttree = tree_map(_t, state)
    jl, jb = jflatten_tree(jtree["params"], bucket_bytes, shard_divisor)
    tl, tb = flatten_tree(ttree["params"], bucket_bytes, shard_divisor)
    assert [tuple(vars(s).values()) for s in tl.slots] == \
        [tuple(vars(s).values()) for s in jl.slots]
    assert tl.buffer_pads == jl.buffer_pads
    jfp = JFlatParams.from_tree(jtree["params"], bucket_bytes, shard_divisor)
    tfp = FlatParams.from_tree(ttree["params"], bucket_bytes, shard_divisor)
    for a, b, c, e in zip(tb, jb, tfp.buffers, jfp.buffers):
        assert _equal(a, b) and _equal(c, e)
    for a, b in zip(tree_leaves(tfp.to_tree()), jax.tree.leaves(jfp.to_tree())):
        assert _equal(a, b)
    kw = dict(shard_divisor=shard_divisor)
    jo = jflat_opt(jtree["params"], jtree["opt"], layout=jl, **kw)
    to = flat_opt_state(ttree["params"], ttree["opt"], layout=tl, **kw)
    for k in ("m", "v"):
        for a, b in zip(to[k], jo[k]):
            assert _equal(a, b)
    back_j = junflat_opt(jtree["params"], jo, layout=jl, **kw)
    back_t = unflat_opt_state(ttree["params"], to, layout=tl, **kw)
    for a, b in zip(tree_leaves(back_t), jax.tree.leaves(back_j)):
        assert _equal(a, b)
    assert int(back_t["count"]) == 5


def test_model_checkpoint_crosses_packages_next_loss(tmp_path):
    """The reference's smoke-model params, saved by the reference and
    restored by the port (and back), are bit-equal and give the same
    next loss on a batch (rtol 1e-5)."""
    _model_checkpoint_crosses(tmp_path, "llama3.2-1b")


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b",
                                  "whisper-base", "internvl2-1b"])
def test_remaining_archs_checkpoint_crosses_packages(tmp_path, arch):
    """The same for the SSD, RG-LRU (recurrentgemma's `prefix_blocks`
    layer: its smoke config's pattern with one RG-LRU prefix layer),
    encoder-decoder (the `encoder` subtree, `cross_attn`, `cross_norm`) and
    vision-prefix configs; the next loss on a batch with the config's
    frames or patch embeddings."""
    kw = dict(prefix_pattern=("rglru",), num_layers=4) \
        if arch == "recurrentgemma-9b" else {}
    _model_checkpoint_crosses(tmp_path, arch, **kw)


def _model_checkpoint_crosses(tmp_path, arch, **cfg_kw):
    cfg = jget(arch).replace(**cfg_kw)
    jmodel = jbuild(cfg)
    jp = jmodel.init(jax.random.PRNGKey(4))
    like = jax_tree_np(jp)
    jstore.save_checkpoint(str(tmp_path / "j"), 1,
                           {"params": jp, "opt": jinit_adamw(jp)})
    got, _ = restore_checkpoint(str(tmp_path / "j"), 1,
                                {"params": like, "opt": jax_tree_np(jinit_adamw(jp))})
    for a, b in zip(jax.tree.leaves(got["params"]), jax.tree.leaves(like)):
        assert _equal(a, b)
    save_checkpoint(str(tmp_path / "t"), 1, {"params": got["params"]})
    back, _ = jstore.restore_checkpoint(str(tmp_path / "t"), 1, {"params": like})
    for a, b in zip(jax.tree.leaves(back["params"]), jax.tree.leaves(like)):
        assert _equal(a, b)
    tcfg = get_smoke_config(arch).replace(**cfg_kw)
    tparams = params_from_jax(jax.tree.map(lambda t: t.numpy(), got["params"]), tcfg)
    batch = _batch(cfg, 2, 16, seed=0)
    want = float(jmodel.loss(jax.tree.map(jnp.asarray, back["params"]),
                             jax.tree.map(jnp.asarray, batch))[0])
    with torch.no_grad():
        loss = float(build_model(tcfg).loss(tparams, tree_map(_t, batch))[0])
    np.testing.assert_allclose(loss, want, rtol=1e-5)


RESUME = dict(arch="llama3.2-1b", schedule="adaptive", steps=3,
              total_samples=100_000, seq_len=16, base_global_batch=4,
              max_global_batch=8, base_micro_batch=2, max_micro_batch=2,
              base_accum=2, eta=0.12, step_impl="accum_norm", eval_every=3,
              eval_batches=1)


@pytest.mark.parametrize("impl", ["tree", "flat"])
def test_training_resumes_across_packages(tmp_path, impl):
    """A run checkpointed by one package at step 2 resumes in the other:
    the resumed step's loss and validation loss agree with the writer's
    own resume to rtol 1e-5, the batch trajectory and the final
    controller state exactly."""
    _resume_across(tmp_path, dict(RESUME, stats_impl=impl, params_impl=impl))


def test_deepseek_training_resumes_across_packages(tmp_path):
    """The same on the deepseek-v2 smoke config (a dense MLA prefix layer,
    then MLA + MoE: 3-D expert leaves and a shared expert in the
    checkpoint, the aux loss in every step's loss), flat residency."""
    _resume_across(tmp_path, dict(RESUME, arch="deepseek-v2-236b",
                                  stats_impl="flat", params_impl="flat"))


def _resume_across(tmp_path, kw):
    runs = {"jax": lambda **o: jrun(JJob(**{**kw, **o})),
            "port": lambda **o: run_training(TrainJob(device="cpu", **{**kw, **o}))}
    for writer, reader in (("jax", "port"), ("port", "jax")):
        a, b = str(tmp_path / writer / "a"), str(tmp_path / writer / "b")
        runs[writer](steps=2, checkpoint_dir=a)
        shutil.copytree(a, b)
        own = runs[writer](checkpoint_dir=a, resume=True)
        other = runs[reader](checkpoint_dir=b, resume=True)
        assert own["resumed_from"] == other["resumed_from"] == 2
        assert other["global_batch"] == own["global_batch"]
        np.testing.assert_allclose(other["loss"], own["loss"], rtol=1e-5)
        np.testing.assert_allclose(other["val_loss"], own["val_loss"], rtol=1e-5)
        ctrl = [json.load(open(os.path.join(d, "ckpt_00000003.json")))["controller"]
                for d in (a, b)]
        assert ctrl[0] == ctrl[1]
