"""The port's mesh, specs and rules against the reference's, and both steps
on a data × model grid of gloo ranks on the CPU against the reference on
4 forced host devices.

* `param_pspecs` (fsdp False and True) and `cache_pspecs` equal the
  reference's exactly for all 13 configs at published size, on (16, 16),
  (2, 16, 16), (4, 2) and (2, 2): the reference's functions read a
  stand-in mesh (`shape`, `axis_names`) over `jax.eval_shape` trees, the
  port's its own `Mesh` over meta tensors.  A port layer leaf takes the
  reference's `prefix_blocks` spec, i.e. its stacked `blocks` spec without
  the leading None; cross caches map to the reference's cross groups.
* `ShardingRules` and its helpers equal the reference's.
* A 2 × 2 mesh of spawned ranks: coordinates row-major over (data, model),
  the data and model groups, `shard_tree` / `gather_tree`.
* FSDP-Norm on 2 × 2 (smoke llama3.2-1b and microllama-300m, tree/tree and
  flat/flat, 3 steps) and ACCUM-NORM at J = 2 and on 2 × 2 (llama3.2-1b,
  both residencies) against the reference: metrics at rtol 1e-5 / atol
  1e-7, parameters by the per-entry-share rule of
  tests/test_torch_fsdp_norm.py (every entry to 1e-4; all but 0.05 % after
  step 1 and 2.5 % after step 3 to rtol 1e-5 / atol 1e-7).  Unpadded
  batches (ROADMAP §3)."""

import itertools

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from conftest import run_subprocess
from test_torch_helpers import jax_tree_np

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget
from repro.distributed import params as jparams
from repro.distributed import sharding as jsharding
from repro.models import build_model as jbuild
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.core.schedule import BatchPlan
from repro_torch.data.pipeline import MarkovTokens, make_batch
from repro_torch.distributed import params as tparams
from repro_torch.distributed import sharding as tsharding
from repro_torch.distributed.sharding import gather_flat_buffers, shard_flat_buffers
from repro_torch.distributed.train_step import (
    batch_to_device, make_accum_norm_step, make_fsdp_norm_step)
from repro_torch.launch import mesh as tmesh
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig, init_adamw, init_adamw_flat
from repro_torch.tree import tree_leaves, tree_map

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
TIMEOUT_S = 300


class _StandIn:
    """What the reference's spec functions read of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


def _ref_specs(tree):
    """{path key: spec tuple} of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, P))[0]
    return {jparams._path_key(p): tuple(s) for p, s in flat}


def _layer_keys(cfg):
    """The reference key prefix of each port layer, and whether it is
    stacked (a leading repeat axis)."""
    npre, pat = len(cfg.prefix_pattern), len(cfg.block_pattern)
    return [(f"prefix_blocks/{i}", False) if i < npre
            else (f"blocks/{(i - npre) % pat}", True)
            for i in range(npre + pat * cfg.num_repeats)]


def _compare(port_specs, ref, cfg, cache=False):
    """Every port spec against the reference spec of the same leaf."""
    layers = _layer_keys(cfg)
    n = 0
    for key, spec in tparams.spec_paths(port_specs):
        parts = key.split("/")
        if cache:
            i, name = int(parts[0]), parts[-1]
            group, stacked = layers[i]
            scan = "scanned" if stacked else "prefix"
            if name.startswith("cross_"):
                group = ("cross_" + scan + "/" + group.split("/")[1])
                name = name.removeprefix("cross_")
            else:
                group = scan + "/" + group.split("/")[1]
            rkey = f"{group}/{name}"
        elif parts[0] == "layers":
            group, stacked = layers[int(parts[1])]
            rkey = "/".join([group] + parts[2:])
        else:
            rkey, stacked = key, False
        want = ref[rkey][1:] if stacked else ref[rkey]
        assert spec == want, (cfg.name, key, rkey, spec, want)
        n += 1
    return n


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_and_cache_pspecs_match_reference(mesh_name):
    shape, axes = MESHES[mesh_name]
    ref_mesh, mesh = _StandIn(shape, axes), tmesh.Mesh(shape, axes)
    for arch in ALL_ARCHS:
        cfg, jcfg = get_config(arch), jget_config(arch)
        jmodel, model = jbuild(jcfg), build_model(cfg)
        jlike = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
        like = model.init(0, "meta")
        for fsdp in (False, True):
            ref = _ref_specs(jparams.param_pspecs(jlike, ref_mesh, fsdp=fsdp))
            got = tparams.param_pspecs(like, mesh, fsdp=fsdp)
            assert _compare(got, ref, cfg) == len(tree_leaves(like))
        opt = tparams.opt_pspecs(None, got)
        assert opt["count"] == tuple(P()) and opt["m"] is got
        for batch, length, div in ((4, 64, True), (32, 8192, True), (3, 64, False)):
            jcache = jax.eval_shape(lambda: jmodel.init_cache(batch, length))
            ref = _ref_specs(jparams.cache_pspecs(jcache, ref_mesh, div))
            got = tparams.cache_pspecs(model.init_cache(batch, length,
                                                        device="meta"), mesh, div)
            assert _compare(got, ref, cfg, cache=True) > 0


def test_sharding_rules_match_reference():
    logical = [("batch", "seq", "heads", None), ("batch", "act_seq", "embed"),
               ("vocab", "embed"), ("batch", "seq", "ffn"), ("experts", None),
               ("lru_width",), ("ssm_heads", "state"), ("param_fsdp",),
               ("kv_seq", "kv_heads"), (None, None)]
    pairs = [(jsharding.DEFAULT_RULES, tsharding.DEFAULT_RULES),
             (jsharding.MULTIPOD_RULES, tsharding.MULTIPOD_RULES),
             (jsharding.FULL_FSDP_RULES, tsharding.FULL_FSDP_RULES)]
    pairs += [(jsharding.with_sequence_parallel(j), tsharding.with_sequence_parallel(t))
              for j, t in pairs]
    for manual in (("data",), ("pod", "data"), ("data", "model")):
        pairs += [(jsharding.manual_data_rules(j, manual),
                   tsharding.manual_data_rules(t, manual)) for j, t in pairs[:3]]
    for j, t in pairs:
        assert j.rules == t.rules
        for axes in logical:
            assert t.spec(axes) == tuple(j.spec(axes)), (axes, t.spec(axes))
            with jsharding.use_sharding_rules(j), tsharding.use_sharding_rules(t):
                assert tsharding.logical_spec(*axes) == tuple(
                    jsharding.logical_spec(*axes))
                assert tsharding.current_rules() is t
    assert tsharding.logical_spec("batch", None) == tuple(
        jsharding.logical_spec("batch", None)) == (None, None)
    for n, axes in itertools.product((1, 3), ((), ("data",), ("pod", "data"))):
        assert tsharding.flat_buffer_specs(n, axes) == tuple(
            tuple(s) for s in jsharding.flat_buffer_specs(n, axes))
    # the production meshes are descriptions: shape, axes, J; no ranks
    for multi, (shape, axes) in ((False, MESHES["16x16"]), (True, MESHES["2x16x16"])):
        got, want = (tmesh.make_production_mesh(multi_pod=multi),
                     _StandIn(shape, axes))
        assert got.shape == want.shape and got.axis_names == axes
        assert got.coords is None
        assert tmesh.data_axes(got) == axes[:-1]
        assert tmesh.num_workers(got) == int(np.prod(shape[:-1]))
    with pytest.raises(ValueError, match="layout only"):
        make_fsdp_norm_step(build_model(get_smoke_config("llama3.2-1b")),
                            AdamWConfig(), device="cpu",
                            mesh=tmesh.make_host_mesh(2, 2))
    assert (tmesh.num_workers(), tmesh.worker_index()) == (1, 0)
    one = tmesh.make_host_mesh()
    assert one.coords == {"data": 0, "model": 0} and tmesh.num_workers(one) == 1


def _rank_mesh_layout():
    """One rank of a 2 × 2 mesh: its coordinates, sums over its groups, and
    a leaf sliced and gathered back."""
    mesh = tmesh.make_host_mesh(data=2, model=2)
    r = torch.distributed.get_rank()
    sums = [float(tmesh.psum(torch.tensor(float(r)), g))
            for g in (mesh.data_group, mesh.model_group, None)]
    x = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2)
    spec = (("data",), "model", None)
    part = tparams.shard_tree([x], [spec], mesh)[0]
    whole = tparams.gather_tree([part.contiguous()], [spec], mesh)[0]
    model_only = tparams.gather_tree([part.contiguous()], [spec], mesh,
                                     axes=("model",))[0]
    out = {"coords": mesh.coords, "j": tmesh.worker_index(mesh),
           "J": tmesh.num_workers(mesh), "sums": sums,
           "part": part.tolist(), "whole_ok": bool(torch.equal(whole, x)),
           "model_only": list(model_only.shape)}
    every = [None] * 4
    torch.distributed.all_gather_object(every, out)
    return every


def test_host_mesh_coordinates_groups_and_slices():
    got = tmesh.spawn_workers(_rank_mesh_layout, 4, timeout_s=TIMEOUT_S)
    x = torch.arange(4 * 6 * 2, dtype=torch.float32).reshape(4, 6, 2)
    for r, out in enumerate(got):
        d, m = divmod(r, 2)
        assert out["coords"] == {"data": d, "model": m}
        assert (out["j"], out["J"]) == (d, 2)
        # data line {m, m + 2}, model line {2d, 2d + 1}, every rank
        assert out["sums"] == [float(m + m + 2), float(4 * d + 1), 6.0]
        assert out["part"] == x[2 * d:2 * d + 2, 3 * m:3 * m + 3].tolist()
        assert out["whole_ok"] and out["model_only"] == [2, 6, 2]


# ------------------------------------------------------ steps on a grid ----

STEPS = 3
SNAPS = (0, STEPS - 1)
SHARES = (5e-4, 2.5e-2)
METRICS = ("loss", "var_l1", "grad_sqnorm", "grad_norm", "clip_scale")
PLAN = BatchPlan(global_batch=8, micro_batch=2, accum_steps=2, workers=2)
LR = 1e-3
# (step, arch, residency, (data, model))
FSDP_CASES = [("fsdp_norm", a, i, (2, 2))
              for a in ("llama3.2-1b", "microllama-300m") for i in ("tree", "flat")]
ACCUM_CASES = [("accum_norm", "llama3.2-1b", i, g)
               for g in ((2, 1), (2, 2)) for i in ("tree", "flat")]
CASES = FSDP_CASES + ACCUM_CASES

_JAX_GRID = """
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import set_mesh
from repro.configs import get_smoke_config
from repro.core.schedule import BatchPlan
from repro.data.pipeline import MarkovTokens, make_batch
from repro.distributed.train_step import make_accum_norm_step, make_fsdp_norm_step
from repro.launch.mesh import make_host_mesh
from repro.models import build_model
from repro.optim.adamw import AdamWConfig, init_adamw, init_adamw_flat

plan = BatchPlan(global_batch=8, micro_batch=2, accum_steps=2, workers=2)
out = {}
for step_impl, arch, impl, (d, m) in %(cases)r:
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    mesh = make_host_mesh(data=d, model=m)
    src = MarkovTokens(vocab_size=cfg.vocab_size, seed=0)
    batches = [jax.tree.map(jnp.asarray, make_batch(src, t, plan, 16))
               for t in range(%(steps)d)]
    params = model.init(jax.random.PRNGKey(0))
    make = make_fsdp_norm_step if step_impl == "fsdp_norm" else make_accum_norm_step
    wrap, _, _ = make(model, AdamWConfig(), mesh, stats_impl=impl,
                      params_impl=impl, params_like=params)
    layout = wrap.flat_layout
    opt = (init_adamw_flat(params, shard_divisor=d, layout=layout)
           if impl == "flat" else init_adamw(params))
    if impl == "flat":
        params = tuple(layout.flatten(params))
    view = ((lambda p: layout.unflatten(list(p))) if impl == "flat"
            else (lambda p: p))
    tag = f"{step_impl}/{arch}/{impl}/{d}x{m}"
    with set_mesh(mesh):
        fn = wrap(jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                               batches[0]))
        for t, b in enumerate(batches):
            params, opt, mt = fn(params, opt, b, jnp.float32(%(lr)r))
            for k in %(metrics)r:
                out[f"{tag}/{k}/{t}"] = np.float64(mt[k])
            if t in %(snaps)r:
                for i, leaf in enumerate(jax.tree.leaves(view(params))):
                    out[f"{tag}/snap{t}/{i}"] = np.asarray(leaf, np.float32)
np.savez(%(path)r, **out)
print("SAVED")
"""


@pytest.fixture(scope="module")
def jax_grid(tmp_path_factory):
    """The reference's steps on its 4 forced host devices, every case."""
    path = str(tmp_path_factory.mktemp("grid") / "ref.npz")
    out = run_subprocess(_JAX_GRID % dict(cases=CASES, steps=STEPS, lr=LR,
                                          metrics=METRICS, snaps=SNAPS, path=path),
                         devices=4)
    assert "SAVED" in out
    return dict(np.load(path))


def _grid_rank(cases, inits, batches):
    """This rank's steps for every case on its grid (the ranks of the
    process group are the grid); rank 0's metrics and whole parameters."""
    out = {}
    world = torch.distributed.get_world_size()
    for (step_impl, arch, impl, (d, m)), init_np in zip(cases, inits):
        if d * m != world:
            continue
        mesh = tmesh.make_host_mesh(data=d, model=m)
        cfg = get_smoke_config(arch)
        model = build_model(cfg)
        params = params_from_jax(init_np, cfg)
        make = make_fsdp_norm_step if step_impl == "fsdp_norm" else make_accum_norm_step
        wrap = make(model, AdamWConfig(), stats_impl=impl, params_impl=impl,
                    params_like=params, mesh=mesh)
        layout, specs = wrap.flat_layout, wrap.param_specs
        if impl == "flat":
            opt = init_adamw_flat(params, shard_divisor=d, layout=layout)
            params = tuple(shard_flat_buffers(layout.flatten(params), mesh))
        else:
            params = tree_map(lambda x: x.clone(memory_format=torch.contiguous_format),
                              tparams.shard_tree(params, specs, mesh))
            opt = init_adamw(params)
        tag = f"{step_impl}/{arch}/{impl}/{d}x{m}"
        for t, b in enumerate(batches):
            params, opt, mt = wrap(b)(params, opt, batch_to_device(b, "cpu"),
                                      torch.tensor(LR))
            for k in METRICS:
                out[f"{tag}/{k}/{t}"] = float(mt[k])
            if t in SNAPS:
                full = (layout.unflatten(gather_flat_buffers(params, mesh=mesh))
                        if impl == "flat" else tparams.gather_tree(params, specs, mesh))
                out[f"{tag}/snap{t}"] = [x.detach().clone() for x in tree_leaves(full)]
    return out


@pytest.fixture(scope="module")
def port_grid():
    """The port's steps on gloo ranks: one process group of 4 ranks runs
    the 2 × 2 cases, one of 2 ranks the J = 2 ones."""
    inits = [jax_tree_np(jbuild(jget(a)).init(jax.random.PRNGKey(0)))
             for _, a, _, _ in CASES]
    src = MarkovTokens(vocab_size=512, seed=0)
    batches = [make_batch(src, t, PLAN, 16) for t in range(STEPS)]
    out = {}
    for world in (4, 2):
        out.update(tmesh.spawn_workers(_grid_rank, world, CASES, inits, batches,
                                       timeout_s=TIMEOUT_S))
    return out, inits


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}-{c[3][0]}x{c[3][1]}")
def test_grid_steps_match_reference(jax_grid, port_grid, case):
    got, inits = port_grid
    step_impl, arch, impl, (d, m) = case
    tag = f"{step_impl}/{arch}/{impl}/{d}x{m}"
    for t in range(STEPS):
        for k in METRICS:
            np.testing.assert_allclose(got[f"{tag}/{k}/{t}"], jax_grid[f"{tag}/{k}/{t}"],
                                       rtol=1e-5, atol=1e-7, err_msg=f"{tag} step {t} {k}")
    assert got[f"{tag}/var_l1/0"] > 0
    init_np = inits[CASES.index(case)]
    treedef = jax.tree.structure(init_np)
    cfg = get_smoke_config(arch)
    for t, share in zip(SNAPS, SHARES):
        leaves = [jax_grid[f"{tag}/snap{t}/{i}"] for i in range(treedef.num_leaves)]
        want_tree = params_from_jax(jax.tree.unflatten(treedef, leaves), cfg)
        want = np.concatenate([w.numpy().ravel() for w in tree_leaves(want_tree)])
        have = np.concatenate([g.float().numpy().ravel() for g in got[f"{tag}/snap{t}"]])
        np.testing.assert_allclose(have, want, rtol=0, atol=1e-4,
                                   err_msg=f"{tag} after step {t + 1}")
        off = np.abs(have - want) > 1e-7 + 1e-5 * np.abs(want)
        assert off.mean() <= share, (tag, t + 1, off.mean())


def test_accum_norm_variance_spans_the_workers(port_grid):
    """ACCUM-NORM's microbatches span the J workers: the 2 × 2 grid gives
    J = 2's numbers, and at J = 2 var_l1 is J times the one-rank step's
    (the same microbatch gradients), its other metrics the same."""
    got, inits = port_grid
    cfg = get_smoke_config("llama3.2-1b")
    model = build_model(cfg)
    src = MarkovTokens(vocab_size=cfg.vocab_size, seed=0)
    batches = [make_batch(src, t, PLAN, 16) for t in range(STEPS)]
    for impl in ("tree", "flat"):
        tag = f"accum_norm/llama3.2-1b/{impl}"
        params = params_from_jax(inits[CASES.index(("accum_norm", "llama3.2-1b",
                                                    impl, (2, 1)))], cfg)
        wrap = make_accum_norm_step(model, AdamWConfig(), params_like=params,
                                    stats_impl=impl, params_impl=impl)
        assert wrap.grid is None and wrap.param_specs is None
        opt = (init_adamw_flat(params, layout=wrap.flat_layout) if impl == "flat"
               else init_adamw(params))
        if impl == "flat":
            params = tuple(wrap.flat_layout.flatten(params))
        for t, b in enumerate(batches):
            params, opt, mt = wrap(b)(params, opt, batch_to_device(b, "cpu"),
                                      torch.tensor(LR))
            for k in METRICS:
                two, grid = got[f"{tag}/2x1/{k}/{t}"], got[f"{tag}/2x2/{k}/{t}"]
                np.testing.assert_allclose(grid, two, rtol=1e-5, atol=1e-7)
                one = float(mt[k]) * (2 if k == "var_l1" else 1)
                np.testing.assert_allclose(two, one, rtol=1e-5, atol=1e-7,
                                           err_msg=f"{impl} step {t} {k}")
