"""Serving on a data × model grid against the reference, on the CPU.

The port's ranks are spawned gloo processes (one a mesh position); the
reference runs on forced host devices in processes of its own, started
beside the port's ranks.  Parameters come from the reference's init
through `params_from_jax`.

* `ServeEngine` on 2 × 1 (the counterpart of the reference's
  `test_serve_engine.py::test_engine_two_device_decode_sharding`, the
  reference on 2 forced host devices), 1 × 2 and 2 × 2 (4 devices): the
  same scenario of staggered joins, a first finisher at slot 0 backfilled
  from slot 3 (a row that changes data rank) and rungs of 1 and 3 slots
  (b mod J != 0): every request's tokens, the rung trace and the
  bookkeeping exactly equal to the reference's, and the resident pool
  gathered in slot order within 1e-5 of the reference's.
* `run_serving` and `run_continuous_serving` on 2 × 2 against the
  reference's drivers on the same mesh: tokens, the rung trace, the
  steady-state probe and the engine's counters exactly.
* The CLI serves on a 2 × 2 grid (`--mesh-data 2 --mesh-model 2`)."""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import jax

from conftest import SRC
from test_torch_helpers import jax_tree_np

from repro.configs import get_smoke_config as jget
from repro.models import build_model as jbuild
from repro_torch.configs import get_smoke_config
from repro_torch.distributed.serve_engine import ServeEngine
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.serve import main, run_continuous_serving, run_serving
from repro_torch.models.convert import cache_from_jax, params_from_jax
from repro_torch.models.model import build_model

ARCH = "llama3.2-1b"
SEED = 7
TIMEOUT_S = 300
TOL = 1e-5
ENGINE = dict(max_slots=4, cache_len=16, ladder=(1, 3, 4))
BOOKKEEPING = ("steps", "requests_completed", "tokens_generated",
               "prompt_tokens", "slot_resets", "slot_moves", "rung_transitions",
               "padding_waste", "buckets_used")
SERVE = dict(batch=4, prompt_len=6, gen_len=6, seed=0)
CONTINUOUS = dict(max_slots=4, prompt_len=3, gen_len=4, load_steps=24,
                  arrival_rate=0.5, burst_every=10, burst_size=3, seed=0)
# forced host devices -> the reference's engine meshes; ranks -> the port's
GRIDS = {2: [(2, 1)], 4: [(1, 2), (2, 2)]}
RANKS = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}

# one scenario for both packages' engines (the same host logic on the same
# submits): four requests at once, the one in slot 0 finishing first, so
# slot 3's row backfills it across the data ranks; then a request alone,
# long enough for the controller to shrink to rung 1, and two more, two
# steps apart (rung 3)
SCENARIO = '''
def scenario(eng, prompts):
    trace = []

    def drain():
        while True:
            report = eng.step()
            if report is None:
                return
            trace.append(report["rung"])

    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts[:4], (2, 6, 4, 5))]
    drain()
    reqs.append(eng.submit(prompts[4], max_new_tokens=12))
    drain()
    reqs.append(eng.submit(prompts[5], max_new_tokens=5))
    for _ in range(2):
        trace.append(eng.step()["rung"])
    reqs.append(eng.submit(prompts[6], max_new_tokens=3))
    drain()
    return [list(map(int, r.generated)) for r in reqs], trace


def prompts(vocab):
    r = np.random.RandomState(4)
    return [r.randint(0, vocab, size=(r.randint(2, 5),)).astype(np.int32)
            for _ in range(7)]
'''
exec(SCENARIO)

_JAX = """
import json, pickle
import numpy as np
import jax
from repro.configs import get_smoke_config
from repro.distributed.serve_engine import ServeEngine
from repro.launch.mesh import make_host_mesh
from repro.launch.serve import run_continuous_serving, run_serving
from repro.models import build_model
%(scenario)s
cfg = get_smoke_config(%(arch)r)
model = build_model(cfg)
params = model.init(jax.random.PRNGKey(%(seed)d))
out, caches = {}, {}
for d, m in %(grids)r:
    eng = ServeEngine(model, params, make_host_mesh(d, m), **%(engine)r)
    tokens, trace = scenario(eng, prompts(cfg.vocab_size))
    stats = eng.stats.as_dict()
    out[f"{d}x{m}"] = {"tokens": tokens, "trace": trace,
                       "book": {k: stats[k] for k in %(book)r},
                       "spread": len(jax.tree.leaves(eng._kv)[0].sharding.device_set)}
    caches[f"{d}x{m}"] = jax.tree.map(np.asarray, eng._kv)
if %(drivers)r:
    out["serving"] = run_serving(%(arch)r, mesh_data=2, mesh_model=2,
                                 **%(serve)r)["tokens"].tolist()
    res = run_continuous_serving(%(arch)r, mesh_data=2, mesh_model=2, **%(cont)r)
    out["continuous"] = {"trace": res["rung_trace"], "probe": res["probe"],
                         "completed": res["requests_completed"],
                         "book": {k: res["engine"][k] for k in %(book)r}}
with open(%(path)r, "wb") as f:
    pickle.dump(caches, f)
print("OUT", json.dumps(out))
"""


def _start_reference(devices: int, path: str):
    code = _JAX % dict(scenario=SCENARIO, arch=ARCH, seed=SEED, grids=GRIDS[devices],
                       engine=ENGINE, book=BOOKKEEPING, drivers=devices == 4,
                       serve=SERVE, cont=CONTINUOUS, path=path)
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _rank_engines(grids, init_np, drivers):
    """This rank's part of the grids' engines (and, on 4 ranks, of the
    drivers); rank 0 returns the tokens, traces, bookkeeping and gathered
    pools."""
    cfg = get_smoke_config(ARCH)
    model = build_model(cfg)
    params = params_from_jax(init_np, cfg)
    out = {}
    for d, m in grids:
        mesh = tmesh.make_host_mesh(data=d, model=m)
        eng = ServeEngine(model, params, mesh, **ENGINE)
        tokens, trace = scenario(eng, prompts(cfg.vocab_size))
        stats = eng.stats.as_dict()
        out[f"{d}x{m}"] = {"tokens": tokens, "trace": trace,
                           "book": {k: stats[k] for k in BOOKKEEPING},
                           "local_rows": eng._kv[0]["k"].shape[0],
                           "cache": eng.gathered_cache()}
    if drivers:
        ref = params_from_jax(jax_tree_np(jbuild(jget(ARCH)).init(jax.random.PRNGKey(0))), cfg)
        out["serving"] = run_serving(ARCH, mesh_data=2, mesh_model=2, params=ref,
                                     **{k: v for k, v in SERVE.items() if k != "seed"})
        out["continuous"] = run_continuous_serving(
            ARCH, mesh_data=2, mesh_model=2, params=ref,
            **{k: v for k, v in CONTINUOUS.items() if k != "seed"})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, its pools, the port's outputs), each keyed
    by grid ("2x1", ...) and driver: the reference's two processes started
    first, the port's ranks beside them."""
    root = tmp_path_factory.mktemp("serve_mesh")
    procs = {n: _start_reference(n, str(root / f"cache{n}.pkl")) for n in GRIDS}
    try:
        init_np = jax_tree_np(jbuild(jget(ARCH)).init(jax.random.PRNGKey(SEED)))
        got = {}
        for n, grids in RANKS.items():
            got.update(tmesh.spawn_workers(_rank_engines, n, grids, init_np, n == 4,
                                           timeout_s=TIMEOUT_S))
        want, caches = {}, {}
        for n, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=TIMEOUT_S * 2)
            if proc.returncode != 0:
                raise AssertionError(f"reference process failed:\n{stdout}\n{stderr}")
            with open(root / f"cache{n}.pkl", "rb") as f:
                caches.update(pickle.load(f))
            want.update(json.loads(stdout.split("OUT ", 1)[1]))
        return want, caches, got
    finally:
        for proc in procs.values():
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("grid", ["2x1", "1x2", "2x2"])
def test_engine_on_a_grid_matches_reference(runs, grid):
    want, cache, got = (r[grid] for r in runs)
    assert got["tokens"] == want["tokens"]
    assert got["trace"] == want["trace"]
    assert 1 in got["trace"] and 3 in got["trace"]      # rungs J does not divide
    assert got["book"] == want["book"]
    assert got["book"]["slot_moves"] > 0
    ref = cache_from_jax(cache, get_smoke_config(ARCH))
    for layer_got, layer_want in zip(got["cache"], ref, strict=True):
        for k, x in layer_want.items():
            np.testing.assert_allclose(layer_got[k].numpy(), x.numpy(), rtol=0,
                                       atol=TOL * float(x.abs().max()), err_msg=k)


def test_engine_two_rank_decode_sharding(runs):
    """The pool really is spread over the two data ranks: each holds half
    its slots, as the reference's pool lies on both devices."""
    want, _, got = (r["2x1"] for r in runs)
    assert want["spread"] == 2
    assert got["local_rows"] == ENGINE["max_slots"] // 2


def test_run_serving_on_2x2_matches_reference(runs):
    want, _, got = runs
    assert got["serving"]["tokens"].tolist() == want["serving"]
    assert got["serving"]["tokens"].shape == (SERVE["batch"], SERVE["gen_len"])


def test_run_continuous_serving_on_2x2_matches_reference(runs):
    want, _, got = runs
    res, ref = got["continuous"], want["continuous"]
    assert res["rung_trace"] == ref["trace"]
    assert res["probe"] == ref["probe"]
    assert res["probe"]["steady_state_transition_hit"]
    assert res["requests_completed"] == ref["completed"]
    assert {k: res["engine"][k] for k in BOOKKEEPING} == ref["book"]


def test_cli_serves_on_a_grid(capsys):
    main(["--device", "cpu", "--mesh-data", "2", "--mesh-model", "2", "--continuous",
          "--max-slots", "4", "--prompt-len", "3", "--gen-len", "3", "--load-steps", "6"])
    out = capsys.readouterr().out
    assert "served" in out and "steady_state_transition_hit': True" in out
