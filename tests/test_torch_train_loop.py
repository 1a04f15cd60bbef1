"""Port training loop end to end: the quickstart job through both
`run_training`s, the port running without JAX, and the rule that the port
imports nothing of JAX or of the reference package.

Quickstart tolerance: the `global_batch` trajectory must be identical; the
per-step losses agree to 1e-5 relative (measured ≤ 2e-7 over 20 steps) and
the final validation loss to 1e-5."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from test_torch_helpers import jax_tree_np

from repro.configs import get_smoke_config as jget
from repro.launch.train import TrainJob as JJob, run_training as jrun
from repro.models import build_model as jbuild
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.models.convert import params_from_jax

REPO = Path(__file__).resolve().parents[1]
QUICKSTART = dict(arch="llama3.2-1b", smoke=True, schedule="adaptive",
                  eta=0.12, step_impl="accum_norm", steps=20, seq_len=64,
                  base_global_batch=4, max_global_batch=64,
                  base_micro_batch=2, max_micro_batch=4, base_accum=2,
                  eval_every=20, stats_impl="flat", params_impl="flat")


def test_quickstart_trajectory_matches_reference(monkeypatch):
    hj = jrun(JJob(**QUICKSTART))
    # the port starts from the reference's initial parameters
    init_np = jax_tree_np(jbuild(jget("llama3.2-1b")).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(tmodel.Model, "init",
                        lambda self, seed=0, device="cpu":
                        params_from_jax(init_np, self.cfg, device))
    ht = ttrain.run_training(ttrain.TrainJob(device="cpu", **QUICKSTART))
    # the port adds what each worker ran (its kernel launches, peak memory)
    # and the microbatches each step ran (a padded bucket's M)
    assert sorted(set(ht) - {"ranks", "micro_steps"}) == sorted(hj)
    assert len(ht["micro_steps"]) == len(ht["step"])
    assert all(m >= a for m, a in zip(ht["micro_steps"], ht["accum_steps"]))
    assert ht["ranks"] == [{"launches": {"fused_adamw_stats": 0, "fused_adamw": 0,
                                         "fused_stats": 0, "sqdiff_norm": 0,
                                         "rmsnorm": 0, "flash_attention": 0,
                                         "dense": 0},
                            "peak_mem_bytes": None}]
    assert ht["global_batch"] == hj["global_batch"]
    assert ht["samples"] == hj["samples"]
    assert ht["accum_steps"] == hj["accum_steps"]
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-5)
    np.testing.assert_allclose(ht["T"], hj["T"], rtol=1e-5)
    np.testing.assert_allclose(ht["val_loss"][-1], hj["val_loss"][-1], rtol=1e-5)
    assert sorted(ht["engine"]) == sorted(hj["engine"])
    assert ht["engine"]["padding_waste"] == hj["engine"]["padding_waste"]
    # the rung cache builds each signature once, as the reference compiles it
    for k in ("compiles", "hits", "steps", "transitions", "transition_hits",
              "buckets_used"):
        assert ht["engine"][k] == hj["engine"][k], k
    s = ttrain.summarize(ht)
    assert sorted(s) == sorted(__import__("repro.launch.train", fromlist=["x"])
                               .summarize(hj))


def test_port_runs_without_jax():
    """The port imports and trains (2 CPU steps, through the CLI) in a
    process where importing jax or the reference package fails."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import torch; torch.set_num_threads(2)\n"
        "from repro_torch.launch.train import main\n"
        "main(['--arch', 'microllama-300m', '--device', 'cpu', '--steps', '2',"
        " '--step-impl', 'accum_norm', '--stats-impl', 'flat',"
        " '--params-impl', 'flat', '--seq-len', '16', '--base-global-batch', '4',"
        " '--max-global-batch', '8', '--eval-every', '2', '--eval-batches', '1'])\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))"
        " for m in sys.modules if sys.modules[m] is not None)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert '"steps": 2' in res.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_port_imports_no_jax_and_no_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), \
                f"{f.relative_to(REPO)} imports {mod}"


def test_device_is_the_card_unless_the_cpu_is_asked_for(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.run_training(ttrain.TrainJob(arch="llama3.2-1b",
                                            step_impl="accum_norm", steps=1))
    assert ttrain.resolve_device("cpu") == torch.device("cpu")
    # the default job (FSDP-Norm, one worker) trains
    hist = ttrain.run_training(ttrain.TrainJob(device="cpu", steps=2, seq_len=16,
                                               eval_every=0))
    assert ttrain.TrainJob().step_impl == "fsdp_norm"
    assert hist["workers"] == 1 and len(hist["loss"]) == 2
    assert all(np.isfinite(hist["loss"])) and hist["var_l1"] == [0.0, 0.0]
    # checkpointing is ported: periodic saves land beside the final one
    ck = tmp_path / "ck"
    ttrain.run_training(ttrain.TrainJob(device="cpu", step_impl="accum_norm",
                                        steps=2, seq_len=16, eval_every=0,
                                        checkpoint_dir=str(ck),
                                        checkpoint_every=1))
    assert sorted(f.name for f in ck.glob("*.npz")) == [
        "ckpt_00000001.npz", "ckpt_00000002.npz"]
    # the grid is ported (tests/test_torch_tp.py, test_torch_tp_kinds.py):
    # dbrx on a model axis and a mixed residency over two ACCUM-NORM ranks
    # train
    for kw in (dict(arch="dbrx-132b", mesh_model=2),
               dict(step_impl="accum_norm", mesh_data=2, stats_impl="flat")):
        hist = ttrain.run_training(ttrain.TrainJob(device="cpu", steps=1,
                                                   seq_len=16, eval_every=0, **kw))
        assert np.isfinite(hist["loss"]).all() and len(hist["ranks"]) == 2
    # coordination, warm-up and the compile cache are ported: the CLI runs
    # the job through a file coordinator (a world of one)
    capsys.readouterr()
    ttrain.main(["--device", "cpu", "--step-impl", "accum_norm", "--steps", "2",
                 "--seq-len", "16", "--eval-every", "0", "--coord", "file",
                 "--coord-dir", str(tmp_path / "coord"), "--aot-warmup",
                 "--compile-cache", str(tmp_path / "cache")])
    summary = json.loads(capsys.readouterr().out)
    assert summary["steps"] == 2 and np.isfinite(summary["best_loss"])
    assert summary["engine"]["compiles"] >= 1 and summary["engine"]["desyncs"] == 0


@pytest.mark.parametrize("schedule,extra", [
    ("constant", {}),
    ("stagewise", {"stages": ((0.5, 4), (0.5, 8))}),
    ("constant", {"accum_free": True}),
    ("adaptive", {"bucket_ladder": "off"}),
])
def test_other_schedules_and_regimes_match_reference(schedule, extra,
                                                    monkeypatch):
    """Constant, stagewise, accum-free low rungs and the ladder-less loop
    take the same batch trajectory and losses in both packages."""
    kw = dict(arch="tinyllama-1.1b", smoke=True, schedule=schedule, eta=0.3,
              step_impl="accum_norm", steps=4, seq_len=16,
              base_global_batch=4, max_global_batch=16, base_micro_batch=2,
              max_micro_batch=4, base_accum=2, eval_every=0,
              stats_impl="tree", params_impl="tree", **extra)
    hj = jrun(JJob(**kw))
    init_np = jax_tree_np(jbuild(jget("tinyllama-1.1b")).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(tmodel.Model, "init",
                        lambda self, seed=0, device="cpu":
                        params_from_jax(init_np, self.cfg, device))
    ht = ttrain.run_training(ttrain.TrainJob(device="cpu", **kw))
    for k in ("global_batch", "samples", "accum_steps", "opt_steps"):
        assert ht[k] == hj[k], k
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-5)
