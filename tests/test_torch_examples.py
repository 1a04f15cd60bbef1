"""The port's examples (`examples/torch_*.py`) on the CPU for a few steps,
each held to its reference example's job run by the reference: the
`global_batch` trajectory, samples and accumulation exactly, the per-step
losses and T_k within 1e-5 relative (`test_torch_train_loop.py`'s
tolerances), and the served greedy tokens exactly.  The port starts from
the reference's initial parameters.  Outputs land under the test's own
`experiments/`."""

import importlib.util
import math
import pathlib
import sys

import numpy as np
import pytest

import jax

from test_torch_helpers import jax_tree_np

from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget
from repro.launch.train import TrainJob as JJob, run_training as jrun
from repro.models import build_model as jbuild
from repro_torch.models import model as tmodel
from repro_torch.models.convert import params_from_jax

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


def _example(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_init(monkeypatch, cfg):
    """The port's `Model.init` returns the reference's initial parameters
    of `cfg` (the reference's config)."""
    init_np = jax_tree_np(jbuild(cfg).init(jax.random.PRNGKey(0)))
    monkeypatch.setattr(tmodel.Model, "init",
                        lambda self, seed=0, device="cpu":
                        params_from_jax(init_np, self.cfg, device))


def _same_history(ht, hj):
    assert ht["global_batch"] == hj["global_batch"]
    assert ht["samples"] == hj["samples"]
    assert ht["accum_steps"] == hj["accum_steps"]
    np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-5)
    np.testing.assert_allclose(ht["T"], hj["T"], rtol=1e-5)
    vt = [v for v in ht["val_loss"] if math.isfinite(v)]
    vj = [v for v in hj["val_loss"] if math.isfinite(v)]
    np.testing.assert_allclose(vt, vj, rtol=1e-5)


@pytest.fixture
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_quickstart(in_tmp, monkeypatch, capsys):
    ex = _example("torch_quickstart")
    _reference_init(monkeypatch, jget(ex.JOB["arch"]))
    ht = ex.main(["--steps", "4", "--device", "cpu"])
    hj = jrun(JJob(**ex.JOB, steps=4))
    _same_history(ht, hj)
    out = capsys.readouterr().out
    assert "step   bsz     loss      T_k" in out and "summary:" in out


def test_gns_tracking(in_tmp, monkeypatch, capsys):
    from repro.core.gns import GNSTracker as JTracker
    from repro.core.gns import variance_groups as jgroups
    ex = _example("torch_gns_tracking")
    _reference_init(monkeypatch, jget(ex.JOB["arch"]))
    ht = ex.main(["--steps", "4", "--device", "cpu"])
    hj = jrun(JJob(**ex.JOB, steps=4))
    _same_history(ht, hj)
    # the port's tracker over its history is the reference's over the same
    tracker = JTracker(alpha=0.8)
    for i in range(len(ht["step"])):
        tracker = tracker.update(
            ht["var_l1"][i], ht["grad_sqnorm"][i], ht["global_batch"][i],
            ht["workers"], groups=jgroups("accum_norm", ht["workers"],
                                          ht["accum_steps"][i]))
    assert (ht["tracker"].s_ema, ht["tracker"].g2_ema) == \
        (tracker.s_ema, tracker.g2_ema)
    assert "B_simple" in capsys.readouterr().out


def test_pretrain_e2e(in_tmp, monkeypatch):
    """The ~20M-parameter job, registered in both packages' registries (the
    registrations undone after the test)."""
    import repro.configs as C
    import repro_torch.configs as TC
    ex = _example("torch_pretrain_e2e")
    monkeypatch.setattr(TC, "_REGISTRY", dict(TC._REGISTRY))
    monkeypatch.setitem(sys.modules, "repro_torch.configs._e2e", None)
    # the reference example's registration of the same config
    mod = type(sys)("repro.configs._e2e")
    mod.CONFIG = jget_config("microllama-300m").replace(
        name=ex.E2E_ARCH, num_layers=4, d_model=512, num_heads=8,
        num_kv_heads=8, head_dim=64, d_ff=1408, vocab_size=8192)
    mod.smoke_config = lambda: mod.CONFIG
    monkeypatch.setitem(C._REGISTRY, ex.E2E_ARCH, "_e2e")
    monkeypatch.setitem(sys.modules, "repro.configs._e2e", mod)
    _reference_init(monkeypatch, mod.CONFIG)
    ht = ex.main(["--steps", "3", "--device", "cpu"])
    assert TC.get_config(ex.E2E_ARCH).param_count() == mod.CONFIG.param_count()
    assert (in_tmp / "experiments" / "e2e_log.csv").exists()
    assert (in_tmp / "experiments" / "e2e_ckpt").exists()
    hj = jrun(JJob(arch=ex.E2E_ARCH, smoke=False, eta=0.15, steps=3,
                   **{**ex.JOB, "checkpoint_dir": "experiments/ref_ckpt",
                      "log_path": "experiments/ref_log.csv"}))
    _same_history(ht, hj)


def test_serve_batched(in_tmp, monkeypatch, capsys):
    from repro.launch.serve import run_serving as jserve
    ex = _example("torch_serve_batched")
    _reference_init(monkeypatch, jget("gemma2-27b"))
    res = ex.main(["--device", "cpu"])
    want = jserve("gemma2-27b", smoke=True, batch=4, prompt_len=24, gen_len=24)
    np.testing.assert_array_equal(np.asarray(res["tokens"]),
                                  np.asarray(want["tokens"]))
    assert "arch=gemma2-27b batch=4" in capsys.readouterr().out


def test_batch_schedule_comparison(in_tmp, monkeypatch):
    """Every scheme on a 64-sample budget, each against the reference."""
    ex = _example("torch_batch_schedule_comparison")
    _reference_init(monkeypatch, jget("microllama-300m"))
    hists = ex.main(["--steps", "1", "--device", "cpu"])
    assert list(hists) == list(ex.SCHEMES)
    for name in ex.SCHEMES:
        _same_history(hists[name], jrun(JJob(**ex.scheme_job(name, 1))))
    rows = (in_tmp / ex.CSV).read_text().splitlines()
    assert rows[0] == "scheme,steps,avg_bsz,best_loss,best_val_loss,wall_s"
    assert [r.split(",")[0] for r in rows[1:]] == list(ex.SCHEMES)


def test_examples_need_the_card_unless_cpu():
    """With no card and no `--device cpu` an example raises at once."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example("torch_quickstart").main(["--steps", "1"])
