"""On the card (skipped here): one short run of each one-card cell, and the
control — the plain reference with its float32 products on the TF32
tensor cores, put in the program's place — which the cell's limits must
refuse, at a reduced depth so that a test run holds it."""

import pytest
from bench_setup import card  # noqa: F401  (fixture)

from benchkit import compare
from benchkit.cli import reference_check, run
from benchkit.manifest import Cell, load_manifest
from benchkit.program import Spec

CELLS = [w["name"] for w in load_manifest()["workloads"] if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_on_the_card(card, cell):
    code, r = run(["--workload", cell, "--seed", "3000000077", "--seconds", "5",
                   "--trace", "0"])
    assert code == 0 and r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["metrics"]["train_tokens_per_s"]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3000000101, 3000000102, 3000000103])
def test_tf32_control_is_refused(card, cell, seed):
    c = Cell(load_manifest(), cell)
    c.config = dict(c.config, model=dict(c.config["model"], num_layers=2))
    spec = Spec(cell=cell, config=c.config, traffic=c.traffic, seed=seed, seconds=0,
                trace=False, t_process=0.0)
    f32 = reference_check(c, spec, card)
    tf32 = reference_check(c, spec, card, tf32=True)
    ok, checks = compare.verdict(compare.readings(tf32, f32), c.limits["limits"])
    assert not ok, checks
