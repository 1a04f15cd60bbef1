"""The comparison that decides `correct`, driven through a whole run on the
CPU at the configurations' smoke sizes: the port's step against the plain
reference, and each fault a cell can have planted under the timed path."""

import pytest

import bench_setup  # noqa: F401  (the import path)

from benchkit import cli
from benchkit.manifest import Cell, load_manifest

SEED = 2**31 + 77


def _run(cell, *extra, seed=SEED):
    code, result = cli.run(["--workload", cell, "--seed", str(seed), "--seconds", "1",
                            "--trace", "0", "--device", "cpu", "--smoke", *extra])
    assert code == 0
    return result


@pytest.mark.parametrize("cell", ["phi3-l8.accum.s2048"])
def test_port_matches_the_reference(cell):
    r = _run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    # no card: no peak memory to read
    want = {m["name"] for m in Cell(load_manifest(), cell).metrics("end_to_end")}
    assert set(r["metrics"]) == want - {"peak_mem_gib"}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", ["phi3-l8.accum.s2048"])
@pytest.mark.parametrize("fault", ["half_batch", "unchanged"])
def test_planted_fault_is_not_correct(cell, fault):
    r = _run(cell, "--fault", fault)
    assert not r["correct"]


def test_unchanged_state_reads_one():
    r = _run("phi3-l8.accum.s2048", "--fault", "unchanged")
    assert r["checks"]["update_leaf_gap"]["value"] == pytest.approx(1.0)
