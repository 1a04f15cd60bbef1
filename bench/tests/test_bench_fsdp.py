"""FSDP-Norm's cell on four gloo ranks on the CPU at smoke size: the
whole-batch result against the reference, the exchange between the
workers left out, and a rank that loaded JAX."""

import pytest

import bench_setup  # noqa: F401  (the import path)
from benchkit import cli
from benchkit.manifest import load_manifest

CELL = "phi3.fsdp4.s2048"


def _run(*extra, code=0):
    if CELL not in {w["name"] for w in load_manifest()["workloads"]}:
        pytest.skip(f"{CELL} is not in BENCHMARK.json")
    got, result = cli.run(["--workload", CELL, "--seed", "4000000003", "--seconds", "1",
                           "--trace", "1", "--device", "cpu", "--smoke", *extra])
    assert got == code
    return result


def test_four_ranks_match_the_reference():
    r = _run()
    assert r["correct"], r["checks"]
    assert r["device"]["count"] == 4 and "host_loop_ms.fsdp" in r["metrics"]


@pytest.mark.parametrize("fault", ["no_exchange", "half_batch", "unchanged"])
def test_planted_fault_is_not_correct(fault):
    assert not _run("--fault", fault)["correct"]


def test_jax_in_a_rank_refuses_the_run(capsys):
    # a fake `jax` module planted in the last spawned rank, after its window
    assert _run("--fault", "jax_in_rank", code=3) is None
    assert "['jax']" in capsys.readouterr().err
