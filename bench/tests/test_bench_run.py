"""The command as a checkout runs it: what it refuses, and that the
process that prints the result never loads JAX or the JAX package."""

import json
import os
import shutil
import subprocess
import sys

import bench_setup  # noqa: F401  (the import path)
from benchkit.cli import loaded_forbidden
from benchkit.manifest import BENCH, ROOT

CMD = [sys.executable, str(BENCH / "run.py"), "--workload", "phi3-l8.accum.s2048",
       "--seed", "3000000123", "--seconds", "1", "--trace", "0"]


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_forbidden_names_compare_whole():
    assert loaded_forbidden(["repro_torch", "repro_torch.models", "reprox", "numpy"]) == []
    assert loaded_forbidden(["repro_torch", "jax.numpy"]) == ["jax"]
    assert loaded_forbidden(["repro.core.controller", "flax", "jaxlib"]) == [
        "flax", "jaxlib", "repro"]


def test_smoke_run_prints_the_result_and_loads_no_jax():
    out = subprocess.run(CMD + ["--device", "cpu", "--smoke"], capture_output=True,
                         text=True, env=_env(), cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and list(result)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1] == "correct = True"


def test_refuses_without_a_card():
    out = subprocess.run(CMD, capture_output=True, text=True, env=_env(), cwd=ROOT,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_refuses_without_the_port(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cmd = [sys.executable, "bench/run.py"] + CMD[2:] + ["--device", "cpu", "--smoke"]
    out = subprocess.run(cmd, capture_output=True, text=True, env=_env(), cwd=tmp_path,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
