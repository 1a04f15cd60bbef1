"""Port crash-safe training (DESIGN §12) against itself on the CPU, as
tests/test_resume.py holds the reference: periodic checkpoints plus
`resume` reproduce the uninterrupted run BIT-identically (floats compared
with ==) — in-process in all four residency combinations, across a real
SIGKILL mid-run and during a checkpoint commit, and with two FSDP-Norm
gloo ranks whose flat shards are gathered on save and re-split on resume.
Every process here sets torch to 2 threads, so all runs sum in the same
order."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_helpers  # noqa: F401  (thread cap)

from repro_torch.checkpoint.store import latest_step
from repro_torch.launch.train import TrainJob, run_training
from repro_torch.tree import tree_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def _job_kw(**over):
    kw = dict(arch="llama3.2-1b", schedule="adaptive", steps=8,
              total_samples=100_000, seq_len=16, base_global_batch=4,
              max_global_batch=8, base_micro_batch=2, max_micro_batch=2,
              base_accum=2, eta=0.12, step_impl="accum_norm",
              eval_every=4, eval_batches=2, device="cpu")
    kw.update(over)
    return kw


def _assert_suffix_identical(resumed: dict, ref: dict, k: int):
    """The resumed run's history equals the uninterrupted run's from step
    k+1 on — EXACTLY."""
    assert resumed["resumed_from"] == k
    assert resumed["loss"] == ref["loss"][k:]
    assert resumed["global_batch"] == ref["global_batch"][k:]
    assert resumed["samples"] == ref["samples"][k:]
    assert resumed["var_l1"] == ref["var_l1"][k:]
    np.testing.assert_array_equal(np.asarray(resumed["val_loss"]),
                                  np.asarray(ref["val_loss"][k:]))


def _assert_params_identical(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True):
        assert torch.equal(x, y)


@pytest.mark.parametrize("stats_impl,params_impl", [
    ("tree", "tree"), ("flat", "flat"), ("flat", "tree"), ("tree", "flat")])
def test_resume_bit_identity_all_residencies(tmp_path, stats_impl, params_impl):
    kw = _job_kw(stats_impl=stats_impl, params_impl=params_impl)
    ref = run_training(TrainJob(**kw))
    d = str(tmp_path / "ck")
    run_training(TrainJob(**{**kw, "steps": 4, "checkpoint_dir": d}))
    assert latest_step(d) == 4
    resumed = run_training(TrainJob(**{**kw, "checkpoint_dir": d,
                                       "resume": True}))
    _assert_suffix_identical(resumed, ref, 4)
    _assert_params_identical(resumed["final_params"], ref["final_params"])


def test_resume_with_empty_dir_starts_fresh(tmp_path):
    kw = _job_kw(steps=2, eval_every=0,
                 checkpoint_dir=str(tmp_path / "empty"), resume=True)
    h = run_training(TrainJob(**kw))
    assert h["resumed_from"] is None and len(h["loss"]) == 2
    assert latest_step(kw["checkpoint_dir"]) == 2      # final save happened


def test_resume_requires_checkpoint_dir():
    with pytest.raises(ValueError, match="checkpoint-dir"):
        run_training(TrainJob(**_job_kw(resume=True)))


def test_resume_config_mismatch_is_loud(tmp_path):
    d = str(tmp_path / "ck")
    run_training(TrainJob(**_job_kw(steps=2, eval_every=0, checkpoint_dir=d)))
    with pytest.raises(ValueError, match="config mismatch.*data_seed"):
        run_training(TrainJob(**_job_kw(checkpoint_dir=d, resume=True,
                                        data_seed=7)))


def test_periodic_checkpoints_written_and_log_appends(tmp_path):
    d = str(tmp_path / "ck")
    log = str(tmp_path / "train.csv")
    kw = _job_kw(steps=6, eval_every=0, checkpoint_dir=d, checkpoint_every=2,
                 log_path=log)
    run_training(TrainJob(**{**kw, "steps": 4}))
    on_disk = {int(f[5:13]) for f in os.listdir(d) if f.endswith(".npz")}
    assert on_disk == {2, 4}
    lines_before = open(log).read().splitlines()
    run_training(TrainJob(**kw, resume=True))
    assert latest_step(d) == 6
    lines_after = open(log).read().splitlines()
    assert lines_after[:len(lines_before)] == lines_before
    assert len(lines_after) == 1 + 6   # header + one row per step


# ------------------------------------------------- SIGKILL + resume ----

_TRAIN_SNIPPET = """
import json, sys
import torch
torch.set_num_threads(2)
from repro_torch.launch.train import TrainJob, run_training
out_path = sys.argv[1]
h = run_training(TrainJob(**json.loads(sys.argv[2])))
json.dump({"loss": h["loss"], "global_batch": h["global_batch"],
           "samples": h["samples"], "var_l1": h["var_l1"],
           "val_loss": h["val_loss"], "resumed_from": h["resumed_from"]},
          open(out_path, "w"))
print("DONE")
"""


def _start(kw, out_path, faults=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("REPRO_FAULTS", None)
    if faults:
        env["REPRO_FAULTS"] = json.dumps(faults)
    return subprocess.Popen(
        [sys.executable, "-c", _TRAIN_SNIPPET, str(out_path), json.dumps(kw)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _finish(proc, out_path, expect_sigkill=False):
    out, err = proc.communicate(timeout=300)
    if expect_sigkill:
        assert proc.returncode == -9, (proc.returncode, err)
        return None
    assert proc.returncode == 0, f"train run failed:\n{out}\n{err}"
    return json.load(open(out_path))


@pytest.mark.parametrize("impl", ["tree", "flat"])
def test_sigkill_mid_run_resume_bit_identity(tmp_path, impl):
    """SIGKILL a run at step 6 (checkpoints every 2: the last complete one
    is 4), resume it, and demand bit-identity with an uninterrupted run in
    another process."""
    d = str(tmp_path / "ck")
    kw = _job_kw(params_impl=impl, stats_impl=impl, eval_every=0)
    victim = {**kw, "checkpoint_dir": d, "checkpoint_every": 2}
    ref_p = _start(kw, tmp_path / "ref.json")
    vic_p = _start(victim, tmp_path / "victim.json",
                   faults=[{"site": "train.step", "at": 6, "action": "die"}])
    _finish(vic_p, tmp_path / "victim.json", expect_sigkill=True)
    assert latest_step(d) == 4      # step-6 work died before any save
    res_p = _start({**victim, "resume": True}, tmp_path / "resumed.json")
    ref = _finish(ref_p, tmp_path / "ref.json")
    _assert_suffix_identical(_finish(res_p, tmp_path / "resumed.json"), ref, 4)


def test_sigkill_during_checkpoint_commit_keeps_previous(tmp_path):
    """A kill BETWEEN temp-write and rename (the torn-save window) leaves
    the previous checkpoint as latest; resume proceeds from it."""
    d = str(tmp_path / "ck")
    kw = _job_kw(steps=6, eval_every=0, checkpoint_dir=d, checkpoint_every=2)
    _finish(_start(kw, tmp_path / "victim.json",
                   faults=[{"site": "ckpt.save.before_commit", "at": 2,
                            "action": "die"}]),
            tmp_path / "victim.json", expect_sigkill=True)
    assert latest_step(d) == 2
    assert any(".tmp" in f for f in os.listdir(d))      # the torn save's litter
    resumed = _finish(_start({**kw, "resume": True}, tmp_path / "resumed.json"),
                      tmp_path / "resumed.json")
    assert resumed["resumed_from"] == 2 and len(resumed["loss"]) == 4
    assert latest_step(d) == 6
    assert not any(".tmp" in f for f in os.listdir(d))


# ------------------------------------- FSDP-Norm, two gloo ranks ----

FSDP = dict(step_impl="fsdp_norm", mesh_data=2, stats_impl="flat",
            params_impl="flat", steps=6, eval_every=3, eval_batches=1,
            base_accum=1, max_global_batch=16, max_micro_batch=4)


def test_fsdp_two_ranks_resume_bit_identity(tmp_path):
    """Two gloo ranks, flat residency: the param and moment shards are
    gathered into whole buffers on save (rank 0 writes) and each rank takes
    its own shard back on resume; the resumed run equals the uninterrupted
    one bit for bit."""
    kw = _job_kw(**FSDP)
    ref = run_training(TrainJob(**kw))
    d = str(tmp_path / "ck")
    run_training(TrainJob(**{**kw, "steps": 4, "checkpoint_dir": d,
                             "checkpoint_every": 2}))
    assert latest_step(d) == 4
    meta = json.load(open(os.path.join(d, "ckpt_00000004.json")))
    assert meta["flat_params"]["shard_divisor"] == 2
    resumed = run_training(TrainJob(**{**kw, "checkpoint_dir": d,
                                       "resume": True}))
    assert len(set(ref["global_batch"])) > 1           # the batch grew
    _assert_suffix_identical(resumed, ref, 4)
    _assert_params_identical(resumed["final_params"], ref["final_params"])


def test_embedding_gradient_same_bits_at_any_thread_count():
    """The table gradient of the token lookup is the same bits whatever the
    thread count: 65 536 looked-up elements with many repeated tokens, past
    the size where an indexing backward accumulates with parallel float
    atomics on the CPU (the fault that broke bit-exact resume across
    processes)."""
    from repro_torch.models.embeddings import embed_tokens
    gen = torch.Generator().manual_seed(0)
    table = torch.randn(64, 128, generator=gen)
    tokens = torch.randint(0, 64, (4, 128), generator=gen)
    upstream = torch.randn(4, 128, 128, generator=gen)

    def grad():
        t = table.clone().requires_grad_(True)
        out = embed_tokens({"table": t}, tokens, False, 128)
        return torch.autograd.grad(out, t, upstream)[0]

    before = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        want = grad()
        torch.set_num_threads(4)
        for _ in range(5):
            assert torch.equal(grad(), want)
    finally:
        torch.set_num_threads(before)


# --------------------------------------- dead peer: checkpoint and exit ----

_SURVIVOR_SNIPPET = """
import sys
from repro_torch.launch.train import TrainJob, run_training
rank, coord_dir, ckdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
job = TrainJob(arch="llama3.2-1b", schedule="stagewise",
               stages=((0.5, 4), (0.5, 8)), steps=12, total_samples=48,
               seq_len=16, base_global_batch=4, max_global_batch=8,
               base_micro_batch=2, max_micro_batch=2, base_accum=2,
               step_impl="accum_norm", eval_every=0, aot_warmup=True,
               coord="file", coord_dir=coord_dir, coord_rank=rank,
               coord_world=2, coord_timeout=60.0,
               checkpoint_dir=(ckdir if rank == 0 else ""), device="cpu")
run_training(job)
print("DONE")
"""


def test_dead_rank_surviving_rank_checkpoints_and_exits(tmp_path):
    """The reference's liveness scenario against the port: rank 1 is
    SIGKILLed by the fault harness at step 3; when rank 0 next needs the
    fleet (the rung-entry barrier of the stagewise 4 -> 8 increase at step
    7) it fails fast with a `CoordinationError` naming rank 1 as dead,
    after checkpointing its intact state at step 6."""
    coord, ck = str(tmp_path / "coord"), str(tmp_path / "ck")
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("REPRO_FAULTS", None)
    env["REPRO_COORD_HEARTBEAT_S"] = "0.1"
    env["REPRO_COORD_DEAD_AFTER_S"] = "2.0"
    env_dead = dict(env, REPRO_FAULTS=json.dumps(
        [{"site": "train.step", "at": 3, "action": "die"}]))
    procs = [subprocess.Popen([sys.executable, "-c", _SURVIVOR_SNIPPET, str(r),
                               coord, ck], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=e)
             for r, e in ((0, env), (1, env_dead))]
    out0, err0 = procs[0].communicate(timeout=300)
    _, err1 = procs[1].communicate(timeout=60)
    assert procs[1].returncode == -9, (procs[1].returncode, err1)
    assert procs[0].returncode not in (0, None), (out0, err0)
    assert "CoordinationError" in err0, err0
    assert "dead ranks" in err0 and "[1]" in err0, err0
    assert latest_step(ck) == 6, os.listdir(ck)
