"""The port's dry-run (`repro_torch/launch/{dryrun,roofline}.py`) on the
CPU: the roofline arithmetic against the reference's (`wire_bytes`, the
one-second identities with the H100 constants, `model_flops_per_step`),
the kernels' fake implementations against their plain versions, the
collective tally of a fake 4-rank trace against a real 4-rank gloo run of
the same step, the traced kernel calls of every config's forward, and
`lower_combo` / `main` at full size in a subprocess.

Every trace here is on fake CPU tensors: in a torch built without CUDA a
backward on fake CUDA tensors aborts the process, so the card's route
(fake CUDA tensors through the kernels' custom ops) is traced only on the
card (chip_smoke.py's `dryrun` phase)."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from conftest import REPO
from repro.configs import get_config as jget_config
from repro.configs.shapes import INPUT_SHAPES as J_SHAPES
from repro.launch import roofline as jroofline
from repro_torch.configs import ALL_ARCHS, ASSIGNED_ARCHS, get_config, get_smoke_config
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape, train_inputs
from repro_torch.data.pipeline import MarkovTokens, make_batch
from repro_torch.core.schedule import BatchPlan
from repro_torch.distributed.sharding import shard_flat_buffers
from repro_torch.distributed.train_step import batch_to_device, make_fsdp_norm_step
from repro_torch.kernels import fused_adamw as fa
from repro_torch.kernels import fused_stats as fs
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import attended_pairs, flash_attention_op
from repro_torch.kernels.rmsnorm import rmsnorm_op
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWConfig, init_adamw_flat
from repro_torch.tree import tree_leaves

sys.path.insert(0, REPO)
from chip_smoke import forward_kernel_launches  # noqa: E402

TIMEOUT_S = 300
HYPER = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1)


# ------------------------------------------------------------ roofline ----

_HLO = """
  %ar = f32[1024]{0} all-reduce(%x), channel_id=1
  %ag.1 = bf16[64,64]{1,0} all-gather(%y), dimensions={0}
  %rs = f32[32]{0} reduce-scatter(f32[512]{0} %z), dimensions={0}
  %a2a = bf16[8,16]{1,0} all-to-all(%w), dimensions={0}
  %cp = f32[128]{0} collective-permute(%u), source_target_pairs={{0,1}}
"""


def test_wire_bytes_of_one_tally_equals_the_references():
    """The reference's HLO tally and the same tally as the port's (its
    byte counts, the group sizes and links beside them): one wire-byte
    count, with the reference's per-kind factors."""
    ref = jroofline.parse_collectives(_HLO)
    port = roofline.empty_collectives()
    for kind, entry in ref.items():
        port[kind].update(entry, group_sizes=[16])
        port[kind]["by_link"]["infiniband"].update(
            result_bytes=entry["result_bytes"], operand_bytes=entry["operand_bytes"])
    assert roofline.wire_bytes(port) == jroofline.wire_bytes(ref) > 0
    assert roofline.wire_bytes(ref) == jroofline.wire_bytes(ref)
    assert roofline.wire_bytes_by_link(port) == {
        "nvlink": 0.0, "infiniband": jroofline.wire_bytes(ref)}


def test_roofline_terms_one_second_identities_on_the_h100():
    rl = roofline.roofline_terms({"flops": roofline.PEAK_BF16,
                                  "bytes accessed": roofline.HBM_BW}, None, 0.0)
    assert rl.compute_s == pytest.approx(1.0) and rl.memory_s == pytest.approx(1.0)
    assert rl.collective_s == 0 and rl.bottleneck in ("compute", "memory")
    for cls, peak in (("bfloat16", 989.4e12), ("float32", 66.9e12),
                      ("split_tf32", 494.7e12 / 3)):
        rl = roofline.roofline_terms({"flops": peak, "flops_by_class": {cls: peak}})
        assert rl.compute_s == pytest.approx(1.0) and rl.bottleneck == "compute"
    coll = roofline.empty_collectives()
    coll["all-reduce"]["result_bytes"] = roofline.IB_BW / 2      # 2× result
    coll["all-reduce"]["by_link"]["infiniband"]["result_bytes"] = roofline.IB_BW / 2
    coll["all-gather"]["result_bytes"] = roofline.NVLINK_BW
    coll["all-gather"]["by_link"]["nvlink"]["result_bytes"] = roofline.NVLINK_BW
    rl = roofline.roofline_terms({"flops": 0.0, "bytes accessed": 0.0}, coll)
    assert rl.collective_s == pytest.approx(2.0) and rl.bottleneck == "collective"
    assert (roofline.HBM_BW, roofline.NVLINK_BW, roofline.IB_BW, roofline.CARD_BYTES) \
        == (3.35e12, 450e9, 50e9, 80e9)
    # ranks row-major over (pod, data, model), 8 consecutive ranks a node
    assert roofline.link_of(range(8)) == roofline.link_of(range(8, 16)) == "nvlink"
    assert roofline.link_of(range(16)) == "infiniband"            # a model line
    assert roofline.link_of(range(0, 256, 16)) == "infiniband"    # a data line
    with pytest.raises(KeyError, match="float64"):
        roofline.compute_seconds({"float64": 1.0})


def test_model_flops_per_step_equals_the_references():
    for arch in ASSIGNED_ARCHS:
        for shape in INPUT_SHAPES:
            for n in (256, 512):
                assert roofline.model_flops_per_step(
                    get_config(arch), INPUT_SHAPES[shape], n) == \
                    jroofline.model_flops_per_step(jget_config(arch), J_SHAPES[shape], n)


# ------------------------------------------------ the kernels' fake ops ----

def _mutated(op) -> set:
    return {a.name for a in op._opoverload._schema.arguments
            if a.alias_info is not None and a.alias_info.is_write}


def test_fake_implementations_match_the_plain_versions():
    """Each custom op's fake implementation, on fake CPU tensors, gives the
    output shapes and dtypes its plain version gives on real tensors and
    the launches the card would make, and the op declares mutated exactly
    the operands the plain version writes in place; nothing launches or
    counts."""
    g = torch.Generator().manual_seed(0)
    sizes, dts = (37, 4096, 5), (torch.float32, torch.bfloat16, torch.float32)

    def bufs(dtypes):
        return [torch.randn(n, generator=g).to(dt) for n, dt in zip(sizes, dtypes)]

    pb, gb = bufs(dts), bufs(dts)
    mb, vb = bufs([torch.float32] * 3), [b.abs() for b in bufs([torch.float32] * 3)]
    before = [[x.clone() for x in lst] for lst in (pb, gb, mb, vb)]
    kw = dict(lr=1e-3, c1=0.1, c2=0.05, **HYPER)
    want_gsq = ops.adamw_flat_buckets(pb, gb, mb, vb, clip_scale=1.0, **kw)
    changed = [any(not torch.equal(a, b) for a, b in zip(now, was))
               for now, was in zip((pb, gb, mb, vb), before)]
    assert changed == [True, False, True, True]
    want_stats = ops.stats_flat_buckets(gb, mb)
    want_sq = ops.sqdiff_norm_tree(gb, mb)
    x = torch.randn(3, 7, 64, generator=g)
    want_norm = ops.rmsnorm(x, torch.ones(64))
    q, k = torch.randn(2, 9, 4, 16, generator=g), torch.randn(2, 11, 2, 16, generator=g)
    want_flash = ops.flash_attention(q, k, k, causal=False)
    assert _mutated(fa.fused_adamw_stats_op) == _mutated(fa.fused_adamw_op) == \
        {"pb", "mb", "vb"}
    for op in (fs.fused_stats_op, fs.sqdiff_norm_op, rmsnorm_op, flash_attention_op):
        assert _mutated(op) == set()
    before = ops.launch_counts()
    with FakeTensorMode() as mode:
        f = lambda lst: [mode.from_tensor(t) for t in lst]
        scal = [mode.from_tensor(torch.tensor(v)) for v in (1e-3, 0.1, 0.05, 1.0)]
        gsq, n_stats = fa.fused_adamw_stats_op(f(pb), f(gb), f(mb), f(vb), scal,
                                               *HYPER.values())
        n_tree = fa.fused_adamw_op(f(pb), f(gb), f(mb), f(vb), scal, *HYPER.values())
        stats, n_pair = fs.fused_stats_op(f(gb), f(mb))
        sq, n_sq = fs.sqdiff_norm_op(f(gb), f(mb))
        norm = rmsnorm_op(mode.from_tensor(x), mode.from_tensor(torch.ones(64)), 1e-6)
        flash = flash_attention_op(*(mode.from_tensor(t) for t in (q, k, k)),
                                   False, 0, 0.0)
    sig = lambda t: (tuple(t.shape), t.dtype)
    # the launches each op stands for: one per dtype group of its operands
    assert n_stats == n_tree == n_pair == n_sq == 2
    assert sig(gsq) == sig(want_gsq) == ((), torch.float32)
    assert sig(stats) == ((2,), torch.float32) and all(
        sig(w) == ((), torch.float32) for w in (*want_stats, want_sq))
    assert sig(sq) == ((1,), torch.float32)
    assert sig(norm) == sig(want_norm) and sig(flash) == sig(want_flash)
    assert ops.launch_counts() == before


def test_flash_flop_formula_counts_the_admitted_pairs():
    """4·d a (query, key) pair the masks admit: PERF.md §6's 68.7 GFLOP
    at b 4, t 2048, 32 heads, d 64, causal; the window and non-causal
    masks as `ref.attention_ref` builds them."""
    from torch.utils.flop_counter import FlopCounterMode
    assert 4 * 64 * 4 * 32 * attended_pairs(2048, 2048, True, 0) == 68_753_031_168
    for t, s, causal, window in ((7, 9, True, 0), (7, 9, False, 3), (9, 7, True, 4),
                                 (5, 5, False, 0)):
        qpos, kpos = torch.arange(t)[:, None], torch.arange(s)[None, :]
        mask = torch.ones(t, s, dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        assert attended_pairs(t, s, causal, window) == int(mask.sum())
    with FakeTensorMode():
        q, k = torch.empty(2, 9, 4, 16), torch.empty(2, 9, 2, 16)
        with FlopCounterMode(display=False) as fc:
            flash_attention_op(q, k, k, True, 4, 0.0)
    assert fc.get_total_flops() == 4 * 16 * 2 * 4 * attended_pairs(9, 9, True, 4)


# ------------------------------------------------------------- traces ----

def test_bytes_accessed_count_what_ops_move():
    """The tally's bytes: a product reads its operands and writes its
    result; an in-place op reads and writes its operand once each; views,
    allocations and metadata reads (`prim.device`) move nothing; a lookup
    reads the rows it returns, not its whole table."""
    def moved(fn):
        with FakeTensorMode():
            a, b = torch.empty(64, 32), torch.empty(32, 16)
            table, idx = torch.empty(1000, 32), torch.zeros(8, dtype=torch.long)
            with dryrun.Trace() as tr:
                fn(a, b, table, idx)
        return tr.cost["bytes accessed"]

    f4 = 4
    assert moved(lambda a, b, t, i: a @ b) == f4 * (64 * 32 + 32 * 16 + 64 * 16)
    assert moved(lambda a, b, t, i: a.add_(a)) == f4 * 3 * 64 * 32
    assert moved(lambda a, b, t, i: (a.t(), a[3:], a.view(-1), a.device,
                                     torch.empty(5))) == 0
    assert moved(lambda a, b, t, i: torch.nn.functional.embedding(i, t)) == \
        8 * 8 + 2 * f4 * 8 * 32



PLAN = BatchPlan(global_batch=8, micro_batch=2, accum_steps=2, workers=2)
SEQ = 16


def _tally_only(kind):
    return {k: kind[k] for k in ("count", "result_bytes", "operand_bytes",
                                 "group_sizes", "by_link")}


def _real_grid_step(batch):
    """One rank of the smoke FSDP-Norm 2 × 2 flat step, run for real under
    the trace's tally (no fake tensors): rank 0's collective tally."""
    mesh = tmesh.make_host_mesh(data=2, model=2)
    cfg = get_smoke_config("microllama-300m")
    model = build_model(cfg)
    params = model.init(0, "cpu")
    wrap = make_fsdp_norm_step(model, AdamWConfig(), stats_impl="flat",
                               params_impl="flat", params_like=params, mesh=mesh)
    layout = wrap.flat_layout
    opt = init_adamw_flat(params, shard_divisor=2, layout=layout)
    params = tuple(shard_flat_buffers(layout.flatten(params), mesh))
    with dryrun.TraceTally() as tally:
        wrap(batch)(params, opt, batch_to_device(batch, "cpu"), 1e-4)
    return tally.collectives


def test_fake_trace_tallies_the_collectives_of_a_real_grid_step():
    """The collective tally of a fake 4-rank trace of the smoke FSDP-Norm
    2 × 2 flat step equals the tally of the same step run on 4 gloo ranks,
    rank 0's, by kind, count, bytes, group sizes and links."""
    batch = make_batch(MarkovTokens(vocab_size=512, seed=0), 0, PLAN, SEQ)
    real = tmesh.spawn_workers(_real_grid_step, 4, batch, timeout_s=TIMEOUT_S)
    like = {k: torch.empty(v.shape, dtype=torch.as_tensor(v).dtype, device="meta")
            for k, v in batch.items()}
    tmesh.init_fake_workers(4)
    try:
        mesh = tmesh.make_host_mesh(data=2, model=2)
        tr, expected = dryrun.trace_train(get_smoke_config("microllama-300m"), like,
                                          mesh, torch.device("cpu"))
    finally:
        dist.destroy_process_group()
    fake = tr.collectives
    assert {k: _tally_only(v) for k, v in fake.items()} == \
        {k: _tally_only(v) for k, v in real.items()}
    assert fake["all-reduce"]["count"] > 0 and fake["all-gather"]["count"] > 0
    assert tr.memory["params_bytes"] == expected > 0
    assert tr.kernel_calls["fused_stats"] == tr.kernel_calls["fused_adamw_stats"] == 1


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_traced_forward_kernel_calls(arch):
    """A no-grad forward (the eval loss) of each smoke config, traced on
    fake CPU tensors: its `ops.rmsnorm`, `ops.flash_attention` and
    `ops.dense` calls (here the einsum, each counted once) equal
    `forward_kernel_launches`, and every product is counted."""
    cfg = get_smoke_config(arch)
    model = build_model(cfg)
    like = model.init(device="meta")
    batch_like = {k: v[0] for k, v in
                  train_inputs(cfg, InputShape("t", 32, 2, "train")).items()}
    with FakeTensorMode(), dryrun.Trace() as tr:
        params = dryrun._fake(like, "cpu")
        tr.mark("params")
        batch = dryrun._fake(batch_like, "cpu")
        with torch.no_grad():
            model.loss(params, batch)
        tr.finish()
    want = forward_kernel_launches(cfg)
    assert {k: tr.kernel_calls[k] for k in want} == want
    assert tr.cost["flops"] > 0
    assert tr.memory["peak_bytes"] > tr.memory["params_bytes"] == sum(
        x.numel() * x.element_size() for x in tree_leaves(like))


_LOWER = """
import json, torch
from repro_torch.launch.dryrun import lower_combo, main
tr, rec = lower_combo("llama3.2-1b", "decode_32k", multi_pod=False, device="cpu")
rl, mem = rec["roofline"], rec["memory"]
assert rec["devices"] == 256 and rec["workers_J"] == 16, rec
assert rl["flops"] > 0 and rl["hbm_bytes"] > 0 and rl["wire_bytes"] > 0
assert rl["bottleneck"] in ("compute", "memory", "collective")
assert mem["params_bytes"] == mem["param_spec_bytes"] > 0 and mem["fits"]
assert rec["collectives"]["all-reduce"]["group_sizes"] == [16]
# --seqpar: FSDP-Norm train shapes only; the TP all-reduces of the model
# groups become reduce-scatters and all-gathers, and the layers' inputs
# kept for the backward pass are 1/16 of a sequence
_, sp = lower_combo("llama3.2-1b", "train_4k", multi_pod=False, device="cpu", seqpar=True)
_, whole = lower_combo("llama3.2-1b", "train_4k", multi_pod=False, device="cpu")
_, dec = lower_combo("llama3.2-1b", "decode_32k", multi_pod=False, device="cpu", seqpar=True)
assert sp["seqpar"] is True and whole["seqpar"] is False, (sp["seqpar"], whole["seqpar"])
assert rec["seqpar"] is False and dec["seqpar"] is False
rs, ag = sp["collectives"]["reduce-scatter"], sp["collectives"]["all-gather"]
assert rs["count"] > 0 and set(rs["group_sizes"]) == {16}, rs
assert whole["collectives"]["reduce-scatter"]["count"] == 0
assert ag["count"] > whole["collectives"]["all-gather"]["count"] and set(ag["group_sizes"]) == {16}
assert (sp["collectives"]["all-reduce"]["result_bytes"]
        < whole["collectives"]["all-reduce"]["result_bytes"])
assert sp["memory"]["peak_bytes"] < whole["memory"]["peak_bytes"], (
    sp["memory"]["peak_bytes"], whole["memory"]["peak_bytes"])
try:
    main(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--out", %(out)r])
except RuntimeError as e:
    assert torch.backends.cuda.is_built() is False and "--device cpu" in str(e)
else:
    raise AssertionError("a torch with no CUDA build traced for the card")
main(["--arch", "llama3.2-1b", "--shape", "decode_32k", "--device", "cpu",
      "--out", %(out)r])
print("LOWER_OK", json.dumps(rl["bottleneck"]))
"""

# the reference's record keys (src/repro/launch/dryrun.py `record`)
REF_KEYS = {"arch", "shape", "mesh", "step_impl", "devices", "workers_J",
            "compile_s", "memory", "cost", "collectives", "roofline",
            "params_total", "params_active"}


def test_lower_combo_and_main_write_the_record(subproc, tmp_path):
    """The reference's test_dryrun.py at full size on the CPU, in a
    subprocess (it joins a fake 256-rank group): the record's mesh and
    workers, non-zero cost, a bottleneck, parameter bytes equal to the
    specs' slices; llama3.2-1b train_4k `--seqpar` (reduce-scatters and
    more all-gathers on groups of 16, fewer all-reduce bytes, a lower peak
    than without it, the record's flag; decode ignores it); the CLI's record on disk with the
    reference's keys, and the card's route refused by a torch with no CUDA
    build."""
    out = subproc(_LOWER % dict(out=str(tmp_path)), timeout=TIMEOUT_S)
    assert "LOWER_OK" in out
    rec = json.loads(Path(tmp_path, "llama3.2-1b__decode_32k__16x16.json").read_text())
    assert REF_KEYS <= set(rec)
    assert rec["memory"]["params_bytes"] == rec["memory"]["param_spec_bytes"]
    assert np.isclose(rec["roofline"]["model_flops"],
                      jroofline.model_flops_per_step(jget_config("llama3.2-1b").replace(
                          dtype="bfloat16", param_dtype="bfloat16"),
                          J_SHAPES["decode_32k"], 256))
