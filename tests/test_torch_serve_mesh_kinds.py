"""Serving on a model axis for every layer kind, on the CPU: the port on 2
gloo ranks against the same port in one process.

* Every config on a (1, 2) mesh: `make_prefill` (last-token logits and the
  caches gathered from `cache_pspecs`'s layout), then 3 decode steps at
  scalar positions and 3 at per-row positions from a cache drawn from a
  seed: logits and the gathered cache within 1e-5 of one process's,
  relative to the largest magnitude (attention with its kv heads sharded
  or, for one kv head, whole; softcap, windows and rings, qk-norm; MoE;
  MLA; SSD; RG-LRU; cross-attention; a vocab-sharded table, whose logits
  come out whole).
* Prefill with one kv head on (1, 2) returns the cache's (b, t, 1, d), not
  the per-q-head expansion the attention reads.
* The sequence-sharded long cache (8192 positions: attention with one kv
  head, and MLA's latents): prefill cuts the rank's positions, and decode
  steps write where the position falls and combine the ranks' partial
  softmaxes, within 1e-5 of one process.
* Awkward rungs and compaction: the engine on 2 × 1 with rungs 1 and 3 (b
  mod J != 0), compaction across the data ranks, and a pool of 3 slots
  that J = 2 does not divide, against the one-process engine: tokens,
  traces and the pool exactly; `move_slot` / `reset_slot` across ranks.
* `run_serving`'s `on_logits` on 1 × 2 and 2 × 1 sees one process's
  logits of the rank's rows.
* A grid the process group does not fill is refused."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.distributed import serve_step as ss
from repro_torch.distributed.params import cache_pspecs, gather_tree
from repro_torch.distributed.serve_engine import ServeEngine
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.serve import run_continuous_serving, run_serving
from repro_torch.models.model import build_model
from repro_torch.tree import tree_leaves, tree_map

TIMEOUT_S = 300
TOL = 1e-5
ARCHS = ("llama3.2-1b", "microllama-300m", "tinyllama-1.1b", "openllama-3b",
         "gemma2-27b", "nemotron-4-15b", "phi3-mini-3.8b", "dbrx-132b",
         "deepseek-v2-236b", "mamba2-370m", "recurrentgemma-9b", "whisper-base",
         "internvl2-1b")
B, T, CACHE = 2, 8, 16
LONG = 8192


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _config(arch):
    cfg = get_smoke_config(arch)
    if cfg.moe is not None:       # a capacity where no pair drops
        cfg = cfg.replace(moe=type(cfg.moe)(**{**cfg.moe.__dict__, "capacity_factor": 8.0}))
    return cfg


def _inputs(cfg, seed):
    gen = _gen(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, T), generator=gen)}
    if cfg.frontend.kind == "vision_stub":
        batch["patch_embeds"] = torch.randn((B, cfg.frontend.num_prefix_tokens,
                                             cfg.d_model), generator=gen)
    elif cfg.frontend.kind == "audio_stub":
        batch["frames"] = torch.randn((B, cfg.encoder.num_frames, cfg.d_model),
                                      generator=gen)
    return batch


def _cache(model, length, seed):
    """A decode cache of `length` positions drawn from a seed (recurrent
    states too), as a prefill would leave one."""
    cache = model.init_cache(B, length, device="cpu")
    gen = _gen(seed)
    return tree_map(lambda x: 0.5 * torch.randn(x.shape, generator=gen).to(x.dtype), cache)


def _steps(length):
    """(tokens seed, pos) of the decode steps: 3 at scalar positions, 3 at
    per-row positions (the rows apart, one past the middle)."""
    half = length // 2
    return ([(i, half - 2 + i) for i in range(3)]
            + [(3 + i, torch.tensor([i + 1, half + 1 + i])) for i in range(3)])


def _serve(cfg, mesh, length, seed, prefill=True):
    """Prefill's logits and caches, then the decode steps' logits and the
    final cache, on `mesh` (this rank's slices, gathered whole) or in one
    process."""
    model = build_model(cfg)
    params = model.init(seed, "cpu")
    batch = _inputs(cfg, seed + 1)
    whole = _cache(model, length, seed + 2)
    cache_like = model.init_cache(B, length, device="meta")
    if mesh is None:
        run, step, cache = ss.make_prefill(model), ss.make_decode_step(model), whole
    else:
        wrap, p_specs = ss.make_prefill(model, mesh, batch=B)
        run = wrap(batch)
        params = ss.param_slices(params, p_specs, mesh)
        step = ss.make_decode_step(model, mesh, batch=B)[0](cache_like)
        specs = cache_pspecs(cache_like, mesh, batch_divisible=True)
        cache = tree_map(lambda x: x.contiguous(), ss.shard_tree(whole, specs, mesh))
    out = {}
    if prefill:
        logits, caches = run(params, batch)
        if mesh is not None:
            t = T + batch.get("patch_embeds", torch.empty(0, 0)).shape[1]
            caches = _gather_prefill(caches, cfg, mesh, t)
        out["prefill"] = (logits, caches)
    decode = []
    for s, pos in _steps(length):
        tokens = torch.randint(0, cfg.vocab_size, (B,), generator=_gen(100 + s))
        logits, cache = step(params, cache, tokens, pos)
        decode.append(logits)
    if mesh is not None:
        cache = gather_tree(cache, specs, mesh)
    out["decode"], out["cache"] = decode, cache
    return out


def _gather_prefill(caches, cfg, mesh, t):
    """Prefill's caches over t positions whole: each layer's specs from
    its whole shapes."""
    out = []
    for c in caches:
        if c is not None:
            like = {}
            for k, x in c.items():
                shape = list(x.shape)
                if k in ("k", "v", "cross_k", "cross_v"):
                    shape[2] = cfg.num_kv_heads
                if k in ("k", "v", "c_kv", "k_rope"):
                    shape[1] = t
                like[k] = torch.empty(shape, device="meta")
            specs = cache_pspecs([like], mesh, batch_divisible=True)[0]
            c = gather_tree({k: x.contiguous() for k, x in c.items()}, specs, mesh)
        out.append(c)
    return out


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _errors(got, want) -> dict:
    """The largest relative error of each part."""
    err = {"decode_logits": max(_rel(a, b) for a, b in zip(got["decode"], want["decode"])),
           "decode_cache": max(_rel(a, b) for a, b in zip(tree_leaves(got["cache"]),
                                                          tree_leaves(want["cache"])))}
    if "prefill" in want:
        (gl, gc), (wl, wc) = got["prefill"], want["prefill"]
        err["prefill_logits"] = _rel(gl, wl)
        err["prefill_cache"] = max([_rel(a, b) for x, y in zip(gc, wc) if y is not None
                                    for a, b in zip(tree_leaves(x), tree_leaves(y))],
                                   default=0.0)
        err["shapes"] = [[tuple(v.shape) for v in tree_leaves(c)] if c else None for c in gc] == \
            [[tuple(v.shape) for v in tree_leaves(c)] if c else None for c in wc]
    return err


LONG_CASES = {"attention": ("llama3.2-1b", dict(num_kv_heads=1, num_layers=1)),
              "mla": ("deepseek-v2-236b", dict(num_layers=1))}


def _long_config(case):
    arch, kw = LONG_CASES[case]
    return _config(arch).replace(**kw)


def _rank_kinds():
    mesh = tmesh.make_host_mesh(data=1, model=2)
    out = {arch: _serve(_config(arch), mesh, CACHE, 3) for arch in ARCHS}
    kv1 = _config("llama3.2-1b").replace(num_kv_heads=1)
    out["kv1"] = _serve(kv1, mesh, CACHE, 5)
    for case in LONG_CASES:
        out[f"long-{case}"] = _serve(_long_config(case), mesh, LONG, 9, prefill=False)
    return out


@pytest.fixture(scope="module")
def kinds():
    return tmesh.spawn_workers(_rank_kinds, 2, timeout_s=TIMEOUT_S)


def _check(got, want):
    err = _errors(got, want)
    assert err.pop("shapes", True), "prefill's caches are not the cache's shapes"
    assert max(err.values()) <= TOL, err


@pytest.mark.parametrize("arch", ARCHS)
def test_config_serves_on_a_model_axis_as_one_process(kinds, arch):
    _check(kinds[arch], _serve(_config(arch), None, CACHE, 3))


def test_prefill_returns_the_cache_of_one_kv_head(kinds):
    """With kv heads that do not divide the axis the rank returns the
    cache's (b, t, kv_heads, d), not the expansion its q heads read."""
    got = kinds["kv1"]
    _check(got, _serve(_config("llama3.2-1b").replace(num_kv_heads=1), None, CACHE, 5))
    assert all(c["k"].shape == (B, T, 1, 32) for c in got["prefill"][1])


@pytest.mark.parametrize("case", list(LONG_CASES))
def test_sequence_sharded_long_cache_decodes_as_one_process(kinds, case):
    _check(kinds[f"long-{case}"], _serve(_long_config(case), None, LONG, 9, prefill=False))


def _rank_long_prefill():
    """A prefill of 8192 tokens with one kv head on (1, 2): the rank's half
    of the positions, returned as they are, and the decode steps' logits on
    the cache it gives (each rank writes the half it holds)."""
    mesh = tmesh.make_host_mesh(data=1, model=2)
    cfg = _long_config("attention")
    model = build_model(cfg)
    params = model.init(11, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, LONG), generator=_gen(12))
    wrap, p_specs = ss.make_prefill(model, mesh, batch=1)
    logits, caches = wrap()(ss.param_slices(params, p_specs, mesh), {"tokens": tokens})
    return logits, [{k: x.contiguous() for k, x in c.items()} for c in caches]


def test_long_prefill_cuts_the_positions():
    got = tmesh.spawn_workers(_rank_long_prefill, 2, timeout_s=TIMEOUT_S)
    cfg = _long_config("attention")
    model = build_model(cfg)
    tokens = torch.randint(0, cfg.vocab_size, (1, LONG), generator=_gen(12))
    logits, caches = ss.make_prefill(model)(model.init(11, "cpu"), {"tokens": tokens})
    assert _rel(got[0], logits) <= TOL
    for c, w in zip(got[1], caches):
        for k in ("k", "v"):
            assert c[k].shape == (1, LONG // 2, 1, 32)       # rank 0's half
            assert _rel(c[k], w[k][:, :LONG // 2]) <= TOL


# ------------------------------------------------------ the slot pool ----

ENGINE = dict(max_slots=4, cache_len=12, ladder=(1, 3, 4))


def _drive(eng, vocab):
    """Five requests, the first to finish in slot 0 (backfilled from slot
    3, across the data ranks), then one alone (rung 1) and two joining it
    (rung 3).  Returns the tokens and the rung trace."""
    r = np.random.RandomState(1)
    prompts = [r.randint(0, vocab, size=(r.randint(1, 4),)).astype(np.int32)
               for _ in range(7)]
    trace, reqs = [], []

    def drain():
        while (report := eng.step()) is not None:
            trace.append(report["rung"])

    reqs += [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts[:4], (1, 5, 3, 4))]
    drain()
    reqs.append(eng.submit(prompts[4], max_new_tokens=8))
    drain()
    reqs += [eng.submit(p, max_new_tokens=4) for p in prompts[5:7]]
    drain()
    return [r.generated for r in reqs], trace


def _pool_primitives(mesh, spread):
    """Rows numbered by slot in a pool of 4, then slot 3 over 0 (across the
    data ranks when spread), 2 over 1, and slot 2 zeroed; the pool gathered."""
    model = build_model(_config("llama3.2-1b"))
    like = model.init_cache(4, 6, device="meta")
    if mesh is None:
        cache = model.init_cache(4, 6, device="cpu")
        rows = torch.arange(4.0)
    else:
        specs = cache_pspecs(like, mesh, batch_divisible=True)
        cache = ss.local_cache(like, specs, mesh, "cpu", rows=2)
        rows = torch.arange(4.0)[tmesh.worker_index(mesh)::2]
    for x in tree_leaves(cache):
        x.copy_(rows.view(-1, *[1] * (x.dim() - 1)).expand_as(x))
    slot_mesh = mesh if spread else None
    ss.move_slot(cache, 3, 0, slot_mesh)
    ss.move_slot(cache, 2, 1, slot_mesh)
    ss.reset_slot(cache, 2, slot_mesh)
    return cache if mesh is None else ss.gather_slots(cache, specs, mesh)


def _rank_pool():
    cfg = _config("llama3.2-1b")
    model = build_model(cfg)
    params = model.init(2, "cpu")
    out = {}
    for d, m in ((2, 1), (1, 2)):
        mesh = tmesh.make_host_mesh(data=d, model=m)
        for slots in (4, 3):
            eng = ServeEngine(model, params, mesh, **dict(ENGINE, max_slots=slots,
                                                          ladder=(1, 3, slots)))
            tokens, trace = _drive(eng, cfg.vocab_size)
            out[f"{d}x{m}/{slots}"] = (tokens, trace, eng.stats.slot_moves,
                                       eng.gathered_cache())
    out["primitives"] = _pool_primitives(tmesh.make_host_mesh(data=2, model=1), True)
    for d, m in ((1, 2), (2, 1)):
        seen = []
        res = run_serving("llama3.2-1b", params=params, mesh_data=d, mesh_model=m,
                          on_logits=lambda i, logits: seen.append((i, logits)), **SERVE)
        out[f"logits-{d}x{m}"] = (res["tokens"], seen)
    for name, kw in (("serve", dict(batch=2, prompt_len=3, gen_len=2)),
                     ("continuous", dict(max_slots=2, prompt_len=2, gen_len=2,
                                         load_steps=2))):
        driver = run_serving if name == "serve" else run_continuous_serving
        try:
            driver("llama3.2-1b", device="cpu", mesh_data=2, mesh_model=2, **kw)
        except ValueError as e:
            out[f"refused-{name}"] = str(e)
    return out


@pytest.fixture(scope="module")
def pool():
    return tmesh.spawn_workers(_rank_pool, 2, timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("case", ["2x1/4", "2x1/3", "1x2/4", "1x2/3"])
def test_awkward_rungs_and_compaction_match_one_process(pool, case):
    """Rungs of 1 and 3 slots over J = 2 data ranks, rows that change rank
    on compaction, and a pool that J does not divide (3 slots, whole on
    both data ranks): the one-process engine's tokens, trace and pool."""
    slots = int(case.split("/")[1])
    cfg = _config("llama3.2-1b")
    model = build_model(cfg)
    eng = ServeEngine(model, model.init(2, "cpu"),
                      **dict(ENGINE, max_slots=slots, ladder=(1, 3, slots)))
    tokens, trace = _drive(eng, cfg.vocab_size)
    got_tokens, got_trace, moves, cache = pool[case]
    assert got_tokens == tokens and got_trace == trace
    assert 1 in trace and 3 in trace and moves == eng.stats.slot_moves > 0
    for a, b in zip(tree_leaves(cache), tree_leaves(eng.gathered_cache()), strict=True):
        assert _rel(a, b) <= TOL


def test_slot_moves_and_resets_across_data_ranks(pool):
    want = _pool_primitives(None, False)
    for a, b in zip(tree_leaves(pool["primitives"]), tree_leaves(want), strict=True):
        assert torch.equal(a, b)
    assert [float(x) for x in tree_leaves(want)[0][:, 0, 0, 0]] == [3.0, 2.0, 0.0, 3.0]


SERVE = dict(batch=4, prompt_len=4, gen_len=3)


@pytest.mark.parametrize("grid", ["1x2", "2x1"])
def test_run_serving_shows_each_steps_logits(pool, grid):
    """`run_serving`'s `on_logits` sees each step's logits of the rank's
    rows (the first data rank's block on 2 x 1), whole over the vocab
    on a model axis, as one process's run sees them; the same tokens."""
    model = build_model(_config("llama3.2-1b"))
    seen = []
    want = run_serving("llama3.2-1b", params=model.init(2, "cpu"),
                       on_logits=lambda i, logits: seen.append((i, logits)), **SERVE)
    tokens, got = pool[f"logits-{grid}"]
    assert (tokens == want["tokens"]).all()
    rows = SERVE["batch"] // int(grid[0])
    assert [i for i, _ in got] == [i for i, _ in seen] == list(range(6))
    for (_, a), (_, b) in zip(got, seen):
        assert a.shape == (rows, model.cfg.vocab_size) and _rel(a, b[:rows]) <= TOL


@pytest.mark.parametrize("driver", ["serve", "continuous"])
def test_a_grid_the_group_does_not_fill_is_refused(pool, driver):
    assert "needs 4 ranks, the process group has 2" in pool[f"refused-{driver}"]
