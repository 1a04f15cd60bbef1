"""Serving launcher: a batched decode loop, and bursty open-loop load on the
continuous-batching engine (counterpart of `repro/launch/serve.py`).

Runs on the CUDA card unless the caller asks for the CPU (`device="cpu"`,
`--device cpu`); with no device given and no card present it raises.  On
the card both drivers replay their decode steps as CUDA graphs
(`serve_step.GraphedDecode`, the engine's rungs); on the CPU they run the
eager step.

On a data × model grid (`mesh_data`, `mesh_model`; `--mesh-data`,
`--mesh-model`) the drivers run as one process a rank, as `run_training`
does: outside a process group they spawn the ranks (under `torchrun`
they join its group), inside one they run as its rank, and a grid the
group does not fill is refused.  Each rank draws the whole params from the
seed and keeps its slices; every rank runs the same host logic, and rank
0's result is returned (its timings the slowest rank's).  Decode on a
model axis above 1 runs eagerly (`serve_step`).  On the card the ranks
share it through gloo (`dist_backend="gloo"`, `--dist-backend gloo`):
NCCL needs a card a rank.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch llama3.2-1b --batch 2 --prompt-len 8 --gen-len 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --continuous
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --mesh-data 2 --mesh-model 2 [--continuous]
    python -m repro_torch.launch.serve --full --batch 8 --prompt-len 128  # the card
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.serve_controller import ServeControllerConfig, serve_ladder
from repro_torch.distributed.serve_engine import QueueFullError, ServeEngine
from repro_torch.distributed.serve_step import (
    GraphedDecode, data_rows, local_cache, make_decode_step,
    make_slot_decode_step, param_slices)
from repro_torch.launch.mesh import (
    default_backend, host_max, init_workers, make_host_mesh, num_workers,
    rank_device, spawn_workers)
from repro_torch.models.common import resolve_device
from repro_torch.models.model import build_model
from repro_torch.tree import tree_leaves


def _sync(device: torch.device):
    """Wait for the device's queued work (the reference's block_until_ready)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _setup(arch, smoke, seed, device, params):
    """(cfg, model, params, device): params drawn from `seed` on `device`
    (a rank's card on a grid), unless given — then the device, and the
    depth, are theirs, and naming a device as well is an error."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if params is not None and device is not None:
        raise ValueError("pass `device` or `params`, not both: given "
                         "params serve on their own device")
    if params is None:
        device = resolve_device(device)
        if num_workers() > 1:
            device = rank_device(device, dist.get_rank())
        params = build_model(cfg).init(seed, device)
    cfg = cfg.replace(num_layers=len(params["layers"]))
    return cfg, build_model(cfg), params, tree_leaves(params)[0].device


def _rank(driver, kw):
    return driver(**kw)


def _grid(driver, kw: dict):
    """The driver's mesh inside a process group of its size: None for one
    rank; rank 0's result of spawned ranks outside a group (`torchrun`'s
    group joined when RANK is set); a group of another size is refused."""
    world = kw["mesh_data"] * kw["mesh_model"]
    if world > 1 and num_workers() == 1:
        device = kw["device"] if kw["params"] is None else tree_leaves(kw["params"])[0].device
        backend = kw["dist_backend"] or default_backend(resolve_device(device))
        if "RANK" not in os.environ:
            return None, spawn_workers(_rank, world, driver, kw, backend=backend)
        init_workers(backend, int(os.environ["RANK"]),    # under torchrun
                     int(os.environ["WORLD_SIZE"]), "env://")
    if num_workers() != world:
        raise ValueError(f"a {kw['mesh_data']} x {kw['mesh_model']} grid needs "
                         f"{world} ranks, the process group has {num_workers()}")
    mesh = (make_host_mesh(data=kw["mesh_data"], model=kw["mesh_model"])
            if world > 1 else None)
    return mesh, None


def _barrier(mesh):
    if mesh is not None:
        dist.barrier()


def _pct(lat, p):
    """The p-th percentile of the sorted latencies `lat` (0 when empty)."""
    return lat[min(len(lat) - 1, int(p / 100 * len(lat)))] if lat else 0.0


def run_serving(arch: str, *, smoke=True, batch=4, prompt_len=32, gen_len=32,
                mesh_data=1, mesh_model=1, seed=0, device=None, params=None,
                cuda_graphs=True, dist_backend=None, on_logits=None):
    """Prompts streamed through decode, then `gen_len` greedy tokens.

    On the card (unless `cuda_graphs` is False) the batch's decode step is
    one CUDA graph, captured before the clock starts, fed on the card (the
    next token and the position never visit the host) and replayed every
    step.  Elsewhere the eager step runs at a scalar position, as in the
    reference.

    A vision config's prompt budget holds its frontend's prefix tokens, so
    its text prompt is prompt_len minus those (the reference's budget); a
    budget they fill raises ValueError.  As in the reference, the stream
    carries no patch embeddings or encoder frames (an encoder-decoder's
    cross caches stay zero).  The first generated token falls out of the
    prompt phase; the timed decode loop emits gen_len - 1 tokens a
    sequence.  The device is synchronised before every clock read.
    Returns the generated tokens (batch, gen_len), the two phases' seconds
    and the decode rate.

    On a grid (module docstring) each data rank decodes its block of the
    batch (all of it when the batch does not divide the data axes) on its
    slices, a CUDA graph when the model axis is 1, and the tokens are
    gathered after the clock stops.

    `on_logits(i, logits)`, when given, sees each eager step i's logits of
    this rank's rows (an observer for checks; a graph returns only its
    tokens, so it needs the eager step)."""
    mesh, spawned = _grid(run_serving, dict(
        arch=arch, smoke=smoke, batch=batch, prompt_len=prompt_len,
        gen_len=gen_len, mesh_data=mesh_data, mesh_model=mesh_model, seed=seed,
        device=device, params=params, cuda_graphs=cuda_graphs,
        dist_backend=dist_backend, on_logits=on_logits))
    if spawned is not None:
        return spawned
    cfg, model, params, device = _setup(arch, smoke, seed, device, params)
    if prompt_len < 1:
        raise ValueError(f"prompt_len must be >= 1, got {prompt_len}")
    cache_len = prompt_len + gen_len
    rng = np.random.default_rng(seed)
    npfx = (cfg.frontend.num_prefix_tokens
            if cfg.frontend.kind == "vision_stub" else 0)
    text_len = prompt_len - npfx
    if text_len <= 0:
        raise ValueError(
            f"prompt_len={prompt_len} leaves no text tokens after the vision "
            f"frontend's {npfx} prefix tokens (text_len={text_len}); pass "
            f"prompt_len > {npfx}")
    prompts = rng.integers(0, cfg.vocab_size, (batch, text_len)).astype(np.int32)
    rows = slice(None) if mesh is None else data_rows(batch, mesh)
    prompts = torch.from_numpy(prompts[rows]).to(device)
    nb = prompts.shape[0]

    graphed = cuda_graphs and device.type == "cuda" and (
        mesh is None or mesh.model_size == 1)
    if graphed and on_logits is not None:
        raise ValueError("on_logits needs the eager step: pass cuda_graphs=False")
    if mesh is None:
        cache = model.init_cache(batch, cache_len, device=device)
        slot_step = make_slot_decode_step(model, max_slots=batch)(batch)
        step_fn = make_decode_step(model)
    else:
        cache_like = model.init_cache(batch, cache_len, device="meta")
        wrap, p_specs, specs = make_slot_decode_step(model, mesh, max_slots=batch)
        params = param_slices(params, p_specs, mesh)
        cache = local_cache(cache_like, specs(cache_like), mesh, device)
        slot_step = wrap(batch, cache_like)
        step_fn = make_decode_step(model, mesh, batch=batch)[0](cache_like)
    if graphed:
        graph = GraphedDecode(slot_step, params, cache, nb)
        pos = torch.zeros(nb, dtype=torch.int32, device=device)

        def next_token(tok, i):
            pos.fill_(i)
            return graph(params, cache, tok, pos)[0].clone()
    else:
        def next_token(tok, i):
            logits, _ = step_fn(params, cache, tok, i)
            if on_logits is not None:
                on_logits(i, logits)
            return torch.argmax(logits, -1).to(torch.int32)

    # "prefill" by streaming the prompt through decode (the cache stays
    # shape-stable; `make_prefill` is the full-sequence prefill)
    _barrier(mesh)
    _sync(device)
    t0 = time.time()
    tok = prompts[:, 0]
    for i in range(text_len):
        nxt = next_token(tok, i)
        tok = prompts[:, i + 1] if i + 1 < text_len else nxt
    _sync(device)
    t_prefill = host_max(time.time() - t0)

    generated = [tok]
    _barrier(mesh)
    _sync(device)
    t0 = time.time()
    for i in range(text_len, text_len + gen_len - 1):
        tok = next_token(tok, i)
        generated.append(tok)
    _sync(device)
    t_decode = host_max(time.time() - t0)

    out = torch.stack(generated, dim=1).cpu()
    if mesh is not None and nb < batch:          # the data ranks' blocks
        parts = [torch.empty_like(out) for _ in range(batch // nb)]
        dist.all_gather(parts, out, group=mesh.data_group)
        out = torch.cat(parts)
    out = out.numpy()
    decode_tokens = batch * (gen_len - 1)
    toks_per_s = decode_tokens / max(t_decode, 1e-9) if decode_tokens else 0.0
    return {"tokens": out, "prefill_s": t_prefill, "decode_s": t_decode,
            "decode_tokens_timed": decode_tokens,
            "decode_tok_per_s": toks_per_s}


def run_continuous_serving(arch: str, *, smoke=True, max_slots=8,
                           prompt_len=4, gen_len=8, load_steps=60,
                           arrival_rate=0.5, burst_every=20, burst_size=5,
                           mesh_data=1, mesh_model=1, seed=0, latency_slo_s=0.0,
                           aot_warmup=True, max_queue=0, device=None,
                           params=None, dist_backend=None):
    """Bursty open-loop load against the continuous-batching engine.

    Arrivals: Poisson at `arrival_rate` requests per engine step, plus a
    burst of `burst_size` every `burst_every` steps, for `load_steps` steps;
    then the backlog drains.  After the load phase, a steady-state probe:
    with every rung built, a fresh burst forces a rung change, which must
    be served from a built rung — a transition hit with ZERO new builds.

    Returns sustained req/s, p50/p99 request latency, decode tok/s, the
    engine counters, the rung trace and the probe verdict.  As in the
    reference, those rates divide every request and token, the probe's
    included, by the load window's seconds; `load` holds the same figures
    for the load window's own requests and tokens.  On a grid (module
    docstring) the engine takes the mesh, and the window's seconds are the
    slowest rank's."""
    mesh, spawned = _grid(run_continuous_serving, dict(
        arch=arch, smoke=smoke, max_slots=max_slots, prompt_len=prompt_len,
        gen_len=gen_len, load_steps=load_steps, arrival_rate=arrival_rate,
        burst_every=burst_every, burst_size=burst_size, mesh_data=mesh_data,
        mesh_model=mesh_model, seed=seed, latency_slo_s=latency_slo_s,
        aot_warmup=aot_warmup, max_queue=max_queue, device=device,
        params=params, dist_backend=dist_backend))
    if spawned is not None:
        return spawned
    cfg, model, params, device = _setup(arch, smoke, seed, device, params)
    engine = ServeEngine(
        model, params, mesh, max_slots=max_slots, cache_len=prompt_len + gen_len,
        controller=ServeControllerConfig(ladder=serve_ladder(max_slots),
                                         latency_slo_s=latency_slo_s),
        aot_warmup=aot_warmup, max_queue=max_queue)
    del params               # a grid's engine keeps its slices
    rng = np.random.default_rng(seed)

    def submit_one():
        prompt = rng.integers(0, cfg.vocab_size, (prompt_len,)).astype(np.int32)
        try:
            engine.submit(prompt, max_new_tokens=gen_len)
        except QueueFullError:
            pass    # open-loop load-shed: counted in stats.requests_rejected

    completed = []
    rung_trace = []
    _barrier(mesh)
    _sync(device)
    t_start = time.time()
    for i in range(load_steps):
        n = rng.poisson(arrival_rate)
        if burst_every and i % burst_every == 0:
            n += burst_size
        for _ in range(n):
            submit_one()
        report = engine.step()
        if report is not None:
            completed.extend(report["completed"])
            rung_trace.append(report["rung"])
    completed.extend(engine.run_until_drained())
    _sync(device)
    wall_s = max(host_max(time.time() - t_start), 1e-9)
    # the load window alone: the reference's keys below also count the
    # probe's requests and tokens, served after the clock stopped
    load_lat = sorted(r.latency_s for r in completed)
    load = {"requests_completed": len(load_lat),
            "req_per_s": len(load_lat) / wall_s,
            "p50_latency_s": _pct(load_lat, 50),
            "p99_latency_s": _pct(load_lat, 99),
            "decode_tok_per_s": engine.stats.tokens_generated / wall_s}

    # ---- steady-state probe: a rung change must hit a built step ----
    engine.warm(engine.ladder)
    engine.drain(raise_errors=False)        # every warm-up has landed
    compiles0 = engine.stats.compiles
    trans0 = engine.stats.rung_transitions
    hits0 = engine.stats.transition_hits
    probe_burst = min(max_slots, engine.current_rung * 2)
    if engine.current_rung >= max_slots:    # already at top: force a shrink
        probe_burst = 1
    for _ in range(probe_burst):
        submit_one()
    completed.extend(engine.run_until_drained())
    probe = {
        "rung_transitions": engine.stats.rung_transitions - trans0,
        "transition_hits": engine.stats.transition_hits - hits0,
        "new_compiles": engine.stats.compiles - compiles0,
    }
    probe["steady_state_transition_hit"] = bool(
        probe["rung_transitions"] >= 1
        and probe["transition_hits"] == probe["rung_transitions"]
        and probe["new_compiles"] == 0)

    lat = sorted(r.latency_s for r in completed)
    stats = engine.stats
    return {
        "requests_completed": len(lat),
        "sustained_req_per_s": len(lat) / wall_s,
        "p50_latency_s": _pct(lat, 50),
        "p99_latency_s": _pct(lat, 99),
        "decode_tok_per_s": stats.tokens_generated / wall_s,
        "wall_s": wall_s,
        "load": load,
        "rung_trace": rung_trace,
        "probe": probe,
        "engine": stats.as_dict(),
    }


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="llama3.2-1b")
    p.add_argument("--full", action="store_true",
                   help="the published widths (default: the smoke config)")
    p.add_argument("--device", default="",
                   help="'' = the CUDA card (raises without one); or 'cpu'")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=32)
    p.add_argument("--gen-len", type=int, default=32)
    p.add_argument("--continuous", action="store_true",
                   help="bursty open-loop load on the continuous-batching "
                        "tier instead of the fixed-batch decode loop")
    p.add_argument("--max-slots", type=int, default=8)
    p.add_argument("--load-steps", type=int, default=60)
    p.add_argument("--arrival-rate", type=float, default=0.5)
    p.add_argument("--burst-every", type=int, default=20)
    p.add_argument("--burst-size", type=int, default=5)
    p.add_argument("--max-queue", type=int, default=0,
                   help="reject submits once this many requests wait "
                        "(0 = unbounded)")
    p.add_argument("--mesh-data", type=int, default=1,
                   help="data ranks: the batch's rows, the engine's slots")
    p.add_argument("--mesh-model", type=int, default=1,
                   help="tensor-parallel ranks of each data rank")
    p.add_argument("--dist-backend", default="",
                   help="'' = NCCL on the card (a card a rank), gloo on the "
                        "CPU; 'gloo' lets ranks share the card")
    args = p.parse_args(argv)
    device = args.device or None
    grid = dict(mesh_data=args.mesh_data, mesh_model=args.mesh_model,
                dist_backend=args.dist_backend or None)
    if args.continuous:
        res = run_continuous_serving(
            args.arch, smoke=not args.full, max_slots=args.max_slots,
            prompt_len=args.prompt_len, gen_len=args.gen_len,
            load_steps=args.load_steps, arrival_rate=args.arrival_rate,
            burst_every=args.burst_every, burst_size=args.burst_size,
            max_queue=args.max_queue, seed=args.seed, device=device, **grid)
        load = res["load"]
        print(f"served {load['requests_completed']} requests under load: "
              f"{load['req_per_s']:.2f} req/s, "
              f"p50 {load['p50_latency_s']:.3f}s p99 {load['p99_latency_s']:.3f}s, "
              f"{load['decode_tok_per_s']:.1f} tok/s")
        print("engine:", res["engine"])
        print("steady-state probe:", res["probe"])
        return
    res = run_serving(args.arch, smoke=not args.full, batch=args.batch,
                      prompt_len=args.prompt_len, gen_len=args.gen_len,
                      seed=args.seed, device=device, **grid)
    print(f"prefill {res['prefill_s']:.2f}s decode {res['decode_s']:.2f}s "
          f"({res['decode_tok_per_s']:.1f} tok/s)")
    print("sample:", res["tokens"][0][:16])


if __name__ == "__main__":
    main()
