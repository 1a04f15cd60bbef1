"""Serving launcher: a batched decode loop, and bursty open-loop load on the
continuous-batching engine (counterpart of `repro/launch/serve.py`).

Runs on the CUDA card unless the caller asks for the CPU (`device="cpu"`,
`--device cpu`); with no device given and no card present it raises.  On
the card both drivers replay their decode steps as CUDA graphs
(`serve_step.GraphedDecode`, the engine's rungs); on the CPU they run the
eager step.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --arch llama3.2-1b --batch 2 --prompt-len 8 --gen-len 8
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --continuous
    python -m repro_torch.launch.serve --full --batch 8 --prompt-len 128  # the card
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.serve_controller import ServeControllerConfig, serve_ladder
from repro_torch.distributed.serve_engine import QueueFullError, ServeEngine
from repro_torch.distributed.serve_step import (
    GraphedDecode, make_decode_step, make_slot_decode_step)
from repro_torch.models.common import resolve_device
from repro_torch.models.model import build_model
from repro_torch.tree import tree_leaves


def _sync(device: torch.device):
    """Wait for the device's queued work (the reference's block_until_ready)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _setup(arch, smoke, seed, device, params):
    """(cfg, model, params, device): params drawn from `seed` on `device`,
    unless given — then the device, and the depth, are theirs, and naming a
    device as well is an error."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if params is not None and device is not None:
        raise ValueError("pass `device` or `params`, not both: given "
                         "params serve on their own device")
    if params is None:
        params = build_model(cfg).init(seed, resolve_device(device))
    cfg = cfg.replace(num_layers=len(params["layers"]))
    return cfg, build_model(cfg), params, tree_leaves(params)[0].device


def _pct(lat, p):
    """The p-th percentile of the sorted latencies `lat` (0 when empty)."""
    return lat[min(len(lat) - 1, int(p / 100 * len(lat)))] if lat else 0.0


def run_serving(arch: str, *, smoke=True, batch=4, prompt_len=32, gen_len=32,
                seed=0, device=None, params=None, cuda_graphs=True):
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
    and the decode rate."""
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
    prompts = torch.from_numpy(prompts).to(device)

    cache = model.init_cache(batch, cache_len, device=device)
    graphed = cuda_graphs and device.type == "cuda"
    if graphed:
        graph = GraphedDecode(make_slot_decode_step(model, max_slots=batch)(batch),
                              params, cache, batch)
        pos = torch.zeros(batch, dtype=torch.int32, device=device)

        def next_token(tok, i):
            pos.fill_(i)
            return graph(params, cache, tok, pos)[0].clone()
    else:
        step_fn = make_decode_step(model)

        def next_token(tok, i):
            logits, _ = step_fn(params, cache, tok, i)
            return torch.argmax(logits, -1).to(torch.int32)

    # "prefill" by streaming the prompt through decode (the cache stays
    # shape-stable; `make_prefill` is the full-sequence prefill)
    _sync(device)
    t0 = time.time()
    tok = prompts[:, 0]
    for i in range(text_len):
        nxt = next_token(tok, i)
        tok = prompts[:, i + 1] if i + 1 < text_len else nxt
    _sync(device)
    t_prefill = time.time() - t0

    generated = [tok]
    _sync(device)
    t0 = time.time()
    for i in range(text_len, text_len + gen_len - 1):
        tok = next_token(tok, i)
        generated.append(tok)
    _sync(device)
    t_decode = time.time() - t0

    out = torch.stack(generated, dim=1).cpu().numpy()
    decode_tokens = batch * (gen_len - 1)
    toks_per_s = decode_tokens / max(t_decode, 1e-9) if decode_tokens else 0.0
    return {"tokens": out, "prefill_s": t_prefill, "decode_s": t_decode,
            "decode_tokens_timed": decode_tokens,
            "decode_tok_per_s": toks_per_s}


def run_continuous_serving(arch: str, *, smoke=True, max_slots=8,
                           prompt_len=4, gen_len=8, load_steps=60,
                           arrival_rate=0.5, burst_every=20, burst_size=5,
                           seed=0, latency_slo_s=0.0, aot_warmup=True,
                           max_queue=0, device=None, params=None):
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
    for the load window's own requests and tokens."""
    cfg, model, params, device = _setup(arch, smoke, seed, device, params)
    engine = ServeEngine(
        model, params, max_slots=max_slots, cache_len=prompt_len + gen_len,
        controller=ServeControllerConfig(ladder=serve_ladder(max_slots),
                                         latency_slo_s=latency_slo_s),
        aot_warmup=aot_warmup, max_queue=max_queue)
    rng = np.random.default_rng(seed)

    def submit_one():
        prompt = rng.integers(0, cfg.vocab_size, (prompt_len,)).astype(np.int32)
        try:
            engine.submit(prompt, max_new_tokens=gen_len)
        except QueueFullError:
            pass    # open-loop load-shed: counted in stats.requests_rejected

    completed = []
    rung_trace = []
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
    wall_s = max(time.time() - t_start, 1e-9)
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
    args = p.parse_args(argv)
    device = args.device or None
    if args.continuous:
        res = run_continuous_serving(
            args.arch, smoke=not args.full, max_slots=args.max_slots,
            prompt_len=args.prompt_len, gen_len=args.gen_len,
            load_steps=args.load_steps, arrival_rate=args.arrival_rate,
            burst_every=args.burst_every, burst_size=args.burst_size,
            max_queue=args.max_queue, seed=args.seed, device=device)
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
                      seed=args.seed, device=device)
    print(f"prefill {res['prefill_s']:.2f}s decode {res['decode_s']:.2f}s "
          f"({res['decode_tok_per_s']:.1f} tok/s)")
    print("sample:", res["tokens"][0][:16])


if __name__ == "__main__":
    main()
