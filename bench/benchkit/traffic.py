"""The benchmark's training traffic: tokens made from the seed, the
learning rate of each step.

`MarkovTokens` is the benchmark's own copy of the port's
`data/pipeline.py::MarkovTokens` (a fixed random first-order chain with
`fan_out` successors a state), so the program receives only what this
module generates.  Every seed gives the same sizes: the seed changes which
tokens, never how many.
"""

from __future__ import annotations

import math

import numpy as np


class MarkovTokens:
    def __init__(self, vocab_size: int, seed: int, fan_out: int = 8):
        self.vocab_size, self.seed, self.fan_out = vocab_size, seed, fan_out
        rng = np.random.default_rng(seed)
        self._succ = rng.integers(0, vocab_size, (vocab_size, fan_out),
                                  dtype=np.int32)

    def sequences(self, step: int, count: int, seq_len: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, 7919, step))
        out = np.empty((count, seq_len + 1), dtype=np.int32)
        state = rng.integers(0, self.vocab_size, count, dtype=np.int32)
        choices = rng.integers(0, self.fan_out, (count, seq_len + 1))
        for t in range(seq_len + 1):
            out[:, t] = state
            state = self._succ[state, choices[:, t]]
        return out


def make_batch(source: MarkovTokens, step: int, accum: int, rows: int,
               seq_len: int) -> dict:
    """The global batch of one step, {"tokens", "labels"} of shape (M, rows,
    seq_len): every row of every step is a fresh draw."""
    seqs = source.sequences(step, accum * rows, seq_len).reshape(
        accum, rows, seq_len + 1)
    return {"tokens": seqs[..., :-1], "labels": seqs[..., 1:].copy()}


def learning_rate(samples: int, opt: dict, sched: dict) -> float:
    """Linear warm-up then cosine decay over samples (the paper's
    schedule), rounded to float32 as the program's schedule is."""
    w, total = sched["warmup_samples"], sched["total_samples"]
    peak, low = opt["peak_lr"], opt["min_lr"]
    if samples < w:
        lr = peak * samples / w
    else:
        prog = min(max((samples - w) / max(total - w, 1), 0.0), 1.0)
        lr = low + 0.5 * (peak - low) * (1 + math.cos(math.pi * prog))
    return float(np.float32(lr))
