"""Data pipeline: deterministic synthetic token sources + the stacked
microbatch layout the adaptive controller re-shards whenever it changes the
`BatchPlan` (the paper's dynamic-batch sampler, §3.2).

Counterpart of `repro/data/pipeline.py`, byte for byte on the same
(seed, step, plan): the numpy `default_rng((seed, step))` streams and the
crc32-seeded extra inputs are kept exactly, so the port and the reference
train on identical batches.  Batches stay numpy; the train step moves them
to its device.

Sources
-------
* `UniformTokens` — i.i.d. uniform tokens (throughput benchmarking).
* `MarkovTokens`  — a fixed random 1st-order Markov chain over the vocab;
                    has learnable structure so smoke-training losses
                    actually fall.
* `MemmapTokens`  — pre-tokenized int32 corpus on disk (numpy memmap).
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from repro_torch.core.schedule import BatchPlan


class TokenSource:
    vocab_size: int

    def sequences(self, step: int, count: int, seq_len: int) -> np.ndarray:
        raise NotImplementedError


@dataclasses.dataclass
class UniformTokens(TokenSource):
    vocab_size: int
    seed: int = 0

    def sequences(self, step, count, seq_len):
        rng = np.random.default_rng((self.seed, step))
        return rng.integers(0, self.vocab_size, (count, seq_len + 1), dtype=np.int32)


@dataclasses.dataclass
class MarkovTokens(TokenSource):
    """Sparse-ish random Markov chain; per-row transition supported on
    `fan_out` states => in-context predictable (val loss can approach
    log(fan_out) << log(vocab))."""
    vocab_size: int
    fan_out: int = 8
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._succ = rng.integers(0, self.vocab_size,
                                  (self.vocab_size, self.fan_out), dtype=np.int32)

    def sequences(self, step, count, seq_len):
        rng = np.random.default_rng((self.seed, 7919, step))
        out = np.empty((count, seq_len + 1), dtype=np.int32)
        state = rng.integers(0, self.vocab_size, count, dtype=np.int32)
        choices = rng.integers(0, self.fan_out, (count, seq_len + 1))
        for t in range(seq_len + 1):
            out[:, t] = state
            state = self._succ[state, choices[:, t]]
        return out


@dataclasses.dataclass
class MemmapTokens(TokenSource):
    """Pre-tokenized flat corpus; sequence-packed sampling WITH replacement
    (each draw is an independent uniform window start — there is no epoch
    bookkeeping, so short corpora revisit windows within what would be one
    epoch).  Requires at least `seq_len + 2` tokens: one window of
    `seq_len + 1` for the shifted next-token labels, plus one valid start."""
    path: str
    vocab_size: int
    seed: int = 0

    def __post_init__(self):
        try:
            self._data = np.memmap(self.path, dtype=np.int32, mode="r")
        except ValueError as e:   # np.memmap refuses zero-length files
            raise ValueError(
                f"MemmapTokens corpus {self.path!r} is empty or unreadable "
                f"as int32 tokens: {e}") from e
        if len(self._data) == 0:
            raise ValueError(f"MemmapTokens corpus {self.path!r} is empty")

    def sequences(self, step, count, seq_len):
        n_tokens = len(self._data)
        n_starts = n_tokens - (seq_len + 1)
        if n_starts <= 0:
            raise ValueError(
                f"MemmapTokens corpus {self.path!r} has {n_tokens} tokens, "
                f"too short to sample a seq_len={seq_len} training window: "
                f"need at least {seq_len + 2} (seq_len + 1 tokens for the "
                "shifted next-token labels, plus one valid start)")
        rng = np.random.default_rng((self.seed, step))
        starts = rng.integers(0, n_starts, count)
        return np.stack([np.asarray(self._data[s : s + seq_len + 1]) for s in starts])


def make_batch(source: TokenSource, step: int, plan: BatchPlan, seq_len: int,
               extra_specs=None):
    """Global stacked-microbatch batch for one optimizer step:
    tokens/labels of shape (M, J*micro, seq_len).  Re-sharding under a new
    plan is automatic — the layout is a pure function of the plan."""
    m, per_micro = plan.accum_steps, plan.workers * plan.micro_batch
    seqs = source.sequences(step, m * per_micro, seq_len)
    seqs = seqs.reshape(m, per_micro, seq_len + 1)
    batch = {
        "tokens": seqs[..., :-1],
        "labels": seqs[..., 1:].copy(),
    }
    if extra_specs:
        for name, shape_tail in extra_specs.items():
            # stable digest, not hash(): str hashes are PYTHONHASHSEED-
            # randomized per process
            rng = np.random.default_rng((zlib.crc32(name.encode()), step))
            batch[name] = rng.standard_normal(
                (m, per_micro) + tuple(shape_tail)).astype(np.float32)
    return batch


def pad_to_bucket(batch, plan: BatchPlan, bucket: BatchPlan,
                  pad_token: int = 0):
    """Pad a stacked batch built for `plan` to `bucket`'s (M, B, ...) shape.

    The plan's real samples are laid row-major into the bucket's flattened
    (M*B) slots; the tail slots get `tokens = pad_token` and `labels = -1`,
    which the masked-mean, valid-token-weighted loss ignores exactly — padded
    and unpadded batches produce identical loss and gradients.  Extra
    frontend inputs pad with zeros.  Returns `batch` unchanged when it
    already has the bucket's shape.
    """
    m_b, per_b = bucket.accum_steps, bucket.workers * bucket.micro_batch
    m_r, per_r = plan.accum_steps, plan.workers * plan.micro_batch
    if (m_b, per_b) == (m_r, per_r):
        return batch
    n_real, cap = m_r * per_r, m_b * per_b
    if cap < n_real:
        raise ValueError(f"bucket {bucket} cannot hold plan {plan}")
    out = {}
    for name, v in batch.items():
        tail = v.shape[2:]
        if name == "labels":
            flat = np.full((cap,) + tail, -1, dtype=v.dtype)
        elif name == "tokens":
            flat = np.full((cap,) + tail, pad_token, dtype=v.dtype)
        else:
            flat = np.zeros((cap,) + tail, dtype=v.dtype)
        flat[:n_real] = v.reshape((n_real,) + tail)
        out[name] = flat.reshape((m_b, per_b) + tail)
    return out


def microbatches(batch):
    """Iterate the M leading-axis microbatches of a stacked batch."""
    m = batch["tokens"].shape[0]
    for i in range(m):
        yield {k: v[i] for k, v in batch.items()}
