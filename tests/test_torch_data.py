"""Port `MemmapTokens` against the reference's: the same seeded int32
corpus in a temporary file gives byte-identical sequences (and stacked
batches), and the too-short and empty corpora fail with the same errors,
word for word (the cases of tests/test_data.py)."""

import numpy as np
import pytest

from repro.core.schedule import BatchPlan as JPlan
from repro.data.pipeline import MemmapTokens as JMemmap, make_batch as jbatch
from repro_torch.core.schedule import BatchPlan
from repro_torch.data.pipeline import MemmapTokens, make_batch


def _corpus(tmp_path, n, seed=0, name="tokens.bin"):
    path = tmp_path / name
    np.random.default_rng(seed).integers(0, 500, n, dtype=np.int32).tofile(path)
    return str(path)


@pytest.mark.parametrize("seed,seq_len", [(0, 16), (3, 64), (11, 5)])
def test_memmap_sequences_match_reference(tmp_path, seed, seq_len):
    path = _corpus(tmp_path, 10_000, seed)
    src, ref = MemmapTokens(path, 500, seed=seed), JMemmap(path, 500, seed=seed)
    for step in (0, 1, 17):
        got, want = src.sequences(step, 6, seq_len), ref.sequences(step, 6, seq_len)
        assert got.dtype == want.dtype == np.int32
        assert got.tobytes() == want.tobytes()
    got = make_batch(src, 5, BatchPlan(global_batch=8, micro_batch=2,
                                       accum_steps=2, workers=2), seq_len)
    want = jbatch(ref, 5, JPlan(global_batch=8, micro_batch=2, accum_steps=2,
                                workers=2), seq_len)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].tobytes() == want[k].tobytes(), k


def test_memmap_contiguous_windows(tmp_path):
    path = tmp_path / "tokens.bin"
    (np.arange(1000, dtype=np.int32) % 50).tofile(path)
    seqs = MemmapTokens(str(path), vocab_size=50, seed=0).sequences(0, 3, 16)
    assert seqs.shape == (3, 17) and seqs.max() < 50
    assert ((seqs[:, 1:] - seqs[:, :-1]) % 50 == 1).all()


def _error(cls, fn):
    with pytest.raises(ValueError) as e:
        fn(cls)
    return str(e.value)


def test_memmap_errors_match_reference(tmp_path):
    short = _corpus(tmp_path, 17, name="short.bin")
    msgs = [_error(c, lambda c: c(short, vocab_size=50, seed=0).sequences(0, 2, 16))
            for c in (MemmapTokens, JMemmap)]
    assert msgs[0] == msgs[1] and "too short" in msgs[0] and "seq_len=16" in msgs[0]
    # seq_len + 2 tokens is exactly enough (one valid start)
    exact = _corpus(tmp_path, 18, name="exact.bin")
    assert MemmapTokens(exact, vocab_size=50).sequences(0, 2, 16).shape == (2, 17)
    empty = tmp_path / "empty.bin"
    empty.touch()
    msgs = [_error(c, lambda c: c(str(empty), vocab_size=50, seed=0))
            for c in (MemmapTokens, JMemmap)]
    assert msgs[0] == msgs[1] and "empty" in msgs[0]
