"""The benchmark's traffic and weights: made from the seed alone."""

import numpy as np
import pytest
import torch

import bench_setup  # noqa: F401  (the import path)
from benchkit.traffic import MarkovTokens, learning_rate, make_batch
from benchkit.weights import leaf_items, make_weights

BIG = 2**31 + 12345


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_markov_copy_equals_the_port(seed):
    from repro_torch.data.pipeline import MarkovTokens as Port
    ours, port = MarkovTokens(512, seed, 8), Port(vocab_size=512, fan_out=8, seed=seed)
    for step in (0, 3):
        np.testing.assert_array_equal(ours.sequences(step, 4, 33),
                                      port.sequences(step, 4, 33))


def test_batch_rows_all_differ_and_shift():
    src = MarkovTokens(50280, BIG)
    a, b = make_batch(src, 0, 4, 2, 64), make_batch(src, 1, 4, 2, 64)
    assert a["tokens"].shape == (4, 2, 64) == a["labels"].shape
    np.testing.assert_array_equal(a["tokens"][..., 1:], a["labels"][..., :-1])
    rows = np.concatenate([a["tokens"].reshape(8, 64), b["tokens"].reshape(8, 64)])
    assert len({r.tobytes() for r in rows}) == 16


@pytest.mark.parametrize("samples", [0, 1000, 2560, 25600, 2_000_000, 3_000_000])
def test_learning_rate_equals_the_port(samples):
    from repro_torch.optim.adamw import warmup_cosine
    opt = {"peak_lr": 4e-4, "min_lr": 4e-5}
    sched = {"warmup_samples": 2560, "total_samples": 2_560_000}
    want = float(warmup_cosine(samples, peak_lr=4e-4, min_lr=4e-5, warmup_steps=2560,
                               total_steps=2_560_000))
    assert learning_rate(samples, opt, sched) == pytest.approx(want, rel=1e-6, abs=1e-12)


def test_weights_from_the_seed_alone():
    init = {"default": "normal:0.02", "scale": "ones", "bias": "zeros", "big": "normal:0.5"}
    like = {"a": {"scale": torch.empty(8)}, "b": [{"w": torch.empty(64, 32)},
            {"big": torch.empty(64, 32), "bias": torch.empty(5)}]}
    w1, w2 = make_weights(like, BIG, "cpu", init), make_weights(like, BIG, "cpu", init)
    w3 = make_weights(like, BIG + 1, "cpu", init)
    for (p, x), (_, y), (_, z) in zip(leaf_items(w1), leaf_items(w2), leaf_items(w3)):
        assert torch.equal(x, y)
        if not p.endswith(("scale", "bias")):
            assert not torch.equal(x, z)
    assert torch.equal(w1["a"]["scale"], torch.ones(8))
    assert torch.equal(w1["b"][1]["bias"], torch.zeros(5))
    assert float(w1["b"][0]["w"].std()) == pytest.approx(0.02, rel=0.1)
    assert float(w1["b"][1]["big"].std()) == pytest.approx(0.5, rel=0.1)
