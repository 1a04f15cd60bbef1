"""The benchmark's own parameter and FLOP counts, against the published
sizes and the port's parameter tree."""

import pytest
import torch

import bench_setup  # noqa: F401  (the import path)

from benchkit.manifest import Cell, load_manifest
from benchkit.program import family_shapes, model_dict, port_config
from benchkit.weights import leaf_items

M = load_manifest()
COUNTS = {"phi3-mini-3.8b-l8": 1_103_023_104, "phi3-mini-3.8b": 3_821_079_552}
# model FLOPs a token at 2048 positions
FLOPS = {"phi3-mini-3.8b-l8": 6.627e9, "phi3-mini-3.8b": 24.751e9}


def _cell_of(config):
    return next(Cell(M, w["name"]) for w in M["workloads"] if w["config"] == config)


@pytest.mark.parametrize("config", sorted(c["name"] for c in M["configs"]))
def test_parameter_count(config):
    c = _cell_of(config)
    m = model_dict(c.config, False)
    assert c.reference().param_count(m) == COUNTS[config] == c.config["param_count"]


@pytest.mark.parametrize("config", sorted(c["name"] for c in M["configs"]))
def test_shapes_match_the_port(config):
    from repro_torch.models.model import build_model
    c = _cell_of(config)
    m = model_dict(c.config, False)
    ours = {p: tuple(x.shape) for p, x in leaf_items(family_shapes(c.config, m))}
    port = {p: tuple(x.shape) for p, x in
            leaf_items(build_model(port_config(m)).init(0, "meta"))}
    assert ours == port
    assert sum(torch.Size(s).numel() for s in ours.values()) == COUNTS[config]


@pytest.mark.parametrize("config", sorted(c["name"] for c in M["configs"]))
def test_flops_per_token(config):
    c = _cell_of(config)
    m = model_dict(c.config, False)
    assert c.reference().flops_per_token(m, 2048) == pytest.approx(FLOPS[config],
                                                                    rel=1e-3)


def test_dense_flops_split():
    c = _cell_of("phi3-mini-3.8b-l8")
    m = model_dict(c.config, False)
    # 6 × (parameters less the 32064 × 3072 lookup) + 12 · 8 · 3072 · 2048
    want = 6 * (1_103_023_104 - 32064 * 3072) + 12 * 8 * 3072 * 2048
    assert c.reference().flops_per_token(m, 2048) == want

