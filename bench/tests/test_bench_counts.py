"""The benchmark's own parameter and FLOP counts, against the numbers each
configuration's file states and the port's parameter tree.

Each check is a function of (manifest, root, config), so that one body
serves this checkout and a copy with a configuration added by files alone
(`test_bench_addable.py`)."""

import pytest
import torch

import bench_setup  # noqa: F401  (the import path)

from benchkit.manifest import ROOT, Cell, load_manifest
from benchkit.program import family_shapes, model_dict, port_config
from benchkit.weights import leaf_items

M = load_manifest()
CONFIGS = sorted(c["name"] for c in M["configs"])


def cell_of(manifest, root, config):
    """The first cell of `manifest` that runs `config`, its files under
    `root`."""
    return next(Cell(manifest, w["name"], root) for w in manifest["workloads"]
                if w["config"] == config)


def check_parameter_count(manifest, root, config):
    c = cell_of(manifest, root, config)
    m = model_dict(c.config, False)
    assert c.reference().param_count(m) == c.config["param_count"]


def check_shapes_match_the_port(manifest, root, config):
    from repro_torch.models.model import build_model
    c = cell_of(manifest, root, config)
    m = model_dict(c.config, False)
    ours = {p: tuple(x.shape) for p, x in
            leaf_items(family_shapes(c.config, m, c.reference()))}
    port = {p: tuple(x.shape) for p, x in
            leaf_items(build_model(port_config(m)).init(0, "meta"))}
    assert ours == port
    assert sum(torch.Size(s).numel() for s in ours.values()) == c.config["param_count"]


def check_flops_per_token(manifest, root, config):
    c = cell_of(manifest, root, config)
    m = model_dict(c.config, False)
    want = c.config["flops_per_token"]
    assert c.reference().flops_per_token(m, want["seq_len"]) == pytest.approx(
        want["value"], rel=1e-3)


@pytest.mark.parametrize("config", CONFIGS)
def test_parameter_count(config):
    check_parameter_count(M, ROOT, config)


@pytest.mark.parametrize("config", CONFIGS)
def test_shapes_match_the_port(config):
    check_shapes_match_the_port(M, ROOT, config)


@pytest.mark.parametrize("config", CONFIGS)
def test_flops_per_token(config):
    check_flops_per_token(M, ROOT, config)


def test_dense_flops_split():
    c = cell_of(M, ROOT, "phi3-mini-3.8b-l8")
    m = model_dict(c.config, False)
    # 6 × (parameters less the 32064 × 3072 lookup) + 12 · 8 · 3072 · 2048
    want = 6 * (1_103_023_104 - 32064 * 3072) + 12 * 8 * 3072 * 2048
    assert c.reference().flops_per_token(m, 2048) == want
