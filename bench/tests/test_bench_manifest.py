"""The manifest against the benchmark's contract, and every file it names."""

import json
import re
from pathlib import Path

import pytest

import bench_setup  # noqa: F401  (the import path)
from benchkit.manifest import BENCH, ROOT, Cell, load_manifest, rms_norm_eps

M = load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in M["workloads"]]
METRICS = M["end_to_end"] + M["per_layer"]


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert M["paths"] == ["bench"] and M["command"] == ["python3", "bench/run.py"]
    assert all(not w.startswith("/") and ".." not in w for w in M["command"])


def test_run_seconds_fits_the_full_check():
    rs = M["run_seconds"]
    assert 1 <= rs <= 51 and isinstance(rs, int)
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", M["configs"] + M["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
        assert entry["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
            assert "\t" not in entry[key]


def test_names_are_unique():
    for group in (M["configs"], M["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in M["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_bounds():
    names = {m["name"] for m in M["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = Cell(M, cell)
    assert c.chips in (1, 4)
    assert c.reference().loss is not None
    assert c.limits["limits"] and set(c.limits["limits"]) <= {
        "loss_gap", "var_l1_gap", "grad_sqnorm_gap", "grad_leaf_gap",
        "update_leaf_gap", "moment_leaf_gap"}
    assert c.traffic["name"] == c.entry["traffic"]
    assert c.config["name"] == c.entry["config"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    c = Cell(M, cell)
    e2e = {m["name"] for m in c.metrics("end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.metrics("per_layer")


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_has_a_reader(metric):
    assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_layer_metric_moves_what_its_cells_report(metric):
    assert metric["moves"] in {m["name"] for m in M["end_to_end"]}
    cells = [c for c in CELLS
             if metric["name"] in {m["name"] for m in Cell(M, c).metrics("per_layer")}]
    assert cells
    for c in cells:
        assert metric["moves"] in {m["name"] for m in Cell(M, c).metrics("end_to_end")}
    for c in metric.get("workloads", []):
        assert c in CELLS
    assert metric["layer"] and "\n" not in metric["layer"]


# a width, which `reduced` may never name: a hidden, intermediate, latent,
# state or projection size, a head size, an expansion factor, the experts a
# token
WIDTH = re.compile(r"(_dim|_rank|intermediate_size)$|^(d_model|d_ff|hidden_size|"
                   r"head_dim|expand|state_dim|top_k|num_experts_per_tok)$")


def check_config_entry(manifest, root, cfg):
    """A manifest's configuration entry against its file under `root`."""
    assert cfg["file"].startswith("bench/") and (root / cfg["file"]).is_file()
    body = json.loads((root / cfg["file"]).read_text())
    assert body["reduced"] == cfg["reduced"] and len(cfg["reduced"]) <= 16
    assert not any(WIDTH.search(k) for k in cfg["reduced"])
    assert any(w["config"] == cfg["name"] for w in manifest["workloads"])
    files = [c["file"] for c in manifest["configs"]]
    assert files.count(cfg["file"]) == 1


@pytest.mark.parametrize("cfg", M["configs"], ids=lambda c: c["name"])
def test_config_file_and_reduced_keys(cfg):
    check_config_entry(M, ROOT, cfg)


def test_four_chip_cells_are_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)


def test_paths_hold_only_the_benchmark():
    assert (BENCH / "run.py").is_file()
    assert not Path(BENCH.name).name.endswith("_torch")


# the published config's keys under the port's names: a dotted path into
# the file's `model` entry; a file adds its own under `port_keys`
PORT_KEYS = {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
             "num_attention_heads": "num_heads", "num_key_value_heads": "num_kv_heads",
             "intermediate_size": "d_ff", "vocab_size": "vocab_size",
             "rope_theta": "rope_theta", "tie_word_embeddings": "tie_embeddings",
             "num_experts_per_tok": "moe.top_k", "moe_intermediate_size": "moe.d_expert",
             "n_routed_experts": "moe.num_experts",
             "n_shared_experts": "moe.num_shared_experts",
             "first_k_dense_replace": "moe.first_dense",
             **{k: f"mla.{k}" for k in ("kv_lora_rank", "q_lora_rank", "qk_nope_head_dim",
                                        "qk_rope_head_dim", "v_head_dim")}}


def _at(model: dict, path: str):
    for key in path.split("."):
        model = model[key]
    return model


def published_changes(body: dict) -> set:
    """The published keys a configuration's file departs from: those whose
    value in `model` differs, and those `assumed` sets otherwise."""
    pub, model, assumed = body["published"], body["model"], body.get("assumed", {})
    keys = {**PORT_KEYS, **body.get("port_keys", {})}
    changed = {k for k, v in pub.items() if k in keys and _at(model, keys[k]) != v}
    return changed | {k for k, v in assumed.items() if pub.get(k) != v}


def check_published(body: dict, reduced, file: str):
    """Every departure from the published config is listed, as a cut
    (`reduced`) or as what the program forces (`assumed`), never as both;
    the reference's ε is stated."""
    assumed = body.get("assumed", {})
    assert published_changes(body) == set(reduced) | set(assumed)
    # an assumed value is what the program is forced to run, never a cut
    assert not set(assumed) & set(reduced)
    rms_norm_eps(body, file)


@pytest.mark.parametrize("cfg", M["configs"], ids=lambda c: c["name"])
def test_published_values_except_reduced_and_assumed(cfg):
    body = json.loads((ROOT / cfg["file"]).read_text())
    check_published(body, cfg["reduced"], cfg["file"])
