"""A configuration, its cell and its checks added by new files and manifest
entries alone, in a copy of the benchmark; and the published-key rule on a
made-up body with latent attention and sparse experts."""

import copy
import hashlib
import json
import shutil

import pytest
import torch

import bench_setup  # noqa: F401  (the import path)
from benchkit import cli, refstep
from benchkit.manifest import BENCH, ROOT, Cell, find, rms_norm_eps
from benchkit.program import Spec
from test_bench_counts import (check_flops_per_token, check_parameter_count,
                               check_shapes_match_the_port)
from test_bench_manifest import check_config_entry, check_published

BASE_CONFIG, BASE_CELL = "phi3-mini-3.8b-l8", "phi3-l8.accum.s2048"


def _copy_tree(root):
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(BENCH, root / BENCH.name, ignore=shutil.ignore_patterns("__pycache__"))
    return root


def _digests(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def add_configuration(root, name: str, cell: str, edit=None) -> dict:
    """A renamed copy of the base configuration (its body passed through
    `edit`) and a cell of it, added to the tree under `root` as a new
    configuration file, a new limits file and new manifest entries, the
    cell's name appended to its rate's `workloads`: the manifest."""
    man = json.loads((root / "BENCHMARK.json").read_text())
    entry = find(man["configs"], BASE_CONFIG, "config")
    body = json.loads((root / entry["file"]).read_text())
    body["name"] = body["model"]["name"] = name
    if edit:
        edit(body)
    file = f"bench/configs/{name}.json"
    (root / file).write_text(json.dumps(body, indent=2))
    limits = (root / "bench" / "limits" / f"{BASE_CELL}.json").read_text()
    (root / "bench" / "limits" / f"{cell}.json").write_text(limits)
    man["configs"].append(dict(entry, name=name, file=file))
    base = find(man["workloads"], BASE_CELL, "workload")
    man["workloads"].append(dict(base, name=cell, config=name))
    find(man["end_to_end"], "train_tokens_per_s", "metric")["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=2))
    return man


def test_configuration_added_by_files_alone(tmp_path):
    root = _copy_tree(tmp_path)
    before = _digests(root)
    old = json.loads((root / "BENCHMARK.json").read_text())
    name, cell = "phi3-copy-l8", "phi3copy-l8.accum.s2048"
    man = add_configuration(root, name, cell)

    after = _digests(root)
    changed = {p for p in before if after[p] != before[p]}
    assert changed == {"BENCHMARK.json"}
    assert set(after) - set(before) == {f"bench/configs/{name}.json",
                                        f"bench/limits/{cell}.json"}
    # the manifest only gained entries, and the rate its new cell
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in old[group]:
            new = copy.deepcopy(find(man[group], e["name"], group))
            if e["name"] == "train_tokens_per_s":
                assert new["workloads"].pop() == cell
            assert new == e

    cfg = find(man["configs"], name, "config")
    check_config_entry(man, root, cfg)
    check_published(json.loads((root / cfg["file"]).read_text()), cfg["reduced"],
                    cfg["file"])
    check_parameter_count(man, root, name)
    check_shapes_match_the_port(man, root, name)
    check_flops_per_token(man, root, name)

    # the new cell finds its files by name, and every metric of its rate
    # follows it with no entry edited
    c, base = Cell(man, cell, root), Cell(man, BASE_CELL, root)
    assert c.config["name"] == name and c.limits == base.limits
    for kind in ("end_to_end", "per_layer"):
        assert ([m["name"] for m in c.metrics(kind)]
                == [m["name"] for m in base.metrics(kind)])
    assert {"forward_ms", "backward_ms", "recompute_ms", "grad_accum_ms"} <= {
        m["name"] for m in c.metrics("per_layer")}


def test_published_eps_reaches_the_reference(tmp_path, monkeypatch):
    root = _copy_tree(tmp_path)

    def as_the_program_runs(body):
        body["published"]["rms_norm_eps"] = 1e-6
        del body["assumed"]

    name, cell = "phi3-eps-l8", "phi3eps-l8.accum.s2048"
    man = add_configuration(root, name, cell, as_the_program_runs)
    cfg = find(man["configs"], name, "config")
    check_published(json.loads((root / cfg["file"]).read_text()), cfg["reduced"],
                    cfg["file"])
    c = Cell(man, cell, root)
    got = []
    monkeypatch.setattr(refstep, "run_reference",
                        lambda family, m, eps, *a, **k: got.append(eps))
    spec = Spec(cell=cell, config=c.config, traffic=c.traffic, seed=2**31 + 5,
                seconds=1.0, trace=False, t_process=0.0, device="cpu", smoke=True)
    cli.reference_check(c, spec, torch.device("cpu"))
    assert got == [1e-6]


# a DeepSeek-V2-like body: one dense and four sparse layers, 20 of the 160
# routed experts held, an eighth of the vocabulary
MOE_MLA = {
    "published": {"num_hidden_layers": 60, "hidden_size": 5120, "num_attention_heads": 128,
                  "num_key_value_heads": 128, "intermediate_size": 12288,
                  "vocab_size": 102400, "rope_theta": 10000, "tie_word_embeddings": False,
                  "num_experts_per_tok": 6, "moe_intermediate_size": 1536,
                  "n_routed_experts": 160, "n_shared_experts": 2,
                  "first_k_dense_replace": 1, "kv_lora_rank": 512, "q_lora_rank": 1536,
                  "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
                  "rms_norm_eps": 1e-6},
    "model": {"num_layers": 5, "d_model": 5120, "num_heads": 128, "num_kv_heads": 128,
              "d_ff": 12288, "vocab_size": 12800, "rope_theta": 10000.0,
              "tie_embeddings": False,
              "moe": {"num_experts": 20, "top_k": 6, "d_expert": 1536,
                      "num_shared_experts": 2, "shared_d_expert": 1536, "first_dense": 1},
              "mla": {"kv_lora_rank": 512, "q_lora_rank": 1536, "qk_nope_head_dim": 128,
                      "qk_rope_head_dim": 64, "v_head_dim": 128}},
    "reduced": ["num_hidden_layers", "n_routed_experts", "vocab_size"],
}


def _held_through_port_keys(b):
    # a source that names its expert count otherwise, mapped by the file
    b["published"]["num_local_experts"] = b["published"].pop("n_routed_experts")
    b["port_keys"] = {"num_local_experts": "moe.num_experts"}
    b["reduced"] = ["num_hidden_layers", "num_local_experts", "vocab_size"]


def _set(path, value):
    def edit(b):
        *keys, last = path.split("/")
        node = b
        for k in keys:
            node = node[k]
        node[last] = value
    return edit


def _drop_reduced(key):
    def edit(b):
        b["reduced"].remove(key)
    return edit


CASES = {
    "as_cut": (None, True),
    "held_experts_through_port_keys": (_held_through_port_keys, True),
    "held_experts_unlisted": (_drop_reduced("n_routed_experts"), False),
    "held_experts_through_port_keys_unlisted": (
        lambda b: (_held_through_port_keys(b), b["reduced"].remove("num_local_experts")),
        False),
    "moe_intermediate_size_changed": (_set("model/moe/d_expert", 1024), False),
    "kv_lora_rank_changed": (_set("model/mla/kv_lora_rank", 256), False),
    "experts_per_token_changed": (_set("model/moe/top_k", 2), False),
    "eps_assumed_equal_to_published": (_set("assumed", {"rms_norm_eps": 1e-6}), False),
}


@pytest.mark.parametrize("case", CASES)
def test_published_rule_on_a_moe_mla_body(case):
    edit, ok = CASES[case]
    body = copy.deepcopy(MOE_MLA)
    if edit:
        edit(body)
    if ok:
        check_published(body, body["reduced"], "made-up.json")
    else:
        with pytest.raises(AssertionError):
            check_published(body, body["reduced"], "made-up.json")


def test_published_eps_needs_no_assumed_entry():
    body = copy.deepcopy(MOE_MLA)
    check_published(body, body["reduced"], "made-up.json")
    assert rms_norm_eps(body, "made-up.json") == 1e-6


def test_a_file_without_eps_fails():
    body = copy.deepcopy(MOE_MLA)
    del body["published"]["rms_norm_eps"]
    with pytest.raises(KeyError, match="made-up.json"):
        check_published(body, body["reduced"], "made-up.json")
