"""The benchmark's files: found by name, in the schema the harness reads,
and each configuration at its source's published widths."""
import json
import math
import re

import pytest

from portbench.harness import metrics as metric_files
from portbench.harness.cell import META, ROOT, cell_names, load_cell, \
    load_json

BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
#: the model fields that are widths: never cut, stated in every file
WIDTHS = ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
          "vocab_size", "ssm_state", "ssm_conv", "ssm_expand",
          "ssm_head_dim", "moe_experts", "moe_top_k", "moe_d_ff")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)
        layers.setdefault(m["layer"], []).append(m["name"])


def test_every_cell_is_found_by_name():
    """Every cell of BENCHMARK.json has its files; a cell's files that
    BENCHMARK.json leaves out say why."""
    assert set(WORKLOADS) <= set(cell_names())
    for name in set(cell_names()) - set(WORKLOADS):
        assert load_cell(name).workload["left_out"]
    for w in BENCH["workloads"]:
        cell = load_cell(w["name"])
        assert cell.workload["config"] == w["config"]
        assert cell.workload["traffic"] == w["traffic"]
        assert cell.chips == w["chips"] == 1
        assert cell.workload["why"] == w["why"]
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        assert set(cell.workload["limits"]) == {"grad", "grad_small",
                                                "change"}
        assert all(0 < v < math.inf
                   for v in cell.workload["limits"].values())


@pytest.mark.parametrize("name", cell_names())
def test_traffic_schema(name):
    t = load_cell(name).traffic
    assert (ROOT / "drivers" / f"{t['driver']}.py").is_file()
    assert t["checked_steps"] >= 1 and t["batch"] >= 1
    assert t["recipe"]["optimizer"] == "adamw"
    for k in ("peak_lr", "warmup_steps", "total_steps"):
        assert k in t["recipe"]


CONFIGS = sorted(p.stem for p in (ROOT / "configs").glob("*.json"))


def test_configs_in_benchmark_json():
    for conf in BENCH["configs"]:
        path = ROOT.parent / conf["file"]
        assert path.parent == ROOT / "configs" and path.stem in CONFIGS
        c = load_json("configs", path.stem)
        assert c["reduced"] == conf["reduced"]
        assert c["source"] == conf["source"]
        assert conf["name"] == path.stem


@pytest.mark.parametrize("name", CONFIGS)
def test_config_runs_every_published_width(name):
    """Each width field of the configuration file is the source's, as its
    ``published`` block gives them; the keys `reduced` lists differ from
    the source and are no width; every other field is the port's registry's
    (the repository's model structure)."""
    import dataclasses

    from repro_torch.configs import get_arch
    c = load_json("configs", name)
    reg = dataclasses.asdict(get_arch(c["name"]).model)
    model = {k: v for k, v in c.items() if k not in META}
    pub = c["published"]
    uses = {"hybrid": "ssm_", "moe": "moe_"}[model["family"]]
    widths = [k for k in WIDTHS
              if not k.startswith(("ssm_", "moe_")) or k.startswith(uses)]
    for k in widths:
        assert model[k] == pub[k], (k, model[k], pub[k])
    for k in c["reduced"]:
        assert k not in WIDTHS and model[k] != pub[k], k
    for k, v in model.items():
        assert k in reg, k
        if k not in pub:
            assert v == reg[k], (k, v, reg[k])
    assert set(pub) <= set(model)
    assert {k for k in pub if model[k] != pub[k]} == set(c["reduced"])


def test_per_layer_metrics_have_readers():
    found = {r.NAME: r for r in metric_files.readers()}
    for m in BENCH["per_layer"]:
        assert m["name"] in found
        assert found[m["name"]].UNIT == m["unit"]
    for name in found:
        assert (ROOT / "metrics" / f"{name}.py").is_file()
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            op = m["name"][:-len("_roofline")]
            assert (ROOT / "work" / f"{op}.py").is_file()


def test_file_names_are_names():
    for p in ROOT.rglob("*"):
        if "__pycache__" in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT.parent).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
