"""The run's last line and its exits: the contract's keys in order with
``checks`` last, no result without a card, and no result from the
benchmark's files alone; and one run on the card where there is one."""
import json
import math
import shutil
import subprocess
import sys

import pytest

from portbench import run as entry
from portbench.conftest import small_cell
from portbench.drivers import train as drv
from portbench.harness.cell import ROOT

BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
CELL = "zamba2-1.2b.train_4k.b4"


def test_result_line_shape():
    r = drv.run(small_cell(CELL), 7, 0.05, False, lambda: 2.5,
                device="cpu")
    line, notes = entry.report(r)
    out = json.loads(line)
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    units = {m["name"]: m["unit"] for m in BENCH["end_to_end"]}
    assert {k: v["unit"] for k, v in out["metrics"].items()} == units
    assert out["metrics"]["setup_s"]["value"] == 2.5
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for name, c in out["checks"].items():
        assert set(c) == {"value", "limit", "at"}
    assert [n.split(":")[0] for n in notes] == [
        f"check {k}" for k in out["checks"]]


def test_result_line_has_no_infinity():
    line, _ = entry.report({"correct": False, "attempted": 1, "failed": 1,
                            "metrics": {}, "device": {},
                            "checks": {"loss": {"value": math.inf,
                                                "limit": 1.0, "at": "x"}}})
    assert json.loads(line)["checks"]["loss"]["value"] is None
    assert "Infinity" not in line


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         "2147483999", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(cwd)})


def test_no_card_no_result():
    p = _run(ROOT.parent)
    assert p.returncode == 2, p.stderr
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copytree(ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT.parent / "BENCHMARK.json", tmp_path)
    p = _run(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.cuda
def test_one_run_on_the_card(cuda_card, tmp_path):
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         "2147484001", "--seconds", "2", "--trace", "0"],
        cwd=ROOT.parent, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
