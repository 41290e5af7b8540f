"""The port stands alone and never runs on the CPU unless asked.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports JAX
  or the reference package (AST scan).
* Making a device, a runtime or a compiled program without
  ``torch_device`` asks for the card; where there is none, that raises.
* Building the CUDA kernels without ``nvcc`` raises.
* ``chip_smoke.py`` fails, and prints no result, where there is no card.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import hwspec
from repro_torch.core.driver import Device
from repro_torch.core.program import Program
from repro_torch.core.runtime import Runtime
from repro_torch.core.scheduler import Epilogue
from repro_torch.kernels import _build

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _forbidden_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:          # relative: stays inside the package
                continue
            names = [node.module or ""]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(n)
    return bad


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    assert path.is_file()
    assert _forbidden_imports(path) == []


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists here")


def test_default_device_is_the_card():
    _no_card()
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        Device()
    with pytest.raises(RuntimeError):
        Runtime(hwspec.pynq())
    p = Program(hwspec.pynq())
    p.matmul(p.input("x", (16, 16)), p.input("w", (16, 16)),
             epilogue=Epilogue(shift=4))
    with pytest.raises(RuntimeError):
        p.compile()
    # asking for the CPU works
    c = p.compile(torch_device="cpu", dram_size=1 << 20)
    rng = np.random.default_rng(0)
    out = c(x=rng.integers(-8, 8, (16, 16), dtype=np.int8),
            w=rng.integers(-8, 8, (16, 16), dtype=np.int8))
    assert out.shape == (16, 16) and c.last_stats[0].backend == "cuda"


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "NVCC_FALLBACK", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load("vta_gemm")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()


def test_chip_smoke_fails_without_a_card():
    _no_card()
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
