"""The port's examples run end to end on the CPU (subprocess,
``--device cpu``) at the reference tests' arguments
(``tests/test_examples.py``) and print the reference's markers;
``serve_lm_torch.py`` prints the same greedy tokens as
``examples/serve_lm.py`` with the same arguments (exact: one wrong byte
derails the sequence).  Without ``--device`` each asks for the card and,
where there is none, fails instead of running on the CPU."""
import os
import re
import subprocess
import sys

import pytest
import torch

from torch_cases import ROOT


def _run(script, *args, timeout=600, check=True):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                          *args], capture_output=True, text=True, env=env,
                         timeout=timeout)
    if check:
        assert out.returncode == 0, out.stderr[-3000:]
    return out


def _tokens(stdout):
    return re.findall(r"dialogue \d+ \(prompt +\d+\):[ \d]+", stdout)


def test_quickstart_port():
    out = _run("quickstart_torch.py", "--device", "cpu").stdout
    for marker in ("exact int8 result ok", "virtual_threads=2",
                   "cross-backend check ok", "program JIT ok", "c2:direct",
                   "0 eager fallbacks", "DRAM image constant",
                   "byte-exact vs serial", "bit-exact vs the eager",
                   "continuous-batched 4+4", "LUT-GEMM launches",
                   "self-healed mid-dialogue", "tune 1 hit/0 miss"):
        assert marker in out, marker


@pytest.mark.parametrize("args", [("C12",), ()], ids=["C12", "C9"])
def test_resnet18_offload_port(args):
    out = _run("resnet18_offload_torch.py", *args, "--device", "cpu").stdout
    assert "exact on VTA" in out
    assert out.count("exact end-to-end") == 2
    assert "cpu step(s)" in out
    assert "stream cache hit" in out
    assert ":direct" in out and "0 eager fallbacks" in out
    layer = args[0] if args else "C9"
    assert f"{layer} unscaled" in out and "exact vs conv2d_reference" in out


def test_serve_lm_port_tokens_equal_reference():
    args = ("--sessions", "2", "--steps", "6", "--pool", "2")
    out = _run("serve_lm_torch.py", *args, "--device", "cpu").stdout
    assert "persistent B/session" in out
    assert "ganged segments" in out
    assert "reproduce the eager numpy reference" in out
    ref = _run("serve_lm.py", *args).stdout
    assert len(_tokens(out)) == 2
    assert _tokens(out) == _tokens(ref)


@pytest.mark.parametrize("script", ["quickstart_torch.py",
                                    "resnet18_offload_torch.py",
                                    "serve_lm_torch.py"])
def test_examples_ask_for_the_card(script):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists here")
    out = _run(script, timeout=120, check=False)
    assert out.returncode != 0
    assert "torch_device='cpu'" in out.stderr
