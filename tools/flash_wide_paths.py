#!/usr/bin/env python3
"""The wide flash kernels' resident and streamed operand paths against
each other, and their ptxas reports, on the card.

    python3 tools/flash_wide_paths.py [--rounds 2] [--ptxas-only]

``flash_wide.cu`` keeps the bf16 forward's Q tile in shared memory up to
D 512 (``F_QRES_MAX`` chunks of 64 columns) and the bf16 backward's own
operands up to D 256 (``B_RES_MAX``); above, every chunk streams through
the ring beside the other operand's.  The streamed path is correct at
every D.  This builds the source twice with the port's nvcc flags into
``build/flash_wide_paths/`` (one nvcc each, started together): as it is
("resident"), and with both limits 0 ("streamed": every D on the
streamed path).  It then runs the op through each library in turn
(``_build``'s loaded library swapped) at ``time_kernels.WIDE_SHAPES``'
bfloat16 shapes (B1 H8 causal: D 160 and 256 at S 2048, D 320 and 512 at
S 1024), forward and backward from the forward's L, each round in the
order resident, streamed, streamed, resident; the time is the
torch.profiler device time of the wide kernels a call
(``chip_smoke.kernel_ms``).  The backward above D 256 is the same code
in both builds: its rows measure the noise.  The streamed outputs are
held to the resident ones (the largest difference is printed; a
difference beyond ``chip_smoke.attn_tolerance`` exits 1).

First (nvcc's whole output kept as ``ptxas_<build>.txt`` beside the
libraries), one JSON line per kernel function of each build: its
registers, spill bytes and ptxas's C75xx performance warnings (wgmma
serialized, or a warpgroup.arrive injected), by code and count, and
each code's message once.  Then (unless --ptxas-only, which builds the
source as it is and stops there) one JSON line per (shape, direction,
path, turn).  The first line is the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit``).  Needs a CUDA card and
nvcc; it imports no JAX.
"""
import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: (the line in flash_wide.cu, its streamed-build form)
STREAMED = [("constexpr int F_QRES_MAX = 8;", "constexpr int F_QRES_MAX = 0;"),
            ("constexpr int B_RES_MAX = 4;", "constexpr int B_RES_MAX = 0;")]
OUT_DIR = ROOT / "build" / "flash_wide_paths"
#: ptxas's text of each C75xx warning seen (line numbers elided)
MESSAGES = {}


def build(src_text, name, nvcc, flags):
    """Start nvcc on `src_text` written to OUT_DIR (its include of the
    shared header made absolute); returns (source, library, process)."""
    src = OUT_DIR / f"flash_wide_{name}.cu"
    src.write_text(src_text.replace(
        '#include "../../csrc/hopper.cuh"',
        f'#include "{ROOT}/src/repro_torch/kernels/csrc/hopper.cuh"'))
    lib = OUT_DIR / f"libflash_wide_{name}.so"
    return src, lib, subprocess.Popen(
        [nvcc, *flags, "-o", str(lib), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def ptxas_report(text):
    """{function: dict(registers, spill_stores, spill_loads, warnings)}
    from nvcc's -Xptxas -v output, the names demangled by c++filt where
    it is installed."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            funcs.setdefault(cur, dict(registers=None, spill_stores=None,
                                       spill_loads=None, warnings={}))
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = m.group(1)
            funcs.setdefault(cur, dict(registers=None, spill_stores=None,
                                       spill_loads=None, warnings={}))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur in funcs:
            funcs[cur]["spill_stores"] = int(m.group(1))
            funcs[cur]["spill_loads"] = int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur in funcs:
            funcs[cur]["registers"] = int(m.group(1))
            continue
        m = re.search(r"\((C75\d\d)\) (.*) in (?:the )?function "
                      r"'([^']+)'", line)
        if m:
            f = funcs.setdefault(m.group(3), dict(
                registers=None, spill_stores=None, spill_loads=None,
                warnings={}))
            f["warnings"][m.group(1)] = f["warnings"].get(m.group(1), 0) + 1
            MESSAGES[m.group(1)] = re.sub(r"line \d+", "line N", m.group(2))
    filt = shutil.which("c++filt")
    if filt and funcs:
        names = list(funcs)
        out = subprocess.run([filt], input="\n".join(names), text=True,
                             capture_output=True).stdout.splitlines()
        if len(out) == len(names):
            funcs = {re.sub(r"^void ", "", d)
                     .replace("(anonymous namespace)::", "").split("(")[0]:
                     funcs[n] for n, d in zip(names, out)}
    return funcs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--ptxas-only", action="store_true",
                    help="build the source as it is, print its report, "
                         "time nothing")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_wide_paths: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    sys.path.insert(2, str(ROOT / "tools"))
    import chip_smoke as cs
    from time_kernels import WIDE_SHAPES
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_fwd)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    card = torch.cuda.get_device_name(0)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    text = _build.sources()["flash_wide"].read_text()
    streamed = text
    for old, new in STREAMED:
        if old not in streamed:
            raise SystemExit(f"flash_wide_paths: {old!r} not in the source")
        streamed = streamed.replace(old, new)
    nvcc = _build.nvcc()
    builds = [("resident", text)] + [("streamed", streamed)] * (
        not args.ptxas_only)
    jobs = {name: build(t, name, nvcc, _build.NVCC_FLAGS)
            for name, t in builds}
    libs = {}
    for name, (src, lib, p) in jobs.items():
        stdout, stderr = p.communicate()
        (OUT_DIR / f"ptxas_{name}.txt").write_text(stdout + stderr)
        if p.returncode != 0:
            raise SystemExit(f"flash_wide_paths: nvcc {name}: {stderr}")
        for fn, rep in ptxas_report(stdout + stderr).items():
            print(json.dumps(dict(card=card, op="ptxas", build=name,
                                  function=fn, **rep)), flush=True)
        libs[name] = ctypes.CDLL(str(lib))
    for code, msg in sorted(MESSAGES.items()):
        print(json.dumps(dict(card=card, op="ptxas_warning", code=code,
                              message=msg)), flush=True)
    if args.ptxas_only:
        return 0
    # the port's other kernels load as they are; flash_wide is swapped
    _build.load("flash_wide")
    dev = torch.device("cuda")
    order = ["resident", "streamed", "streamed", "resident"]
    for B, S, H, D, dt in WIDE_SHAPES:
        if dt != "bfloat16":
            continue
        g = torch.Generator(device=dev).manual_seed(D)
        q, k, v, do = (torch.randn((B, S, H, D), generator=g, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        outs, lses = {}, {}
        for name, lib in libs.items():
            _build._LIBS["flash_wide"] = lib
            o, lses[name] = flash_attention_fwd(q, k, v, causal=True)
            grads = flash_attention_bwd(q, k, v, o, do, causal=True,
                                        lse=lses[name])
            outs[name] = (o, *grads)
        tol = cs.attn_tolerance("bfloat16", outs["resident"][0])
        diff = [float((a.float() - b.float()).abs().max())
                for a, b in zip(outs["resident"], outs["streamed"])]
        bitwise = all(torch.equal(a, b) for a, b in
                      zip(outs["resident"], outs["streamed"]))
        print(json.dumps(dict(card=card, op="paths_agree", D=D, S=S,
                              max_abs_diff_o_dq_dk_dv=diff,
                              bitwise=bitwise, o_limit=tol)), flush=True)
        if diff[0] > tol:
            raise SystemExit(f"flash_wide_paths: D {D} streamed output "
                             f"differs by {diff[0]} > {tol}")
        o, lse = outs["resident"][0], lses["resident"]
        calls = dict(
            fwd=(lambda: flash_attention(q, k, v, causal=True),
                 cs.FLASH_WIDE_NAME),
            bwd=(lambda: flash_attention_bwd(q, k, v, o, do, causal=True,
                                             lse=lse),
                 cs.FLASH_WIDE_BWD_NAME))
        for turn in range(args.rounds):
            for i, name in enumerate(order):
                _build._LIBS["flash_wide"] = libs[name]
                for direction, (call, kname) in calls.items():
                    call_ms = cs.cuda_time_ms(call, reps=10, warmup=2)
                    ms = cs.kernel_ms(call, kname, call_ms, reps=20)
                    print(json.dumps(dict(
                        card=card, op="flash_wide_path", B=B, S=S, H=H, D=D,
                        dtype=dt, causal=True, direction=direction,
                        path=name, turn=4 * turn + i, ms=ms,
                        call_ms=call_ms)), flush=True)
        del q, k, v, do, outs, lses, o, lse
        torch.cuda.empty_cache()
    _build._LIBS.pop("flash_wide", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
