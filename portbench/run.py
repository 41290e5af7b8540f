"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is ``portbench/workloads/<cell>.json``; its traffic names the
driver (``portbench/drivers/<driver>.py``).  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the end-to-end metrics, or with ``--trace 1`` the per-layer
ones), ``device`` and, traced, ``breakdown``; its last key, ``checks``,
holds each number the comparison with the reference read, beside its
limit, and the last lines of standard error repeat them.

Without a CUDA card, or with fewer than the cell asks for, it prints no
result and exits 2.  It exits 3, printing no result, where ``jax``,
``jaxlib``, ``flax`` or the JAX package ``repro`` is loaded once the run
is over.  Build and kernel caches stay inside the checkout, under
``build/``: the port's kernels in ``build/kernels``, and
``TORCH_EXTENSIONS_DIR`` and ``TRITON_CACHE_DIR`` beside them.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age() -> float:
    """Seconds since this process started (the kernel's start time, at the
    clock tick), or since this module began where /proc has none."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def finite(x):
    """x with every float that is not finite as None (JSON has none)."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [finite(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


def report(result: dict):
    """(the result's JSON line, the lines of standard error that end a
    run): the contract's keys first, ``checks`` last, and each number
    compared beside its limit."""
    result = dict(result)
    checks = result.pop("checks")
    out = {k: result.pop(k) for k in ("correct", "attempted", "failed",
                                      "metrics", "device")}
    out.update(result)
    out["checks"] = checks
    notes = [f"check {name}: {c['value']!r} limit {c['limit']!r} "
             f"(worst at {c['at']})" for name, c in checks.items()]
    return json.dumps(finite(out)), notes


def forbidden_modules(modules=None) -> list:
    """The FORBIDDEN top-level names among `modules` (default: loaded)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    os.environ["USE_FLAX"] = os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)

    from portbench.harness.cell import load_cell
    cell = load_cell(args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"card(s); this machine has {n}", file=sys.stderr)
        return 2

    driver = importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}")
    result = driver.run(cell, args.seed, args.seconds, bool(args.trace),
                        process_age)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    line, notes = report(result)
    for n in notes:
        print(n, file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
