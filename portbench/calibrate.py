"""The readings that a cell's limits are set from, on the card at the
cell's own size (no measured window: training's readings need none).

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--fault-seeds 7,8,9] \\
        [--witness-seeds 1,2] [--out FILE]

For each seed of ``--seeds``: the program's checked steps (the driver's
own set-up) against the reference, the gaps that ``correct`` compares.
For each of ``--control-seeds``: the reference in fp8 (the control: every
matrix product's operands rounded to float8 e4m3, the precision below the
configuration's bfloat16) in the program's place.  For each of
``--fault-seeds``: the reference with half of each batch left out, the
mean taken over the rest, and the reference with the scan's log-decay
gradient left out.  A step that leaves its state unchanged reads a gap
of 1 in ``grad``, ``grad_small`` and ``change`` by construction and needs
no run.  For each of ``--witness-seeds``, two witnesses of what bfloat16
does to the readings: the program with the configuration's dtype set to
float32, against the reference from the same float32 weights; and the
reference with every product's operands and incoming gradients rounded
to bfloat16.  One JSON line a reading, also appended to ``--out``.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from portbench.drivers.train import build, checked_steps, \
        reference_readings
    from portbench.harness.cell import Cell, load_cell
    from portbench.harness.compare import gaps, leaf_gaps

    cell = load_cell(args.workload)
    t = cell.traffic
    dev = torch.device("cuda")

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    def reference(seed, precision="f32", rows=0, decay_grad=1.0,
                  at=cell):
        t0 = time.perf_counter()
        out = reference_readings(at, seed, dev, precision, rows, decay_grad)
        return out, time.perf_counter() - t0

    def emit(kind, seed, got, ref, seconds):
        found = gaps(got, ref)
        line = {"cell": cell.name, "kind": kind, "seed": seed,
                "seconds": seconds,
                "gaps": {k: v[0] for k, v in found.items()},
                "at": {k: v[1] for k, v in found.items()},
                "grad_leaves": leaf_gaps(got["grad"], ref["grad"],
                                         sorted(ref["grad"])),
                "change_leaves": leaf_gaps(got["change"], ref["change"],
                                           sorted(ref["change"])),
                "ref_grad": ref["grad"], "loss_steps": [got["loss"],
                                                        ref["loss"]]}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")

    def program(seed, at=cell):
        t0 = time.perf_counter()
        tr = build(at, seed, dev)
        prog = checked_steps(tr, at, seed, dev)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        return prog, time.perf_counter() - t0

    refs = {}
    for seed in ints(args.seeds):
        prog, prog_s = program(seed)
        refs[seed], ref_s = reference(seed)
        emit("program", seed, prog, refs[seed], [prog_s, ref_s])
    f32 = Cell(cell.name, cell.workload, dict(cell.config, dtype="float32"),
               t)
    for seed in ints(args.witness_seeds):
        prog, prog_s = program(seed, f32)
        ref, ref_s = reference(seed, at=f32)
        emit("program_float32", seed, prog, ref, [prog_s, ref_s])
    for kind, seeds, kw in (("control", ints(args.control_seeds),
                             {"precision": "fp8"}),
                            ("half_batch", ints(args.fault_seeds)
                             if t["batch"] > 1 else [],
                             {"rows": t["batch"] // 2}),
                            ("decay_grad_left_out", ints(args.fault_seeds),
                             {"decay_grad": 0.0}),
                            ("reference_bf16", ints(args.witness_seeds),
                             {"precision": "bf16"})):
        for seed in seeds:
            if seed not in refs:
                refs[seed], _ = reference(seed)
            got, s = reference(seed, **kw)
            emit(kind, seed, got, refs[seed], s)
    print(json.dumps({"peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
