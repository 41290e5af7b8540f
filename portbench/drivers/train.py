"""The training driver: the port's ``Trainer`` at a cell's configuration,
batch and sequence length, one step a call, as its users train.

Set-up builds one ``Trainer`` (``repro_torch.launch.train``: forward,
autograd backward, clipping, the cosine schedule, AdamW), writes the
benchmark's weights into its parameters and gives it the benchmark's
token stream, then drives it through the checked steps with
``Trainer.train(1)``, the window's own call on the window's own feed.
Those steps warm every shape, and they are what the comparison reads:
each step's loss, the first step's clipped gradient (from AdamW's first
moment after one step, m = (1 - b1) g) and the parameters' change after
the last checked step, each leaf's norm.

The window then calls ``Trainer.train(1)`` until ``seconds`` have
passed; each call ends in the host's read of the step's loss, so its
work is done.  With ``trace`` a few more steps run under the profiler
after the window.  Then the program's state is freed and the reference
(``reference/train.py``) runs the checked steps from the same weights
and batches.
"""
from __future__ import annotations

import gc
import math
import subprocess
import sys
import time
import torch

from ..harness import compare, trace
from ..harness.inputs import TokenStream, make_weights
from ..reference.train import leaf_norm, train_steps
from ..work.model_flops import step_flops


def build(cell, seed: int, device: torch.device):
    """The Trainer of the cell, with the benchmark's weights and batches."""
    from repro_torch.launch.train import Trainer
    from repro_torch.models.config import ModelConfig
    from repro_torch.tree import flatten
    t = cell.traffic
    recipe = t["recipe"]
    if recipe["optimizer"] != "adamw":
        raise ValueError(f"the train driver runs AdamW, not "
                         f"{recipe['optimizer']}")
    model = cell.model
    S, B = t["seq_len"], t["batch"]
    cfg = ModelConfig(**dict(model, max_seq=max(model.get("max_seq", S), S)))
    tr = Trainer(cfg, optimizer="adamw", seq_len=S, global_batch=B,
                 seed=seed, peak_lr=recipe["peak_lr"], torch_device=device)
    tr.data = TokenStream(model["vocab_size"], S, B, seed,
                          **t.get("tokens", {}))
    weights = make_weights(model, seed, device)
    leaves = flatten(tr.params)
    mine = {k: (tuple(v.shape), v.dtype) for k, v in weights.items()}
    theirs = {k: (tuple(v.shape), v.dtype) for k, v in leaves.items()}
    if mine != theirs:
        odd = sorted(set(mine.items()) ^ set(theirs.items()))[:6]
        raise ValueError(f"the program's parameters differ from the "
                         f"configuration's: {odd}")
    with torch.no_grad():
        for k, v in leaves.items():
            v.copy_(weights[k])
    return tr


def checked_steps(tr, cell, seed: int, device: torch.device) -> dict:
    """The checked steps through ``Trainer.train(1)``, and the program's
    readings of them (as :func:`reference.train.train_steps` returns)."""
    from repro_torch.tree import flatten
    b1 = cell.traffic["recipe"].get("b1", 0.9)
    out: dict = {"loss": [], "grad": {}, "change": {}}
    for i in range(cell.traffic["checked_steps"]):
        out["loss"].append(tr.train(1, log_every=10 ** 9)["loss"][0])
        if i == 0:
            out["grad"] = {k: leaf_norm(m) / (1 - b1) for k, m in
                           flatten(tr.opt_state["m"]).items()}
    start = make_weights(cell.model, seed, device)
    leaves = flatten(tr.params)
    with torch.no_grad():
        out["change"] = {k: leaf_norm(v.detach(), start[k])
                         for k, v in leaves.items()}
    out["size"] = {k: v.numel() for k, v in leaves.items()}
    return out


def power_limit_w():
    """The card's power limit in watts from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=60)
        return float(out.stdout.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def reference_readings(cell, seed: int, device: torch.device,
                       precision: str = "f32", rows: int = 0,
                       decay_grad: float = 1.0) -> dict:
    """The reference's readings of the cell's checked steps from the
    seed's weights and batches (``reference.train.train_steps``)."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t = cell.traffic
    stream = TokenStream(cell.model["vocab_size"], t["seq_len"], t["batch"],
                         seed, **t.get("tokens", {}))
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in stream.batch(i).items()}
               for i in range(t["checked_steps"])]
    return train_steps(cell.model, make_weights(cell.model, seed, device),
                       batches, t["recipe"], precision, rows, decay_grad)


def traced(tr, n: int, attempts: int = 4) -> dict:
    """`n` steps under the profiler, taken again where the trace holds
    fewer kernel events than the ops' counters made (the profiler has lost
    records before); raises where it still does."""
    from ..harness.roofline import op_counters, shortfall, work_modules
    short = []
    for _ in range(attempts):
        rec = trace.profile(lambda: tr.train(1, log_every=10 ** 9), n,
                            op_counters)
        short = [s for w in work_modules() for s in shortfall(rec, w)]
        if not short:
            return rec
    lo, hi = rec["range"]
    inside = [trace.kernel_id(n) for n, a, b in rec["device"]
              if b > lo and a < hi]
    names = sorted({n: inside.count(n) for n in set(inside)}.items(),
                   key=lambda kv: -kv[1])[:12]
    raise RuntimeError(f"the profiler's kernel events differ from the "
                       f"launch counters in {attempts} traces: {short}; "
                       f"{len(rec['device'])} device events, "
                       f"{len(inside)} in the range, the most: {names}")


def run(cell, seed: int, seconds: float, trace_on: bool, process_age,
        device: str = "cuda") -> dict:
    """One run; returns the result's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, and with ``trace_on`` the
    ``breakdown``) and ``checks``.  `device` "cpu" runs it untraced on
    the host (the tests, at small sizes), with no memory peak."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize()
    t = cell.traffic
    B, S = t["batch"], t["seq_len"]
    tr = build(cell, seed, dev)
    prog = checked_steps(tr, cell, seed, dev)
    sync()
    setup_s = process_age()

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    attempted = failed = done = 0
    t0 = time.perf_counter()
    while True:
        attempted += 1
        try:
            loss = tr.train(1, log_every=10 ** 9)["loss"][0]
        except RuntimeError:
            failed += 1
            break
        if math.isfinite(loss):
            done += 1
        else:
            failed += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    result: dict = {}
    record = {"window": {"steps": done, "seconds": window_s},
              "model_flops_per_step": step_flops(cell.model, B, S)}
    if trace_on:
        record["trace"] = traced(tr, t.get("profiled_steps", 2))
    del tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    if trace_on:
        from ..harness.metrics import read_all
        result["metrics"] = read_all(record)
        result["breakdown"] = trace.breakdown(record["trace"])
    else:
        result["metrics"] = {
            "train_tokens_per_s": {"value": done * B * S / window_s,
                                   "unit": "tokens/s"},
            "peak_alloc_gb": {"value": peak / 1e9, "unit": "GB"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(peak)}
    if trace_on:
        device["busy_s"] = trace.busy_seconds(record["trace"])
        device["window_s"] = trace.window_seconds(record["trace"])
        # beside step_mfu: the peaks assume the full 700 W
        device["power_limit_w"] = power_limit_w()

    ref_t0 = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    ref = reference_readings(cell, seed, dev)
    if cuda:
        print(f"reference: {time.perf_counter() - ref_t0:.1f} s, "
              f"{held / 1e9:.2f} GB held before it, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
              file=sys.stderr)
    found = compare.gaps(prog, ref)
    ok, checks = compare.judge(found, cell.workload["limits"])
    result.update(correct=bool(ok and failed == 0), attempted=attempted,
                  failed=failed, device=device,
                  reference_s=time.perf_counter() - ref_t0,
                  readings={k: {"value": v, "at": at}
                            for k, (v, at) in found.items()
                            if k not in checks},
                  checks=checks)
    return result
