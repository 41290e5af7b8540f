"""The comparison that decides ``correct`` for a training cell.

Relative gaps between the program's readings and the reference's, each
compared number held to the limit the cell's workload file states:

- ``grad``: the largest, over the leaves of at least :data:`BIG`
  elements, of the gap between the norms of the first step's clipped
  gradient, | |g_p| - |g_r| |, over the larger of the reference leaf's
  norm and the median leaf's (the median over every leaf);
- ``grad_small``: the same over the leaves of fewer than BIG elements:
  the scan's own parameters (``A_log``, ``dt_bias``, ``D``, the conv) and
  the norm scales, whose gradients are sums over every token;
- ``change``: the same for the norm of each leaf's change after the
  checked steps, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf with no gradient moves by its
  weight decay alone, to rounding).

The two ``grad`` numbers are apart because their readings are: on the
card the small leaves' gaps in sound runs swing tenfold from seed to seed
and the fp8 control reads no more there, while over the large leaves the
control reads ten times what sound runs do (PERF.md).  ``loss``, the
largest over the checked steps of |loss_p - loss_r| / |loss_r|, is read
and reported, not compared: neither the control nor a fault reads it
three (ten) times what sound runs read.  A reading that is not finite is
a gap of infinity.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

#: the fewest elements of a leaf that ``grad`` compares
BIG = 1 << 20


def _gap(a: float, b: float, floor: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), floor, 1e-30)


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keys: List[str]) -> List[Tuple[float, str]]:
    """[(gap, leaf)] over `keys`, the largest first, each gap over the
    larger of the leaf's and the median leaf's reference norm; [(inf,
    ...)] where the two sides name different leaves."""
    if set(prog) != set(ref):
        return [(math.inf, "leaves differ")]
    med = statistics.median(ref.values()) if ref else 0.0
    return sorted(((_gap(prog[k], ref[k], med), k) for k in keys),
                  key=lambda gk: -gk[0])


def _worst(prog: Dict[str, float], ref: Dict[str, float],
           keys: List[str]) -> Tuple[float, str]:
    return (leaf_gaps(prog, ref, keys) or [(0.0, "")])[0]


def gaps(prog: dict, ref: dict) -> Dict[str, Tuple[float, str]]:
    """{number: (gap, where)} of a program's readings against the
    reference's (each {"loss": [...], "grad": {leaf: norm}, "change":
    {leaf: norm}})."""
    out: Dict[str, Tuple[float, str]] = {}
    lp, lr = prog["loss"], ref["loss"]
    if len(lp) != len(lr):
        out["loss"] = (math.inf, f"{len(lp)} steps against {len(lr)}")
    else:
        worst = max((_gap(a, b, 0.0), i) for i, (a, b) in
                    enumerate(zip(lp, lr)))
        out["loss"] = (worst[0], f"step {worst[1] + 1}")
    big = sorted(k for k, n in ref["size"].items() if n >= BIG)
    small = sorted(set(ref["size"]) - set(big))
    out["grad"] = _worst(prog["grad"], ref["grad"], big)
    out["grad_small"] = _worst(prog["grad"], ref["grad"], small)
    med = statistics.median(ref["grad"].values())
    moved = sorted(k for k, g in ref["grad"].items() if g >= 1e-3 * med)
    out["change"] = _worst(prog["change"], ref["change"], moved)
    return out


def judge(found: Dict[str, Tuple[float, str]],
          limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {number: {"value", "limit", "at"}}) of the numbers that
    `limits` names: correct when each is finite and at most its limit."""
    checks = {k: {"value": found[k][0], "limit": limits[k],
                  "at": found[k][1]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
