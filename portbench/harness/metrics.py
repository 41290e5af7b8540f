"""The per-layer readers under ``metrics/``, found by file name."""
from __future__ import annotations

import importlib

from .cell import ROOT


def readers() -> list:
    """Each reader module under metrics/, in name order."""
    return [importlib.import_module(f"portbench.metrics.{p.stem}")
            for p in sorted((ROOT / "metrics").glob("*.py"))
            if not p.stem.startswith("_")]


def read_all(record: dict) -> dict:
    """{name: {"value", "unit"}} of every reader that finds something to
    read in `record`; the others are left out."""
    out = {}
    for r in readers():
        v = r.read(record)
        if v is not None:
            out[r.NAME] = {"value": float(v), "unit": r.UNIT}
    return out
