"""A cell's files, found by name under the benchmark's folder.

``workloads/<cell>.json`` names the configuration and the traffic and
holds the cell's limits; ``configs/<config>.json`` holds the model's
fields as the port's ``ModelConfig`` takes them, beside the keys in
:data:`META` that describe the configuration; ``traffic/<mix>.json``
names the driver (``drivers/<driver>.py``) and its parameters.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: keys of a configuration file that describe it and are not model fields
META = ("source", "paper", "deployment", "reduced", "assumed", "published",
        "notes")


def load_json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.name} under "
                                f"{ROOT.name}/{kind}")
    with open(path) as f:
        return json.load(f)


@dataclass(frozen=True)
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict

    @property
    def model(self) -> dict:
        """The configuration's model fields."""
        return {k: v for k, v in self.config.items() if k not in META}

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def load_cell(name: str) -> Cell:
    w = load_json("workloads", name)
    return Cell(name, w, load_json("configs", w["config"]),
                load_json("traffic", w["traffic"]))


def cell_names() -> list:
    return sorted(p.stem for p in (ROOT / "workloads").glob("*.json"))
