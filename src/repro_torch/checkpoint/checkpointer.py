"""Checkpoints in the reference's on-disk format, with async save.

The port of the reference's ``checkpoint/checkpointer.py``.  Format: one
directory per step (``step_%08d``, published by an atomic rename of its
``.tmp``), one ``.npy`` per leaf of the tree, named by the leaf's path
(keys joined by ``/``, sorted at every level, as JAX flattens a dict)
with every character outside ``[A-Za-z0-9_.-]`` replaced by ``_``, and a
``manifest.json`` of {"step", "leaves": {path: {"file", "shape",
"dtype"}}, "extra"}.  A checkpoint written by either package restores
into the other's trainer.

bfloat16 leaves: the reference's numpy arrays (``ml_dtypes``) are saved
by ``np.save`` as their 2-byte patterns under the header type ``<V2``,
with ``"bfloat16"`` in the manifest.  The port writes and reads the same
bytes and header without ``ml_dtypes``: a tensor's bits through an int16
view.  Restore places each leaf on the device of the leaf it replaces and
raises for a missing leaf or another shape or dtype.

Async: ``AsyncCheckpointer.save`` copies every leaf to host memory
synchronously (the trainer updates its tensors in place on the next
step) and writes the files on a background thread.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten, unflatten

Params = Any


def _host(t: Any) -> torch.Tensor:
    """A CPU copy of a leaf (a tensor, a numpy array or a number) that
    later in-place updates of the leaf do not reach."""
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", copy=True)
    return torch.as_tensor(np.array(t))


def _save_leaf(path: str, t: torch.Tensor) -> str:
    """Write one leaf; returns its manifest dtype."""
    if t.dtype == torch.bfloat16:
        raw = t.contiguous().view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(f, {
                "descr": "<V2", "fortran_order": False,
                "shape": tuple(raw.shape)})
            f.write(raw.tobytes())
        return "bfloat16"
    arr = t.contiguous().numpy()
    np.save(path, arr)
    return str(arr.dtype)


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)         # C-contiguous, 0-d leaves kept 0-d
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(ckpt_dir: str, step: int, tree: Params,
                    extra: Optional[Dict] = None) -> str:
    """Synchronous save.  Returns the step directory."""
    flat = flatten(tree)
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp_dir = step_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for name, leaf in flat.items():
        t = _host(leaf)
        fname = re.sub(r"[^A-Za-z0-9_.-]", "_", name) + ".npy"
        dtype = _save_leaf(os.path.join(tmp_dir, fname), t)
        manifest["leaves"][name] = {
            "file": fname, "shape": list(t.shape), "dtype": dtype}
    with open(os.path.join(tmp_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.rename(tmp_dir, step_dir)   # atomic publish: no torn checkpoints
    return step_dir


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like: Params
                       ) -> Tuple[Params, Dict]:
    """Restore into the structure of `like` (a tree of tensors): each leaf
    read from its file and placed on the device of like's leaf at the same
    path.  Raises KeyError for a leaf the checkpoint lacks and ValueError
    for another shape or dtype.  Returns (tree, extra)."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for name, ref in flatten(like).items():
        meta = manifest["leaves"].get(name)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {name}")
        t = _load_leaf(os.path.join(step_dir, meta["file"]), meta["dtype"])
        if list(t.shape) != list(ref.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(t.shape)} != "
                             f"expected {tuple(ref.shape)}")
        if t.dtype != ref.dtype:
            raise ValueError(f"{name}: checkpoint dtype {t.dtype} != "
                             f"expected {ref.dtype}")
        out[name] = t.to(ref.device)
    return unflatten(like, out), manifest.get("extra", {})


class AsyncCheckpointer:
    """Background-thread writer with at-most-one pending save."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            raise self.last_error

    def save(self, step: int, tree: Params,
             extra: Optional[Dict] = None) -> None:
        self.wait()
        # copy to the host now: the trainer overwrites its tensors in
        # place at the next step
        host_tree = unflatten(tree, {k: _host(v)
                                     for k, v in flatten(tree).items()})

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree, extra)
                self._gc()
            except Exception as e:   # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self) -> None:
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.ckpt_dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
