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

Sharded trees (the trainer's mesh path): a ``DTensor`` leaf is saved
whole, gathered on every rank in leaf order, and only rank 0 writes, so
the format on disk is the same.  ``restore_checkpoint(...,
shardings=)`` places each leaf that has a sharding as a ``DTensor`` under
its placements, on the mesh it names: elastic resharding onto whatever
mesh the restart runs on (each rank reads the whole leaf and keeps its
shard).

Async: ``AsyncCheckpointer.save`` copies every leaf to host memory
synchronously (the trainer updates its tensors in place on the next
step; a sharded leaf's gather runs here, on the calling thread, in rank
order) and writes the files on a background thread.
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
import torch.distributed as dist

from repro_torch.tree import flatten, unflatten

Params = Any


def _is_dtensor(t: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _host(t: Any) -> torch.Tensor:
    """A CPU copy of a leaf (a tensor, a numpy array or a number) that
    later in-place updates of the leaf do not reach.  A DTensor is
    gathered whole first (a collective: every rank calls this)."""
    if _is_dtensor(t):
        t = t.full_tensor()
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", copy=True)
    return torch.as_tensor(np.array(t))


def _writer(flat: Dict[str, Any]) -> bool:
    """Whether this process writes the files of a tree: always, but for a
    tree with sharded leaves, where only rank 0 does."""
    return not any(_is_dtensor(v) for v in flat.values()) \
        or dist.get_rank() == 0


def _join_gathers(flat: Dict[str, Any]) -> None:
    """A rank that does not write: take part in each sharded leaf's
    gather, in leaf order, and keep nothing."""
    for v in flat.values():
        if _is_dtensor(v):
            v.full_tensor()


def _place(t: torch.Tensor, sharding: Any):
    """A whole leaf `t` (on the host) as a DTensor of `sharding` (a
    ``distributed.sharding.NamedSharding``): this rank's shard, on the
    mesh's device."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = sharding.mesh
    coord = mesh.get_coordinate()
    local = t
    for i, pl in enumerate(sharding.placements):
        if isinstance(pl, Shard) and mesh.size(i) > 1:
            local = local.chunk(mesh.size(i), dim=pl.dim)[coord[i]]
    local = local.contiguous().to(mesh.device_type)
    return DTensor.from_local(local, mesh, sharding.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


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
    """Synchronous save.  Returns the step directory.  A tree with
    DTensor leaves is gathered on every rank and written by rank 0."""
    flat = flatten(tree)
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not _writer(flat):
        _join_gathers(flat)
        return step_dir
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


def restore_checkpoint(ckpt_dir: str, step: int, like: Params,
                       shardings: Optional[Params] = None
                       ) -> Tuple[Params, Dict]:
    """Restore into the structure of `like` (a tree of tensors): each leaf
    read from its file and placed on the device of like's leaf at the same
    path, or, where `shardings` (a tree of
    ``distributed.sharding.NamedSharding`` matching `like`, None at a
    leaf left plain) gives one, as a DTensor under its placements: this
    is where elastic resharding happens.  Raises KeyError for a leaf the
    checkpoint lacks and ValueError for another shape or dtype.  Returns
    (tree, extra)."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    flat_shard = flatten(shardings) if shardings is not None else {}
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
        sh = flat_shard.get(name)
        out[name] = _place(t, sh) if sh is not None else t.to(ref.device)
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
        # place at the next step (and a sharded leaf's gather is a
        # collective: every rank runs it here, in leaf order)
        flat = flatten(tree)
        if not _writer(flat):
            _join_gathers(flat)
            return
        host_tree = unflatten(tree, {k: _host(v) for k, v in flat.items()})

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
