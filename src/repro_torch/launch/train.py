"""Production training driver.

The port of the reference's ``launch/train.py``: config registry ->
parameters -> data pipeline -> train step (forward_train, backward,
clipping at 1.0, the cosine schedule, the optimizer) -> async
checkpointing -> straggler watchdog -> restore.  The backward is
PyTorch's autograd; the attention's gradient is the flash_attention op's
backward and the Mamba2 and mLSTM scans' the gla_chunk op's, each a
hand-written kernel on the card.  Every config trains.  Parameters and
optimizer state are updated in place.  A step's phases (the batch, the
forward, the backward, clipping, the optimizer, the read of the loss) run
inside named spans (``repro_torch/trace.py``) that a profiler records.

``Trainer(mesh=, fsdp=)`` is the mesh path: one process a rank (the
caller makes the process group: ``nccl`` on separate cards, ``gloo`` on
the CPU or for ranks that share one card) over a ``DeviceMesh`` with
data axes and a "model" axis.  Parameters and the optimizer's moments
live as DTensors under ``param_specs`` / ``opt_state_specs``: sharded on
"model" (tensor and expert parallelism) where the specs say so, and
replicated on the data axes or, with ``fsdp=True``, sharded on them
(ZeRO-3).  A step (:func:`build_mesh_train_step`) takes this rank's rows
of the global batch (``batch_specs``) and gathers each parameter into a
plain tensor over every mesh axis but "model" for the leaves the layers
compute split over it (``sharding.model_split_leaves``: attention heads,
MLP hidden widths, the vocab, the experts), which stay this rank's
slice; the layers run the collectives over "model" themselves
(``distributed/meshctx.py``).  The mesh is the layers' ambient mesh only
inside the step (``meshctx.use_mesh``): the Trainer sets none for the
process, so a model call outside a step computes on whole weights, as on
one device.  The gradient is then reduced over the
axes that split the batch to each leaf's placement as a mean (leaf by
leaf, in path order): a leaf the layers compute split already has its
rank's slice of the gradient, and a leaf replicated over "model" has its
whole gradient on every model rank, so neither is summed over "model"
unless "model" splits the batch (the recurrent archs'
``dp_over_model``, where the config lists "model" among its data axes
and every model-sharded leaf is gathered whole).  Clipping takes the
global norm of the whole reduced gradient, and each rank updates its
shard in place (Adafactor's factored means and update clip reduced over
the leaf's shards).  The gathers and reductions are
``torch.distributed``'s collectives on plain tensors (``meshctx``),
never DTensor's functional ones, so two ``gloo`` ranks can share one card.
The CLI has no mesh flag, as the reference's.

Usage:
  python -m repro_torch.launch.train --arch llama3.2-3b --steps 4 \\
      --seq-len 4096 --batch 2
  python -m repro_torch.launch.train --arch zamba2-1.2b --steps 4 \\
      --seq-len 4096 --batch 2
  python -m repro_torch.launch.train --arch xlstm-1.3b --reduced \\
      --device cpu --steps 20
  python -m repro_torch.launch.train --arch olmo-1b --reduced \\
      --device cpu --steps 20 --ckpt-dir /tmp/ckpt

Without ``--device`` it runs on the card.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.configs import get_arch, reduced as reduce_cfg
from repro_torch.core.driver import TorchDeviceLike, resolve_torch_device
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.distributed import meshctx
from repro_torch.distributed.fault_tolerance import StepWatchdog
from repro_torch.distributed.sharding import (batch_specs,
                                              model_split_leaves,
                                              named_shardings,
                                              opt_state_specs, param_specs)
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (clip_by_global_norm, cosine_schedule,
                               make_optimizer)
from repro_torch.trace import (TRAIN_BACKWARD, TRAIN_BATCH, TRAIN_CLIP,
                               TRAIN_FORWARD, TRAIN_LOSS_READ,
                               TRAIN_OPTIMIZER, span)
from repro_torch.tree import flatten, map_tree, requires_grad_, unflatten


def build_train_step(cfg: ModelConfig, optimizer: str, peak_lr: float = 3e-4,
                     warmup: int = 100, total_steps: int = 10_000):
    """(opt_init, train_step): train_step(params, opt_state, batch, step)
    -> (params, opt_state, metrics), params and state updated in place.
    The params are a tree of leaf tensors that require grad."""
    opt_init, opt_update = make_optimizer(optimizer)

    def train_step(params, opt_state, batch, step):
        flat = flatten(params)
        with span(TRAIN_FORWARD):
            loss, metrics = T.forward_train(params, cfg, batch)
        with span(TRAIN_BACKWARD):
            grads = unflatten(params, dict(zip(flat, torch.autograd.grad(
                loss, list(flat.values())))))
        with span(TRAIN_CLIP):
            grads, gnorm = clip_by_global_norm(grads, 1.0)
        with span(TRAIN_OPTIMIZER):
            lr = cosine_schedule(step, warmup, total_steps, peak_lr)
            params, opt_state = opt_update(grads, opt_state, params, lr=lr)
        return params, opt_state, dict(
            {k: v.detach() for k, v in metrics.items()}, grad_norm=gnorm,
            lr=lr)

    return opt_init, train_step


# ----------------------------------------------------------------------
# the mesh path
# ----------------------------------------------------------------------
def _split_mesh_dims(mesh, spec) -> Tuple[int, ...]:
    """The mesh dims that `spec`'s dim-0 entry (a batch spec) splits."""
    entry = spec[0] if spec else None
    names = () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))
    return tuple(mesh.mesh_dim_names.index(a) for a in names)


def _rows(t: torch.Tensor, mesh, dims: Tuple[int, ...]) -> torch.Tensor:
    """This rank's rows of `t` split over mesh `dims` (major to minor)."""
    coord = mesh.get_coordinate()
    for i in dims:
        t = t.chunk(mesh.size(i), dim=0)[coord[i]]
    return t


def _from_local(local: torch.Tensor, sharding):
    """A DTensor of `sharding` from this rank's shard (no communication:
    the global shape follows from the placements)."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = sharding.mesh
    shape = list(local.shape)
    for i, pl in enumerate(sharding.placements):
        if isinstance(pl, Shard):
            shape[pl.dim] *= mesh.size(i)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, sharding.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _distribute(full: torch.Tensor, sharding):
    """`full` (the same on every rank) as a DTensor of `sharding`: each
    rank keeps its shard (a copy, so the whole tensor can be freed)."""
    from torch.distributed.tensor import Shard
    mesh = sharding.mesh
    coord = mesh.get_coordinate()
    local = full
    for i, pl in enumerate(sharding.placements):
        if isinstance(pl, Shard) and mesh.size(i) > 1:
            local = local.chunk(mesh.size(i), dim=pl.dim)[coord[i]]
    if local is not full:
        local = local.clone(memory_format=torch.contiguous_format)
    return _from_local(local, sharding)


def _gather(v, keep: Tuple[int, ...]) -> torch.Tensor:
    """The DTensor v as a plain tensor gathered over every mesh dim it is
    sharded on but those in `keep` (minor dims first, so that two mesh
    dims sharding one tensor dim come back in order)."""
    from torch.distributed.tensor import Shard
    mesh = v.device_mesh
    local = v.to_local()
    for i in reversed(range(mesh.ndim)):
        pl = v.placements[i]
        if isinstance(pl, Shard) and i not in keep and mesh.size(i) > 1:
            ax = meshctx.axis_of(mesh, mesh.mesh_dim_names[i])
            local = meshctx.all_gather_blocks(local, ax, pl.dim)
    return local.contiguous()


def _reduce_grad(g: torch.Tensor, sharding, split: Tuple[int, ...],
                 n: int, keep: Tuple[int, ...] = ()) -> torch.Tensor:
    """This rank's shard of the mean gradient: `g` (the gradient over
    this rank's rows of the leaf as the model used it: whole, or its
    slice on the mesh dims in `keep`) summed over the mesh dims in
    `split` (all-reduce, or reduce-scatter onto a Shard placement), cut to
    its shard on the other sharded dims, divided by `n`."""
    from torch.distributed.tensor import Shard
    mesh = sharding.mesh
    coord = mesh.get_coordinate()
    for i, pl in enumerate(sharding.placements):
        size = mesh.size(i)
        if i in keep or size == 1:
            continue
        ax = meshctx.axis_of(mesh, mesh.mesh_dim_names[i])
        if isinstance(pl, Shard):
            if i in split:
                g = meshctx.reduce_scatter_blocks(g, ax, pl.dim)
            else:
                g = g.chunk(size, dim=pl.dim)[coord[i]]
        elif i in split:
            g = meshctx.all_reduce_sum(g, ax)
    g = g.contiguous()
    return g.div_(n) if n > 1 else g


def _shard_axes(sharding) -> Dict[int, List[Any]]:
    """{tensor dim: the mesh axes a leaf's stored shard is split over
    along it} (Adafactor's sharded moments)."""
    from torch.distributed.tensor import Shard
    mesh = sharding.mesh
    out: Dict[int, List[Any]] = {}
    for i, pl in enumerate(sharding.placements):
        if isinstance(pl, Shard) and mesh.size(i) > 1:
            out.setdefault(pl.dim, []).append(
                meshctx.axis_of(mesh, mesh.mesh_dim_names[i]))
    return out


def _sharded_sq_reducer(shardings: Dict[str, Any]):
    """reduce_sq for clip_by_global_norm on a mesh: each leaf's sum of
    squares summed over the mesh dims it is sharded on (one all-reduce
    per mesh dim of the leaves sharded the same way)."""
    from torch.distributed.tensor import Shard

    def reduce_sq(sq: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        groups: Dict[Tuple[int, ...], List[str]] = {}
        for k, sh in shardings.items():
            dims = tuple(i for i, pl in enumerate(sh.placements)
                         if isinstance(pl, Shard))
            if dims:
                groups.setdefault(dims, []).append(k)
        out = dict(sq)
        for dims, keys in sorted(groups.items()):
            mesh = shardings[keys[0]].mesh
            vec = torch.stack([sq[k] for k in keys])
            for i in dims:
                dist.all_reduce(vec, op=dist.ReduceOp.SUM,
                                group=mesh.get_group(i))
            out.update(zip(keys, vec.unbind(0)))
        return out

    return reduce_sq


def build_mesh_grad_fn(cfg: ModelConfig, mesh, p_shard: Any,
                       model_split: Optional[Dict[str, bool]] = None):
    """grad_fn(params, batch) -> (metrics, grads) on `mesh`: params a
    tree of DTensors under `p_shard` (a tree of NamedSharding), batch the
    global batch (the same on every rank); metrics the global batch's
    (means over the ranks' rows), grads a tree of this rank's shards of
    the mean gradient (each leaf's placement).  `model_split` ({leaf
    path: bool}, ``sharding.model_split_leaves``) names the leaves the
    layers compute split over "model": they keep their slice on it."""
    flat_sh = flatten(p_shard)
    model_split = model_split or {}
    names_ = mesh.mesh_dim_names
    model_dim = names_.index(cfg.sharding.model_axis) \
        if cfg.sharding.model_axis in names_ else None
    keep = {k: (model_dim,) if model_split.get(k) else ()
            for k in flat_sh}

    def grad_fn(params, batch):
        specs = batch_specs(batch, cfg, mesh)
        split = _split_mesh_dims(mesh, specs["targets"])
        n = 1
        for i in split:
            n *= mesh.size(i)
        local = {k: _rows(v, mesh, _split_mesh_dims(mesh, specs[k]))
                 for k, v in batch.items()}
        # each rank's loss is the mean over its rows' counted targets:
        # weighted by its share of the global count, the ranks' mean is
        # the global batch's mean (weight 1 where the shares are equal)
        if batch["targets"].is_meta:
            weight = 1.0        # the dry run's batch: every target counts
        else:
            counted = int((batch["targets"] >= 0).sum())
            weight = int((local["targets"] >= 0).sum()) * n / max(counted,
                                                                  1)

        flat_p = flatten(params)
        with torch.no_grad():
            full = {k: _gather(v, keep[k]).detach()
                    for k, v in flat_p.items()}
        for t in full.values():
            t.requires_grad_(True)
        names = list(full)
        with meshctx.use_mesh(mesh, batch_axes=[names_[i] for i in split]):
            loss, metrics = T.forward_train(unflatten(params, full), cfg,
                                            local)
            obj = loss if weight == 1.0 else loss * weight
            gl = list(torch.autograd.grad(obj, [full[k] for k in names]))
        del full, obj, loss
        grads = {}
        for j, k in enumerate(names):
            grads[k] = _reduce_grad(gl[j], flat_sh[k], split, n, keep[k])
            gl[j] = None
        out = {}
        for k, v in metrics.items():
            v = v.detach().to(torch.float32).clone()
            if weight != 1.0:
                v = v * weight
            for i in split:
                dist.all_reduce(v, op=dist.ReduceOp.SUM,
                                group=mesh.get_group(i))
            out[k] = v / n if n > 1 else v
        return out, unflatten(params, grads)

    return grad_fn


def build_mesh_train_step(cfg: ModelConfig, optimizer: str, mesh,
                          p_shard: Any, model_split: Optional[Dict[str, bool]]
                          = None, peak_lr: float = 3e-4, warmup: int = 100,
                          total_steps: int = 10_000):
    """train_step(params, opt_state, batch, step) -> (params, opt_state,
    metrics) on `mesh`: the gradient of :func:`build_mesh_grad_fn`,
    clipped by its global norm, then each rank's shards updated in place
    (params DTensors under `p_shard`, the optimizer's moments DTensors of
    the same placements, its count a host scalar), as build_train_step's."""
    _, opt_update = make_optimizer(optimizer)
    flat_sh = flatten(p_shard)
    grad_fn = build_mesh_grad_fn(cfg, mesh, p_shard, model_split)
    reduce_sq = _sharded_sq_reducer(flat_sh)
    opt_kw = {}
    if optimizer == "adafactor":
        opt_kw["sharded"] = {k: _shard_axes(sh) for k, sh in flat_sh.items()}

    def train_step(params, opt_state, batch, step):
        metrics, grads = grad_fn(params, batch)
        grads, gnorm = clip_by_global_norm(grads, 1.0, reduce_sq)
        lr = cosine_schedule(step, warmup, total_steps, peak_lr)
        with torch.no_grad():
            local_p = map_tree(lambda v: v.to_local(), params)
            state = {k: map_tree(lambda v: v.to_local(), v)
                     if k != "count" else v for k, v in opt_state.items()}
        _, state = opt_update(grads, state, local_p, lr=lr, **opt_kw)
        opt_state = dict(opt_state, count=state["count"])
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return train_step


class Trainer:
    """Trainer on `torch_device` (default the card).  The parameters are
    drawn from `seed` (``transformer.init_params``: the reference's
    distributions, not its numbers; the same on every rank);
    ``maybe_restore`` takes them, and the optimizer state, from the
    latest checkpoint, the reference's included.

    `mesh` (a ``DeviceMesh`` from ``launch.mesh.make_mesh``, on
    `torch_device`'s type) takes the mesh path (module docstring): data
    parallelism over its data axes, tensor and expert parallelism over
    its "model" axis; `fsdp` shards parameters and moments over its data
    axes.  Without a mesh `fsdp` is ignored, as the reference ignores
    it."""

    def __init__(self, cfg: ModelConfig, optimizer: str = "adamw",
                 seq_len: int = 128, global_batch: int = 8,
                 ckpt_dir: Optional[str] = None, seed: int = 0,
                 mesh=None, fsdp: bool = False, peak_lr: float = 3e-4,
                 torch_device: TorchDeviceLike = None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_torch_device(torch_device)
        self.watchdog = StepWatchdog()
        self.ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
        self.data = SyntheticLMDataset(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq_len,
            global_batch=global_batch, seed=seed))
        self.p_shard = self.o_shard = self.model_split = None
        if mesh is not None:
            self._init_mesh(optimizer, seed, fsdp, peak_lr)
        else:
            opt_init, self.step_fn = build_train_step(cfg, optimizer,
                                                      peak_lr=peak_lr)
            self.params = requires_grad_(
                T.init_params(cfg, seed, self.device).tree())
            self.opt_state = opt_init(self.params)
        self.step = 0

    def _init_mesh(self, optimizer: str, seed: int, fsdp: bool,
                   peak_lr: float) -> None:
        cfg, mesh = self.cfg, self.mesh
        if mesh.device_type != self.device.type:
            raise ValueError(f"the mesh is on {mesh.device_type}, the "
                             f"trainer on {self.device}")
        opt_init, _ = make_optimizer(optimizer)
        full = T.init_params(cfg, seed, self.device).tree()
        p_specs = param_specs(full, cfg, mesh, fsdp=fsdp)
        self.p_shard = named_shardings(p_specs, mesh)
        self.model_split = model_split_leaves(p_specs, cfg, mesh)
        self.params = map_tree(_distribute, full, self.p_shard)
        del full
        with torch.no_grad():
            local = opt_init(map_tree(lambda v: v.to_local(), self.params))
        o_specs = opt_state_specs(local, p_specs, self.params)
        # the step count stays a host scalar, as on one device
        self.o_shard = dict(named_shardings(o_specs, mesh), count=None)
        self.opt_state = {
            k: v if k == "count" else map_tree(_from_local, v,
                                               self.o_shard[k])
            for k, v in local.items()}
        self.step_fn = build_mesh_train_step(cfg, optimizer, mesh,
                                             self.p_shard, self.model_split,
                                             peak_lr=peak_lr)

    # ------------------------------------------------------------------
    def maybe_restore(self) -> bool:
        if self.ckpt is None:
            return False
        s = latest_step(self.ckpt.ckpt_dir)
        if s is None:
            return False
        tree = {"params": self.params, "opt_state": self.opt_state}
        shard = ({"params": self.p_shard, "opt_state": self.o_shard}
                 if self.p_shard is not None else None)
        restored, extra = restore_checkpoint(self.ckpt.ckpt_dir, s, tree,
                                             shardings=shard)
        self.params = restored["params"] if shard is not None \
            else requires_grad_(restored["params"])
        self.opt_state = restored["opt_state"]
        self.step = int(extra.get("step", s))
        return True

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The data pipeline's batch of `step` as tensors on the device."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.data.batch(step).items()}

    def train(self, steps: int, log_every: int = 10,
              ckpt_every: int = 200) -> Dict[str, List]:
        """`steps` steps from ``self.step``; returns the history of
        losses, gradient norms (before clipping), steps and step seconds
        (host clock, ending in the host's read of the loss)."""
        history: Dict[str, List] = {"loss": [], "grad_norm": [], "step": [],
                                    "seconds": []}
        for _ in range(steps):
            with span(TRAIN_BATCH):
                batch = self.batch(self.step)
            self.watchdog.start_step()
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch, self.step)
            with span(TRAIN_LOSS_READ):
                loss = float(metrics["loss"])
            history["seconds"].append(time.perf_counter() - t0)
            self.watchdog.end_step(self.step)
            if self.step % log_every == 0:
                print(f"step {self.step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
            history["loss"].append(loss)
            history["grad_norm"].append(float(metrics["grad_norm"]))
            history["step"].append(self.step)
            self.step += 1
            if self.ckpt and self.step % ckpt_every == 0:
                self.ckpt.save(self.step,
                               {"params": self.params,
                                "opt_state": self.opt_state},
                               extra={"step": self.step})
        if self.ckpt:
            self.ckpt.save(self.step, {"params": self.params,
                                       "opt_state": self.opt_state},
                           extra={"step": self.step})
            self.ckpt.wait()
            if self.mesh is not None:
                dist.barrier()      # rank 0 has published the checkpoint
        return history


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    cfg = reduce_cfg(spec.model) if args.reduced else spec.model
    cfg = cfg.replace(max_seq=max(cfg.max_seq, args.seq_len))
    tr = Trainer(cfg, optimizer=spec.optimizer, seq_len=args.seq_len,
                 global_batch=args.batch, ckpt_dir=args.ckpt_dir,
                 peak_lr=args.lr, torch_device=args.device)
    if tr.maybe_restore():
        print(f"restored from step {tr.step}")
    hist = tr.train(args.steps)
    tokens = args.batch * args.seq_len
    med = float(np.median(hist["seconds"][1:] or hist["seconds"]))
    print(f"final loss {hist['loss'][-1]:.4f} "
          f"(start {hist['loss'][0]:.4f}); step {med * 1e3:.1f} ms median, "
          f"{tokens / med:.0f} tokens/s on {tr.device}")


if __name__ == "__main__":
    main()
