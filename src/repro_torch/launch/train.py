"""Single-process training driver.

The port of the reference's ``launch/train.py`` for one device: config
registry -> parameters -> data pipeline -> train step (forward_train,
backward, clipping at 1.0, the cosine schedule, the optimizer) -> async
checkpointing -> straggler watchdog -> restore.  The backward is
PyTorch's autograd; the attention's gradient is the flash_attention op's
backward and the Mamba2 and mLSTM scans' the gla_chunk op's, each a
hand-written kernel on the card.  Every config trains.  Parameters and
optimizer state are updated in place.  Trainer's mesh and FSDP arguments
(the reference's multi-device path) raise ValueError until they are
ported (ROADMAP Queue 1 item 6); the CLI has no flags for them yet.

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
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.configs import get_arch, reduced as reduce_cfg
from repro_torch.core.driver import TorchDeviceLike, resolve_torch_device
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.distributed.fault_tolerance import StepWatchdog
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import (clip_by_global_norm, cosine_schedule,
                               make_optimizer)
from repro_torch.tree import flatten, requires_grad_, unflatten


def build_train_step(cfg: ModelConfig, optimizer: str, peak_lr: float = 3e-4,
                     warmup: int = 100, total_steps: int = 10_000):
    """(opt_init, train_step): train_step(params, opt_state, batch, step)
    -> (params, opt_state, metrics), params and state updated in place.
    The params are a tree of leaf tensors that require grad."""
    opt_init, opt_update = make_optimizer(optimizer)

    def train_step(params, opt_state, batch, step):
        loss, metrics = T.forward_train(params, cfg, batch)
        flat = flatten(params)
        grads = unflatten(params, dict(zip(flat, torch.autograd.grad(
            loss, list(flat.values())))))
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        lr = cosine_schedule(step, warmup, total_steps, peak_lr)
        params, opt_state = opt_update(grads, opt_state, params, lr=lr)
        return params, opt_state, dict(
            {k: v.detach() for k, v in metrics.items()}, grad_norm=gnorm,
            lr=lr)

    return opt_init, train_step


class Trainer:
    """Single-process trainer on `torch_device` (default the card).  The
    parameters are drawn from `seed` (``transformer.init_params``: the
    reference's distributions, not its numbers); ``maybe_restore`` takes
    them, and the optimizer state, from the latest checkpoint, the
    reference's included."""

    def __init__(self, cfg: ModelConfig, optimizer: str = "adamw",
                 seq_len: int = 128, global_batch: int = 8,
                 ckpt_dir: Optional[str] = None, seed: int = 0,
                 mesh=None, fsdp: bool = False, peak_lr: float = 3e-4,
                 torch_device: TorchDeviceLike = None):
        if mesh is not None or fsdp:
            raise ValueError("the mesh and FSDP are not ported yet (ROADMAP "
                             "Queue 1 item 6): the trainer runs on one "
                             "device")
        self.cfg = cfg
        self.device = resolve_torch_device(torch_device)
        self.watchdog = StepWatchdog()
        self.ckpt = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
        self.data = SyntheticLMDataset(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq_len,
            global_batch=global_batch, seed=seed))
        opt_init, self.step_fn = build_train_step(cfg, optimizer,
                                                  peak_lr=peak_lr)
        self.params = requires_grad_(
            T.init_params(cfg, seed, self.device).tree())
        self.opt_state = opt_init(self.params)
        self.step = 0

    # ------------------------------------------------------------------
    def maybe_restore(self) -> bool:
        if self.ckpt is None:
            return False
        s = latest_step(self.ckpt.ckpt_dir)
        if s is None:
            return False
        tree = {"params": self.params, "opt_state": self.opt_state}
        restored, extra = restore_checkpoint(self.ckpt.ckpt_dir, s, tree)
        self.params = requires_grad_(restored["params"])
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
        losses, steps and step seconds (host clock, ending in the host's
        read of the loss)."""
        history: Dict[str, List] = {"loss": [], "step": [], "seconds": []}
        for _ in range(steps):
            batch = self.batch(self.step)
            self.watchdog.start_step()
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch, self.step)
            loss = float(metrics["loss"])
            history["seconds"].append(time.perf_counter() - t0)
            self.watchdog.end_step(self.step)
            if self.step % log_every == 0:
                print(f"step {self.step:5d} loss {loss:.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)
            history["loss"].append(loss)
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
