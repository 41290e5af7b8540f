"""Batched LM serving: a continuous-batching decode loop.

The port of the reference's ``launch/serve.py``: prefill new requests into
free cache slots, run batched decode steps, emit tokens, retire finished
sequences.  The int8 path (``--quantized``) runs every layer-stack linear
through the VTA GEMM semantics (``vta_gemm``, dequant epilogue) — the
paper's PTQ deployment applied to LM serving.  Prefill attention runs
``flash_attention`` and decode attention ``decode_attention``, and a
Mamba2 layer's prefill (zamba2-1.2b) and an mLSTM layer's (xlstm-1.3b,
chunk 512) the chunked scan ``gla_chunk``; on the card each is its CUDA
kernel.  Every cache a slot holds (the KV caches; Mamba2's conv and SSM
states with the shared block's KV cache; the mLSTM's (C | n) state and
the sLSTM's c, n and h, float32) is stacked over layers with the batch
on axis 1, and a prefilled slot is spliced in along that axis: a fresh
slot's sLSTM state starts from n = 1, as its one-row cache does.

Like the reference, one decode step runs every slot at one position, the
largest of the slots' positions (``max(slot_pos)``): a request admitted
while another slot is further on attends over the zero rows between its
prompt and that position.  The port keeps that, so its tokens equal the
reference's.

Usage:
  python -m repro_torch.launch.serve --arch llama3.2-3b --quantized
  python -m repro_torch.launch.serve --arch llama3.2-3b --reduced \\
      --device cpu --requests 6 --max-new 16
  python -m repro_torch.launch.serve --arch zamba2-1.2b --reduced \\
      --device cpu --quantized
  python -m repro_torch.launch.serve --arch xlstm-1.3b --reduced \\
      --device cpu --quantized
  python -m repro_torch.launch.serve --arch phi-3-vision-4.2b --reduced \\
      --device cpu --quantized

phi-3-vision is served on tokens alone, as the reference's CLI serves
it; whisper-large-v3 is refused (its prefill needs frames: serve it
through ``transformer.prefill`` and ``decode_step``).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced as reduce_cfg
from repro_torch.core.driver import TorchDeviceLike, resolve_torch_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.quantized import quantize_params


@dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new: int
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


def _tensors(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensors(v)
        else:
            yield v


class ServeEngine:
    """Fixed-batch engine with slot recycling (continuous batching).
    Caches of `dtype` live on `torch_device` (default the card), where the
    weights must already be.  Requests are tokens alone: phi-3-vision is
    served without image patches, as the reference serves it, and an
    encoder-decoder (whisper), whose prefill needs frames, is refused
    with ValueError (the reference's engine has no frames path either;
    serve whisper through ``transformer.prefill`` and ``decode_step``)."""

    def __init__(self, cfg: ModelConfig, params, batch_slots: int = 4,
                 max_len: int = 256, dtype: torch.dtype = torch.float32,
                 torch_device: TorchDeviceLike = None):
        if cfg.encoder_layers:
            raise ValueError(f"{cfg.name} is an encoder-decoder: its "
                             f"prefill needs frames, which ServeEngine's "
                             f"token requests do not carry")
        self.device = resolve_torch_device(torch_device)
        self.cfg = cfg
        self.params = params.tree() if isinstance(params, T.LMParams) \
            else params
        for t in _tensors(self.params):
            if t.device.type != self.device.type:
                raise ValueError(f"weights on {t.device}, engine on "
                                 f"{self.device}")
        self.B = batch_slots
        self.max_len = max_len
        self.dtype = dtype
        with torch.inference_mode():
            self.caches = T.init_caches(cfg, batch_slots, max_len, dtype,
                                        self.device)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, np.int32)

    def next_tokens(self, logits: torch.Tensor) -> List[int]:
        """Greedy choice from (rows, V) logits: the first index of the
        largest logit in each row."""
        return torch.argmax(logits, dim=-1).tolist()

    # -- single-slot prefill: runs the prompt with batch=1 caches then
    #    copies the slot in (slot-granular continuous batching) ----------
    def add_request(self, req: Request) -> bool:
        try:
            slot = self.slot_req.index(None)
        except ValueError:
            return False
        with torch.inference_mode():
            tmp = T.init_caches(self.cfg, 1, self.max_len, self.dtype,
                                self.device)
            tokens = torch.as_tensor(np.asarray(req.prompt)[None, :],
                                     device=self.device)
            logits, tmp = T.prefill(self.params, self.cfg,
                                    {"tokens": tokens}, tmp)
            # splice the prefilled slot into the batch caches: per-layer
            # stacked caches, batch dim is axis 1
            for dst, src in zip(_tensors(self.caches), _tensors(tmp)):
                dst[:, slot:slot + 1] = src
            first = self.next_tokens(logits[:, -1])[0]
        req.out_tokens.append(int(first))
        self.slot_req[slot] = req
        self.slot_pos[slot] = len(req.prompt)
        return True

    def step(self) -> None:
        """One batched decode step across all active slots."""
        if all(r is None for r in self.slot_req):
            return
        tokens = np.zeros((self.B, 1), np.int64)
        for s, r in enumerate(self.slot_req):
            if r is not None and r.out_tokens:
                tokens[s, 0] = r.out_tokens[-1]
        pos = int(max(self.slot_pos))  # uniform step position
        with torch.inference_mode():
            logits, self.caches = T.decode_step(
                self.params, self.cfg, self.caches,
                torch.as_tensor(tokens, device=self.device), pos)
            nxt = self.next_tokens(logits[:, 0])
        for s, r in enumerate(self.slot_req):
            if r is None:
                continue
            r.out_tokens.append(int(nxt[s]))
            self.slot_pos[s] += 1
            if len(r.out_tokens) >= r.max_new:
                r.done = True
                self.slot_req[s] = None

    def run(self, requests: List[Request]) -> List[Request]:
        pending = list(requests)
        done: List[Request] = []
        while pending or any(r is not None for r in self.slot_req):
            while pending and self.add_request(pending[0]):
                pending.pop(0)
            self.step()
            for r in requests:
                if r.done and r not in done:
                    done.append(r)
        return done


def make_requests(cfg: ModelConfig, n: int, max_new: int,
                  prompt_len: int = 16, seed: int = 0) -> List[Request]:
    """The reference CLI's traffic: n prompts of `prompt_len` tokens drawn
    from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size, size=prompt_len
                                        ).astype(np.int32),
                    max_new=max_new)
            for i in range(n)]


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--quantized", action="store_true",
                    help="serve int8 PTQ weights through the VTA GEMM path")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card)")
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    cfg = reduce_cfg(spec.model) if args.reduced else spec.model
    with torch.inference_mode():
        params = T.init_params(cfg, 0, torch_device=args.device)
        if args.quantized:
            params = quantize_params(params)
            print("serving with int8 PTQ weights (VTA datapath)")
    engine = ServeEngine(cfg, params, batch_slots=args.slots,
                         torch_device=args.device)
    reqs = make_requests(cfg, args.requests, args.max_new)
    t0 = time.time()
    done = engine.run(reqs)
    dt = time.time() - t0
    total_tokens = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s) on {engine.device}")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.out_tokens[:10]}...")


if __name__ == "__main__":
    main()
