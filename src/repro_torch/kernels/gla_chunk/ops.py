"""Public op: the chunked GLA scan over (B, S, H, ...) tensors.

A CPU tensor takes the plain version (:func:`gla_chunk_plain`, over
``ref.gla_chunk_ref``); a CUDA tensor launches the CUDA kernel; any other
device raises.  There is no fallback between the two.  Both keep the
reference op's rule on the chunk: Q = min(chunk, S) must divide S.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .._grad import refuse_grad
from .kernel import MAX_TILE, gla_chunk_cuda
from .ref import gla_chunk_ref


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           la: torch.Tensor, h0: Optional[torch.Tensor], chunk: int) -> int:
    """The chunk length Q; raises on shapes or devices that do not fit."""
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 \
            or v.shape[:3] != q.shape[:3] or la.shape != q.shape[:3] \
            or (h0 is not None and h0.shape != (q.shape[0], q.shape[2],
                                                q.shape[3], v.shape[3])):
        raise ValueError(f"gla_chunk shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, la "
                         f"{tuple(la.shape)}, h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    if any(t is not None and t.device != q.device for t in (k, v, la, h0)):
        raise ValueError("gla_chunk operands on different devices")
    S = q.shape[1]
    Q = min(chunk, S)
    if Q <= 0 or S % Q:
        raise ValueError(f"gla_chunk: S = {S} is not a multiple of the "
                         f"chunk min({chunk}, S) = {Q}")
    return Q


def gla_chunk_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    la: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
                    chunk: int = 64, y_dtype: Optional[torch.dtype] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`gla_chunk`, on any device."""
    Q = _check(q, k, v, la, h0, chunk)
    B, S, H, N = q.shape
    P = v.shape[-1]
    nc = S // Q

    def to_bh(x: torch.Tensor) -> torch.Tensor:
        return x.transpose(1, 2).reshape(B * H, nc, Q, *x.shape[3:])

    h0b = (torch.zeros((B * H, N, P), dtype=torch.float32, device=q.device)
           if h0 is None else h0.reshape(B * H, N, P))
    yb, hb = gla_chunk_ref(to_bh(q), to_bh(k), to_bh(v), to_bh(la), h0b,
                           y_dtype=y_dtype)
    y = yb.reshape(B, H, S, P).transpose(1, 2)
    return y, hb.reshape(B, H, N, P)


def gla_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              la: torch.Tensor, h0: Optional[torch.Tensor] = None, *,
              chunk: int = 64, y_dtype: Optional[torch.dtype] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q, k: (B, S, H, N); v: (B, S, H, P); la: (B, S, H) log-decay
    (<= 0); h0: (B, H, N, P) or None (zeros).  Returns y (B, S, H, P) in
    `y_dtype` (default q's dtype, as ``gla_chunk_pallas`` returns it) and
    the final state h (B, H, N, P) float32.  On the card q and k are
    float32 or bfloat16 and may be broadcast over heads (stride 0, read in
    place); v, la and h0 are float32."""
    refuse_grad("gla_chunk", (q, k, v, la, h0),
                " (the Mamba2 and mLSTM train forms wait for its backward "
                "kernel, ROADMAP Queue 1 item 5b)")
    Q = _check(q, k, v, la, h0, chunk)
    dev = q.device
    if dev.type == "cpu":
        return gla_chunk_plain(q, k, v, la, h0, chunk=chunk, y_dtype=y_dtype)
    if dev.type != "cuda":
        raise ValueError(f"gla_chunk has no kernel for device {dev}")
    out = gla_chunk_cuda(q, k, v, la, h0, min(Q, MAX_TILE),
                         y_dtype or q.dtype)
    gla_chunk.launches += 1
    B, S, H, N = q.shape
    key = (B, S, H, N, v.shape[-1], Q, str(q.dtype).split(".")[-1],
           q.stride(2) == 0)
    gla_chunk.shapes[key] = gla_chunk.shapes.get(key, 0) + 1
    return out


#: kernel launches made by this op (plain-version calls do not count)
gla_chunk.launches = 0
#: (B, S, H, N, P, Q, q dtype, heads broadcast) -> launches at that shape
gla_chunk.shapes = {}
