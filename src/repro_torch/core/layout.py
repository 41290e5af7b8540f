"""Blocked tensor layouts for VTA DMA.

VTA DMAs move *tensor-register elements*: an INP element is a
(BATCH x BLOCK_IN) int8 block, a WGT element (BLOCK_OUT x BLOCK_IN), an
ACC/OUT element (BATCH x BLOCK_OUT).  Host tensors are packed into blocked
layouts so that 2D strided DMA (one instruction per tile) can address them
— the data-layout constraint the NNVM/TVM layers enforce (§1.2, §4.1).
"""
from __future__ import annotations

import numpy as np
import torch

from .hwspec import HardwareSpec


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def pad_to(x: np.ndarray, axis: int, mult: int) -> np.ndarray:
    n = x.shape[axis]
    pad = _ceil_div(n, mult) * mult - n
    if pad == 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths)


# ----------------------------------------------------------------------
# generic blocked layouts (parameterized over the block sizes; the
# spec-typed pack_/unpack_ helpers below are instances of these)
# ----------------------------------------------------------------------
def block2d(a: np.ndarray, rb: int, cb: int) -> np.ndarray:
    """(R, C) -> (Rb, Cb, rb, cb); element (r_blk, c_blk)."""
    a = pad_to(pad_to(a, 0, rb), 1, cb)
    R, C = a.shape
    return (a.reshape(R // rb, rb, C // cb, cb)
            .transpose(0, 2, 1, 3).copy())


def unblock2d(blocked: np.ndarray, R: int, C: int) -> np.ndarray:
    """(Rb, Cb, rb, cb) -> (R, C) — inverse of block2d."""
    Rb, Cb, rb, cb = blocked.shape
    full = blocked.transpose(0, 2, 1, 3).reshape(Rb * rb, Cb * cb)
    return full[:R, :C]


def block_nchw(x: np.ndarray, rb: int, cb: int) -> np.ndarray:
    """(N, C, H, W) -> (Nb, Cb, H, W, rb, cb); element (n_blk, c_blk, h, w).
    Covers both conv activations (rb=BATCH, cb=BLOCK_IN) and conv weights
    (rb=BLOCK_OUT, cb=BLOCK_IN over (OC, IC, KH, KW))."""
    x = pad_to(pad_to(x, 0, rb), 1, cb)
    N, C, H, W = x.shape
    return (x.reshape(N // rb, rb, C // cb, cb, H, W)
            .transpose(0, 2, 4, 5, 1, 3).copy())


def unblock_nchw(blocked: np.ndarray, N: int, C: int) -> np.ndarray:
    """(Nb, Cb, H, W, rb, cb) -> (N, C, H, W) — inverse of block_nchw."""
    Nb, Cb, H, W, rb, cb = blocked.shape
    full = (blocked.transpose(0, 4, 1, 5, 2, 3)
            .reshape(Nb * rb, Cb * cb, H, W))
    return full[:N, :C]


# ----------------------------------------------------------------------
# sub-byte weight packing (wgt_bits in {1, 2, 4}).
#
# A WGT tensor-register element stays one DMA unit, but its
# (BLOCK_OUT x BLOCK_IN) values are stored as b-bit two's-complement
# fields packed 8/b per byte, little-endian within the byte (value j of
# the row-major flattened element lands at byte j*b//8, shifted left by
# (j*b) % 8).  `hwspec.wgt_elem_bytes` already scales with wgt_bits, so
# element-granular DMA addressing is unchanged — only the bytes shrink.
# ----------------------------------------------------------------------
def pack_bits(a: np.ndarray, bits: int) -> np.ndarray:
    """Pack int values along the LAST axis into b-bit fields -> uint8.

    The last axis is padded with zeros to a multiple of 8//bits; output
    last axis is ceil(n * bits / 8) bytes.  Values must lie in the b-bit
    two's-complement range — out-of-range input raises (a silent mask
    would corrupt weights bit-exactness is supposed to catch).
    """
    if bits not in (1, 2, 4):
        raise ValueError(f"pack_bits: bits must be 1, 2 or 4, got {bits}")
    a = np.asarray(a)
    qmin, qmax = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    if a.size and (a.min() < qmin or a.max() > qmax):
        raise ValueError(
            f"pack_bits: values outside int{bits} range [{qmin}, {qmax}]: "
            f"[{a.min()}, {a.max()}]")
    ppb = 8 // bits                      # values per byte
    a = pad_to(a.astype(np.int16), a.ndim - 1, ppb)
    u = (a & ((1 << bits) - 1)).astype(np.uint8)
    u = u.reshape(a.shape[:-1] + (a.shape[-1] // ppb, ppb))
    shifts = (np.arange(ppb, dtype=np.uint8) * bits)
    return np.bitwise_or.reduce(u << shifts, axis=-1).astype(np.uint8)


def unpack_bits_torch(packed: torch.Tensor, bits: int, n: int
                      ) -> torch.Tensor:
    """Inverse of :func:`pack_bits` on the bytes' own device: uint8 bytes
    -> n sign-extended int8 values along the last axis (padding tail
    dropped), by bit shifts and a sign extension.  The one decode point:
    the engines' WGT loads run it on the DRAM image's device, host reads
    through :func:`unpack_bits` on the CPU."""
    if bits not in (1, 2, 4):
        raise ValueError(f"unpack_bits: bits must be 1, 2 or 4, got {bits}")
    ppb = 8 // bits
    shifts = torch.arange(ppb, dtype=torch.uint8,
                          device=packed.device) * bits
    u = ((packed.to(torch.uint8)[..., None] >> shifts)
         & ((1 << bits) - 1)).to(torch.int8)
    sign = 1 << (bits - 1)
    vals = ((u ^ sign) - sign).reshape(packed.shape[:-1] + (-1,))
    return vals[..., :n]


def unpack_bits(packed: np.ndarray, bits: int, n: int) -> np.ndarray:
    """Inverse of :func:`pack_bits`: uint8 bytes -> n sign-extended int8
    values along the last axis (padding tail dropped)."""
    t = torch.from_numpy(np.ascontiguousarray(packed, np.uint8))
    return unpack_bits_torch(t, bits, n).contiguous().numpy()


def pack_wgt_elems(blocked: np.ndarray, bits: int) -> np.ndarray:
    """Blocked weights (..., BLOCK_OUT, BLOCK_IN) int8 -> packed
    (..., BLOCK_OUT*BLOCK_IN*bits//8) uint8 — one packed byte-row per
    tensor-register element (== `spec.wgt_elem_bytes`)."""
    bo, bi = blocked.shape[-2], blocked.shape[-1]
    flat = blocked.reshape(blocked.shape[:-2] + (bo * bi,))
    return pack_bits(flat, bits)


def unpack_wgt_elems_torch(packed: torch.Tensor, bits: int,
                           block_out: int, block_in: int) -> torch.Tensor:
    """Packed element rows uint8 (..., elem_bytes) -> int8
    (..., BLOCK_OUT, BLOCK_IN) on the bytes' own device, with no copy to
    the host."""
    flat = unpack_bits_torch(packed, bits, block_out * block_in)
    return flat.reshape(packed.shape[:-1] + (block_out, block_in))


def unpack_wgt_elems(packed: np.ndarray, bits: int,
                     block_out: int, block_in: int) -> np.ndarray:
    """Inverse of :func:`pack_wgt_elems` -> (..., BLOCK_OUT, BLOCK_IN) int8."""
    flat = unpack_bits(packed, bits, block_out * block_in)
    return flat.reshape(packed.shape[:-1] + (block_out, block_in))


# ----------------------------------------------------------------------
# matmul layouts:  A:(M,K) int8,  W:(N,K) int8,  C:(M,N)
# ----------------------------------------------------------------------
def pack_inp(a: np.ndarray, spec: HardwareSpec) -> np.ndarray:
    """(M, K) -> (Mb, Kb, BATCH, BLOCK_IN); element (mb, kb)."""
    a = pad_to(pad_to(np.asarray(a, np.int8), 0, spec.batch), 1, spec.block_in)
    M, K = a.shape
    return (a.reshape(M // spec.batch, spec.batch, K // spec.block_in,
                      spec.block_in)
            .transpose(0, 2, 1, 3).copy())


def pack_wgt(w: np.ndarray, spec: HardwareSpec) -> np.ndarray:
    """(N, K) -> (Nb, Kb, BLOCK_OUT, BLOCK_IN); element (nb, kb)."""
    w = pad_to(pad_to(np.asarray(w, np.int8), 0, spec.block_out), 1, spec.block_in)
    N, K = w.shape
    return (w.reshape(N // spec.block_out, spec.block_out,
                      K // spec.block_in, spec.block_in)
            .transpose(0, 2, 1, 3).copy())


def pack_acc(c: np.ndarray, spec: HardwareSpec) -> np.ndarray:
    """(M, N) int32 -> (Mb, Nb, BATCH, BLOCK_OUT)."""
    c = pad_to(pad_to(np.asarray(c, np.int32), 0, spec.batch), 1, spec.block_out)
    M, N = c.shape
    return (c.reshape(M // spec.batch, spec.batch, N // spec.block_out,
                      spec.block_out)
            .transpose(0, 2, 1, 3).copy())


def unpack_out(blocked: np.ndarray, M: int, N: int, spec: HardwareSpec) -> np.ndarray:
    """(Mb, Nb, BATCH, BLOCK_OUT) -> (M, N)."""
    Mb, Nb = blocked.shape[0], blocked.shape[1]
    full = blocked.transpose(0, 2, 1, 3).reshape(Mb * spec.batch,
                                                 Nb * spec.block_out)
    return full[:M, :N]


# ----------------------------------------------------------------------
# conv2d layouts (NCHW, §2.6 / Fig. 9)
# ----------------------------------------------------------------------
def pack_conv_inp(x: np.ndarray, spec: HardwareSpec) -> np.ndarray:
    """(N, C, H, W) -> (Nb, Cb, H, W, BATCH, BLOCK_IN); element (nb,cb,h,w)."""
    x = pad_to(pad_to(np.asarray(x, np.int8), 0, spec.batch), 1, spec.block_in)
    N, C, H, W = x.shape
    return (x.reshape(N // spec.batch, spec.batch, C // spec.block_in,
                      spec.block_in, H, W)
            .transpose(0, 2, 4, 5, 1, 3).copy())


def pack_conv_wgt(w: np.ndarray, spec: HardwareSpec) -> np.ndarray:
    """(OC, IC, KH, KW) -> (OCb, ICb, KH, KW, BLOCK_OUT, BLOCK_IN)."""
    w = pad_to(pad_to(np.asarray(w, np.int8), 0, spec.block_out), 1, spec.block_in)
    OC, IC, KH, KW = w.shape
    return (w.reshape(OC // spec.block_out, spec.block_out,
                      IC // spec.block_in, spec.block_in, KH, KW)
            .transpose(0, 2, 4, 5, 1, 3).copy())


def unpack_conv_out(blocked: np.ndarray, N: int, OC: int, OH: int, OW: int,
                    spec: HardwareSpec) -> np.ndarray:
    """(Nb, OCb, OH, OW, BATCH, BLOCK_OUT) -> (N, OC, OH, OW)."""
    Nb, OCb = blocked.shape[0], blocked.shape[1]
    full = (blocked.transpose(0, 4, 1, 5, 2, 3)
            .reshape(Nb * spec.batch, OCb * spec.block_out, OH, OW))
    return full[:N, :OC]
