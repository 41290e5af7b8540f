"""Post-training quantization (§5: "post-training adjustments on the
parameters to convert them to 8-bit weights from 32-bit floating point").

Symmetric int8 quantization with power-of-two requantization shifts so the
entire inference pipeline maps onto VTA's integer datapath: int8 x int8
GEMM -> int32 accumulate -> (+bias) -> arithmetic-shift-right -> clip.
The same scheme drives the LM serving path's `vta_int8` GEMM backend.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class QuantParams:
    scale: float          # real_value ~= scale * q
    bits: int = 8

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1

    @property
    def qmin(self) -> int:
        return -(1 << (self.bits - 1))


def calibrate(x: np.ndarray, bits: int = 8,
              percentile: float = 100.0) -> QuantParams:
    """Symmetric scale from the max-abs (or percentile) statistic."""
    a = np.abs(np.asarray(x, np.float64)).ravel()
    # both branches must tolerate size-0 input (an empty calibration batch
    # yields the 1e-8 floor): np.percentile raises on empty arrays, so it
    # gets the same guard the max branch has via max(initial=0.0)
    amax = (float(np.percentile(a, percentile))
            if percentile < 100.0 and a.size
            else float(a.max(initial=0.0)))
    amax = max(amax, 1e-8)
    return QuantParams(scale=amax / ((1 << (bits - 1)) - 1), bits=bits)


def quantize(x: np.ndarray, qp: QuantParams) -> np.ndarray:
    q = np.round(np.asarray(x, np.float64) / qp.scale)
    return np.clip(q, qp.qmin, qp.qmax).astype(np.int8)


def dequantize(q: np.ndarray, qp: QuantParams) -> np.ndarray:
    return q.astype(np.float32) * qp.scale


def per_channel_scales(w: np.ndarray, axis: int = 0, bits: int = 8) -> np.ndarray:
    """One symmetric scale per output channel (weights)."""
    a = np.abs(np.asarray(w, np.float64))
    red = tuple(i for i in range(w.ndim) if i != axis)
    amax = np.maximum(a.max(axis=red), 1e-8)
    return (amax / ((1 << (bits - 1)) - 1)).astype(np.float32)


def quantize_per_channel(w: np.ndarray, scales: np.ndarray,
                         axis: int = 0, bits: int = 8) -> np.ndarray:
    """Quantize with per-channel scales; `bits` must match the value the
    scales were computed for (``per_channel_scales(bits=...)``) — clipping
    to the b-bit range, not a hard-coded int8 one, so sub-byte scales
    don't silently saturate at the int8 boundary."""
    shape = [1] * w.ndim
    shape[axis] = -1
    q = np.round(np.asarray(w, np.float64) / scales.reshape(shape))
    qmin, qmax = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return np.clip(q, qmin, qmax).astype(np.int8)


def choose_requant_shift(sx: float, sw: float, sy: float,
                         max_shift: int = 24) -> int:
    """Pick s with 2^-s ~= (sx*sw)/sy, so  y_q ~= (acc >> s)."""
    ratio = (sx * sw) / max(sy, 1e-30)
    s = int(round(-math.log2(max(ratio, 1e-30))))
    return int(np.clip(s, 0, max_shift))


def fold_batchnorm(gamma: np.ndarray, beta: np.ndarray, mean: np.ndarray,
                   var: np.ndarray, eps: float = 1e-5
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Fold BN into per-channel (w_scale, bias) applied post-conv."""
    inv = gamma / np.sqrt(var + eps)
    return inv, beta - mean * inv


def quantize_bias(bias_f: np.ndarray, sx: float, sw: float) -> np.ndarray:
    """Bias is added in the int32 accumulator domain: b_q = b / (sx*sw).

    The clip happens in the FLOAT domain: a pathological sx*sw (tiny
    product scale) can push b/(sx*sw) past int64 range, where a cast
    before the clip is undefined-overflow (wraps to INT64_MIN on most
    platforms) instead of saturating."""
    q = np.round(np.asarray(bias_f, np.float64) / max(sx * sw, 1e-30))
    return np.clip(q, -(1 << 31), (1 << 31) - 1).astype(np.int32)
