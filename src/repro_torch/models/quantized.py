"""Serve-time PTQ of an LM's weights, and dense layers on the VTA
datapath through the program-level JIT.

:func:`quantize_params` is the paper's deployment step (float weights ->
int8) applied to the LM stack: every linear weight inside the layer
blocks becomes {w_q: int8, w_scale: float32 per output channel};
embeddings, norms and the LM head stay float.

:class:`VtaLinear` routes a quantized linear layer through
``repro_torch.core.Program``: the layer compiles once into a task-ISA
stream and every subsequent call just rebinds the activation buffer and
re-runs it on either execution engine — the deployment path that exercises
the VTA datapath instead of a library GEMM.

``quantized_param_shapes`` (the reference's dry-run helper) is not
ported.  ``from_params`` takes PTQ parameters as numpy arrays or CPU
tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..core import hwspec as _hwspec
from ..core import quantize as q
from ..core.driver import TorchDeviceLike
from ..core.program import CompiledProgram, Program
from ..core.scheduler import Epilogue
from .layers import quantize_linear_params
from .transformer import LMParams

_QUANT_NAMES = ("wq", "wk", "wv", "wo", "wi", "wg", "up_x", "up_z",
                "w_in", "w_if", "down", "in_proj", "out_proj")


def _quantize_stacked(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """PTQ of a stacked (L, K, N) weight one layer at a time (each layer's
    float32 temporaries only): w_q (L, K, N), a transposed view of
    contiguous (L, N, K) int8 storage, and w_scale (L, N)."""
    L, K, N = w.shape
    store = torch.empty((L, N, K), dtype=torch.int8, device=w.device)
    scale = torch.empty((L, N), dtype=torch.float32, device=w.device)
    for i in range(L):
        one = quantize_linear_params({"w": w[i]})
        store[i] = one["w_q"].t()
        scale[i] = one["w_scale"]
    return {"w_q": store.transpose(1, 2), "w_scale": scale}


def quantize_params(params: Any) -> LMParams:
    """PTQ the layer-stack linears of an LM (an ``LMParams`` or its tree):
    per layer of a stack and per output channel.  Returns a new
    ``LMParams`` that shares every tensor it does not quantize."""
    tree = params.tree() if isinstance(params, LMParams) else params

    def walk(node, name=""):
        if isinstance(node, dict) and torch.is_tensor(node.get("w")):
            if name in _QUANT_NAMES and node["w"].dim() in (2, 3):
                if node["w"].dim() == 3:
                    return _quantize_stacked(node["w"])
                return quantize_linear_params(node)
            return node
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return node

    out = dict(tree)
    out["layers"] = walk(tree["layers"])
    for k in ("shared_attn", "encoder"):
        if k in tree:
            out[k] = walk(tree[k])
    return LMParams(out)


def quantized_param_shapes(param_shapes: Any) -> LMParams:
    """The int8 PTQ tree of `param_shapes` (``meta`` tensors, as
    ``transformer.init_params(cfg, 0, "meta")`` gives them): the same
    leaves, shapes and dtypes :func:`quantize_params` makes, on ``meta``,
    nothing computed (the dry run's ``--quantized`` serve cells)."""
    with torch.no_grad():
        return quantize_params(param_shapes)


class VtaLinear:
    """A dense layer y = x @ W executed on the VTA datapath via a compiled
    ``Program``.

    Integer-only deployment (§5): weights are re-quantized per-tensor
    (power-of-two requant shifts need one scale), activations are
    dynamically quantized per call, and the int8 GEMM + shift/clip
    epilogue runs as a task-ISA stream on either execution engine.  One
    program is compiled per (batch rows, requant shift) signature and
    cached; subsequent calls only rebind DRAM buffers.  Programs compile
    onto `torch_device` (default the card).
    """

    def __init__(self, w: np.ndarray, spec=None, backend: Any = None,
                 virtual_threads: int = 2, bits: int = 8,
                 torch_device: TorchDeviceLike = "cuda",
                 dram_size: int = 1 << 28):
        w = np.asarray(w, np.float32)          # (d_in, d_out)
        if w.ndim != 2:
            raise ValueError(f"expected a 2-D weight, got {w.shape}")
        if bits == 1:
            # int1 two's complement is {-1, 0}: no positive level, so the
            # per-tensor calibration below has no scale (the reference
            # divides by zero here).  1-bit weights run through a Program
            # with integer constants instead.
            raise ValueError("VtaLinear cannot calibrate 1-bit weights: "
                             "int1 has no positive level")
        self.d_in, self.d_out = w.shape
        self.bits = bits
        # bits < 8: weights quantize to the b-bit range and the program's
        # hardware template stores them b-bit packed in DRAM (the staged
        # constant shrinks 8/bits-fold; decode-shaped calls route through
        # the LUT-GEMM kernel on the cuda engine)
        base = spec or _hwspec.pynq()
        self.spec = _hwspec.lowbit(bits, base) if bits < 8 else base
        self.backend = backend
        self.virtual_threads = virtual_threads
        self.torch_device = torch_device
        self.dram_size = dram_size
        self.qw = q.calibrate(w, bits=bits)
        self.w_q = q.quantize(w, self.qw).T.copy()   # (N=d_out, K=d_in)
        self._w_float = w
        self._qy: Optional[q.QuantParams] = None
        self._programs: Dict[Tuple[int, int], CompiledProgram] = {}

    @classmethod
    def from_params(cls, p: Mapping[str, Any], **kw) -> "VtaLinear":
        """Build from PTQ params {w_q: (d_in, d_out) int8, w_scale: (d_out,)}
        — the per-channel PTQ weights are reconstructed and re-quantized
        per-tensor for the integer-only shift epilogue."""
        w = (np.asarray(p["w_q"], np.float32)
             * np.asarray(p["w_scale"], np.float32)[None, :])
        return cls(w, **kw)

    # ------------------------------------------------------------------
    def _program(self, m: int, shift: int) -> CompiledProgram:
        key = (m, shift)
        if key not in self._programs:
            prog = Program(self.spec, virtual_threads=self.virtual_threads)
            x = prog.input("x", (m, self.d_in))
            # weights are a graph constant: packed + staged into DRAM once
            # at compile time, so serving calls only rebind activations
            w = prog.constant("w", self.w_q)
            prog.matmul(x, w, epilogue=Epilogue(shift=shift), name="y")
            self._programs[key] = prog.compile(
                torch_device=self.torch_device, dram_size=self.dram_size)
        return self._programs[key]

    def __call__(self, x: np.ndarray, backend: Any = None) -> np.ndarray:
        x = np.asarray(x, np.float32)
        lead, d_in = x.shape[:-1], x.shape[-1]
        if d_in != self.d_in:
            raise ValueError(f"expected (..., {self.d_in}), got {x.shape}")
        x2 = x.reshape(-1, d_in)
        qx = q.calibrate(x2)
        if self._qy is None:
            # one-time output calibration from the float product
            self._qy = q.calibrate(x2 @ self._w_float)
        shift = q.choose_requant_shift(qx.scale, self.qw.scale,
                                       self._qy.scale)
        compiled = self._program(x2.shape[0], shift)
        y_q = compiled(backend=backend if backend is not None
                       else self.backend,
                       x=q.quantize(x2, qx))
        # exact dequant of the power-of-two requant:
        # acc * sx*sw ~= y, y_q = clip(acc >> shift)
        y = y_q.astype(np.float32) * (qx.scale * self.qw.scale * 2.0 ** shift)
        return y.reshape(*lead, self.d_out).astype(np.float32)


def vta_linear_from_params(p: Mapping[str, Any], **kw) -> VtaLinear:
    """Route one PTQ'd linear layer ({w_q, w_scale}) through the
    program-level JIT."""
    return VtaLinear.from_params(p, **kw)
