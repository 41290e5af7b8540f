"""Quantized autoregressive decoder served through the compiled stack.

The paper's end-to-end claim (§5: compile real models onto the template,
split work between CPU and accelerator) applied to autoregressive
transformer decode:

  * every linear (QKV / attention-out / MLP up / MLP down / LM head) is
    an int8 accelerator matmul with the shift-clip epilogue, its weights
    staged once as ``Program.constant`` (b-bit packed on a ``lowbit``
    spec, where the cuda engine routes them through ``lut_gemm``);
  * attention is a host segment over the GQA decode kernel
    (``kernels/decode_attention``, on the decoder's torch device) or a
    pure-numpy equivalent — the paper's C1 heterogeneous split;
  * the KV cache and the position counter live in **persistent** DRAM
    buffers (``Program.persistent``): appended in place each step by the
    attention host op, at stable addresses, with zero per-step DRAM
    allocation.

One compiled program = one decode STEP; calling it N times decodes N
tokens.  Serving goes through ``serve.DevicePool``: every pool session
is one independent dialogue (its own KV bytes), and same-step sessions
gang their accelerator segments across slots.

Everything is deterministic integer/float32 math, and the eager
:class:`DecoderReference` shares the exact host fns (attention on the same
device, through the same kernel) and the ``matmul_reference`` integer
oracle with the compiled path — compiled decode is bit-exact against it on
both engines.  The weights are the reference package's, from the same
numpy seeding.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import hwspec as _hwspec
from ..core.driver import TorchDeviceLike, resolve_torch_device
from ..core.program import CompiledProgram, Program
from ..core.scheduler import Epilogue, matmul_reference
from ..kernels.decode_attention import decode_attention

# fixed-point convention for the attention host segment: int8 activations
# carry a 1/16 scale, attention runs in float32, the output requantizes
# back to int8 with the same scale.  Arbitrary but fixed — both the
# compiled path and the eager reference evaluate the SAME function.
_ATTN_SCALE = 16.0


@dataclass(frozen=True)
class DecoderConfig:
    d_model: int = 64
    n_blocks: int = 2
    n_heads: int = 2          # KV heads == query heads (MHA decode)
    d_ff: int = 128
    vocab: int = 32
    s_max: int = 96           # KV-cache capacity (max decode steps)
    shift: int = 7            # requant shift of every accelerator matmul
    seed: int = 0
    attention: str = "numpy"  # "numpy" | "kernel" (decode_attention)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _attention_core(cfg: DecoderConfig, q: np.ndarray, K: np.ndarray,
                    V: np.ndarray, kv_len: int,
                    torch_device: TorchDeviceLike) -> np.ndarray:
    """(d,) int8 query against the first kv_len rows of the (S, d) int8
    caches -> (d,) int8 attention output.  Mode "kernel" routes through
    the decode_attention op (B=1 GQA decode over the padded cache) on
    `torch_device` — the CUDA kernel on the card, its plain version on the
    CPU; mode "numpy" is the dependency-free equivalent.  Both are
    deterministic."""
    H, D = cfg.n_heads, cfg.head_dim
    if cfg.attention == "kernel":
        dev = torch.device(torch_device)

        def scaled(x, rows):
            t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
            return t.reshape(1, rows, H, D).to(dev) / _ATTN_SCALE
        out = decode_attention(scaled(q, 1), scaled(K, cfg.s_max),
                               scaled(V, cfg.s_max), int(kv_len))
        of = out.cpu().numpy().astype(np.float32).reshape(cfg.d_model)
    else:
        qf = (q.astype(np.float32) / _ATTN_SCALE).reshape(H, D)
        kf = (K[:kv_len].astype(np.float32) / _ATTN_SCALE) \
            .reshape(kv_len, H, D)
        vf = (V[:kv_len].astype(np.float32) / _ATTN_SCALE) \
            .reshape(kv_len, H, D)
        # scores: (H, kv_len) — identical scaling to the kernel path
        s = np.einsum("hd,khd->hk", qf, kf) / np.float32(np.sqrt(D))
        s = s - s.max(axis=1, keepdims=True)
        p = np.exp(s, dtype=np.float32)
        p = p / p.sum(axis=1, keepdims=True)
        of = np.einsum("hk,khd->hd", p, vf).reshape(cfg.d_model)
    return np.clip(np.rint(of * _ATTN_SCALE), -128, 127).astype(np.int8)


def _attn_step(cfg: DecoderConfig, qkv: np.ndarray, K: np.ndarray,
               V: np.ndarray, pos: np.ndarray,
               torch_device: TorchDeviceLike):
    """The attention host op: append this step's k/v into the persistent
    caches at `pos`, attend over the pos+1 live rows, advance pos.
    Returns (attn_out, K', V', pos') — the trailing three are written
    back into the persistent buffers in place (``host(updates=...)``)."""
    d = cfg.d_model
    row = qkv.reshape(3 * d)
    q, k, v = row[:d], row[d:2 * d], row[2 * d:]
    p = int(pos[0])
    if p >= cfg.s_max:
        raise RuntimeError(f"KV cache overflow: step {p} >= s_max "
                           f"{cfg.s_max}")
    K = K.copy()
    V = V.copy()
    K[p] = k
    V[p] = v
    a = _attention_core(cfg, q, K, V, p + 1, torch_device)
    return (a.reshape(1, d), K, V,
            np.array([p + 1], np.int32))


def _residual(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """int8 residual add with the same saturation the tensor ALU uses."""
    return np.clip(a.astype(np.int32) + b.astype(np.int32),
                   -128, 127).astype(np.int8)


def _make_weights(cfg: DecoderConfig) -> List[Dict[str, np.ndarray]]:
    """Small random int8 weights per block (+ the LM head on the last
    entry).  Deterministic in cfg.seed; already in int4 range, so a
    ``lowbit(4)`` spec packs them unchanged."""
    rng = np.random.default_rng(cfg.seed)
    d, f = cfg.d_model, cfg.d_ff

    def w(nout, nin):
        return rng.integers(-8, 8, size=(nout, nin), dtype=np.int8)

    blocks = [dict(wqkv=w(3 * d, d), wo=w(d, d),
                   w1=w(f, d), w2=w(d, f))
              for _ in range(cfg.n_blocks)]
    blocks[-1]["head"] = w(cfg.vocab, d)
    return blocks


class QuantDecoder:
    """A 2-block (configurable) quantized decoder whose per-step graph
    compiles once into task-ISA streams + host attention segments, with
    the KV caches in persistent DRAM on `torch_device` (default the card).

        dec = QuantDecoder(spec=hwspec.lowbit(4), attention="kernel")
        c = dec.compile()
        for t in range(64):
            logits = c(x=dec.token(t))        # state advances in DRAM

    Pool serving: ``DevicePool(dec.compile(), size=4)`` then one
    ``pool.session()`` per concurrent dialogue.  Keyword arguments other
    than `spec`, `torch_device` and `dram_size` are DecoderConfig fields
    (they override `cfg`'s)."""

    def __init__(self, cfg: Optional[DecoderConfig] = None, spec=None,
                 torch_device: TorchDeviceLike = "cuda",
                 dram_size: int = 1 << 28, **cfg_kw):
        self.cfg = replace(cfg, **cfg_kw) if cfg is not None \
            else DecoderConfig(**cfg_kw)
        if self.cfg.d_model % self.cfg.n_heads:
            raise ValueError("d_model must divide into n_heads")
        self.spec = spec or _hwspec.pynq()
        self.torch_device = resolve_torch_device(torch_device)
        self.dram_size = dram_size
        self.weights = _make_weights(self.cfg)

    # ------------------------------------------------------------------
    def token(self, t: int) -> np.ndarray:
        """Deterministic pseudo-token embedding for step t (teacher-forced
        driver for tests/benchmarks)."""
        rng = np.random.default_rng(self.cfg.seed * 7919 + t)
        return rng.integers(-32, 32, size=(1, self.cfg.d_model),
                            dtype=np.int8)

    def build_program(self) -> Program:
        cfg = self.cfg
        d = cfg.d_model
        ep = Epilogue(shift=cfg.shift)
        p = Program(self.spec)
        x = p.input("x", (1, d))
        for b, wts in enumerate(self.weights):
            wqkv = p.constant(f"wqkv{b}", wts["wqkv"])
            wo = p.constant(f"wo{b}", wts["wo"])
            w1 = p.constant(f"w1_{b}", wts["w1"])
            w2 = p.constant(f"w2_{b}", wts["w2"])
            K = p.persistent(f"k{b}", (cfg.s_max, d))
            V = p.persistent(f"v{b}", (cfg.s_max, d))
            pos = p.persistent(f"pos{b}", (1,), dtype="int32")
            qkv = p.matmul(x, wqkv, epilogue=ep, name=f"qkv{b}")
            a = p.host(
                lambda qkvv, Kv, Vv, posv, _c=cfg, _d=self.torch_device:
                _attn_step(_c, qkvv, Kv, Vv, posv, _d),
                qkv, K, V, pos, shape=(1, d), kind="mat",
                key=f"qdec.attn.{b}.{cfg.attention}.{cfg.s_max}."
                    f"{cfg.n_heads}",
                updates=(K, V, pos), name=f"attn{b}")
            ao = p.matmul(a, wo, epilogue=ep, name=f"aout{b}")
            h = p.host(_residual, x, ao, shape=(1, d), kind="mat",
                       key="qdec.residual", name=f"res_a{b}")
            m1 = p.matmul(h, w1, epilogue=Epilogue(shift=cfg.shift,
                                                   relu=True),
                          name=f"mlp_up{b}")
            m2 = p.matmul(m1, w2, epilogue=ep, name=f"mlp_dn{b}")
            x = p.host(_residual, h, m2, shape=(1, d), kind="mat",
                       key="qdec.residual", name=f"res_m{b}")
        logits = p.matmul(x, p.constant("whead",
                                        self.weights[-1]["head"]),
                          epilogue=ep, name="logits")
        p.output(logits)
        return p

    def compile(self, device=None, **kw) -> CompiledProgram:
        """Compile the decoder graph onto this decoder's torch device.
        `device` co-stages this decoder onto an existing staged image
        (disjoint DRAM range — see ``program.compile_multi``) so one pool
        slot can serve a heterogeneous model mix alongside other
        programs."""
        kw.setdefault("torch_device", self.torch_device)
        kw.setdefault("dram_size", self.dram_size)
        return self.build_program().compile(device=device, **kw)

    def reference(self) -> "DecoderReference":
        return DecoderReference(self)


@dataclass
class DecoderReference:
    """Eager stateful oracle: the SAME host fns (attention on the
    decoder's device) and the matmul_reference integer semantics, KV
    caches as plain arrays.  One instance = one session."""
    dec: QuantDecoder
    K: List[np.ndarray] = field(default_factory=list)
    V: List[np.ndarray] = field(default_factory=list)
    pos: List[np.ndarray] = field(default_factory=list)

    def __post_init__(self):
        cfg = self.dec.cfg
        for _ in range(cfg.n_blocks):
            self.K.append(np.zeros((cfg.s_max, cfg.d_model), np.int8))
            self.V.append(np.zeros((cfg.s_max, cfg.d_model), np.int8))
            self.pos.append(np.zeros(1, np.int32))

    def step(self, x: np.ndarray) -> np.ndarray:
        cfg = self.dec.cfg
        ep = Epilogue(shift=cfg.shift)
        x = np.asarray(x, np.int8).reshape(1, cfg.d_model)
        for b, wts in enumerate(self.dec.weights):
            qkv = matmul_reference(x, wts["wqkv"], ep)
            a, self.K[b], self.V[b], self.pos[b] = _attn_step(
                cfg, qkv, self.K[b], self.V[b], self.pos[b],
                self.dec.torch_device)
            ao = matmul_reference(a, wts["wo"], ep)
            h = _residual(x, ao)
            m1 = matmul_reference(h, wts["w1"],
                                  Epilogue(shift=cfg.shift, relu=True))
            m2 = matmul_reference(m1, wts["w2"], ep)
            x = _residual(h, m2)
        return matmul_reference(x, self.dec.weights[-1]["head"], ep)
