"""The redesigned vta_gemm and decode_attention, modelled on the CPU.

The kernels run only on the card; what their results rest on is held here
against the plain versions and the JAX reference:

* the fused quantization prologue of quantized_linear, modelled float by
  float in the kernel's order (amax over the bit patterns of |x|, the
  clamp at 1e-6 in x's dtype, an IEEE division by 127 rounded to x's
  dtype, an IEEE division of each element, round half to even, clip),
  and its epilogue (float(acc) * (w_scale[n] * x_scale), one rounding
  each): the int8 activations are byte-equal to the plain chain's and to
  the reference's (jnp oracle, and the Pallas kernel in interpret mode);
  the outputs are bitwise equal to the port's;
* the skinny instance's split of K (kernel.py:gemm_plan): every K index
  in exactly one slice, and uint32-wrapped partials over the slices equal
  to vta_gemm_ref;
* the wgmma instance above 16 rows: its tiles cover every output element
  once, its K slices are whole 128-byte steps, its grid at the engine's
  and the LM's shapes; the same split model over its slices; K zero-padded
  to 16 bytes exactly; and quantized_linear's quantize-once chain (x_q
  written once, then the int8 GEMM and the dequantization) byte-equal to
  the reference's, jnp and Pallas in interpret mode;
* decode_attention's split (kernel.py:decode_plan): every position below
  kv_len read exactly once, the grid filled at the LM step shape, and a
  split-and-merge model in the plan's order within attn tolerance of the
  plain version and within 1e-5 of the reference's oracle in float32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.vta_gemm.ops as r_vta_ops
import repro_torch.kernels.vta_gemm.ops as t_vta_ops
from repro.kernels.decode_attention.ref import \
    decode_attention_ref_4d as r_decode_ref_4d
from repro_torch.kernels.decode_attention import decode_attention_ref_4d
from repro_torch.kernels.decode_attention.kernel import (MIN_SPLIT,
                                                         decode_plan,
                                                         head_blocks,
                                                         split_ranges)
from repro_torch.kernels.vta_gemm import (quantize_activations,
                                          quantized_linear,
                                          quantized_linear_ref, vta_gemm_ref)
from repro_torch.kernels.vta_gemm.kernel import (K_ALIGN, SKINNY_BN,
                                                 SKINNY_KC, SKINNY_KMAX,
                                                 SKINNY_MAX_M, WGMMA_FILL,
                                                 WGMMA_KSTEP,
                                                 WGMMA_MAX_SPLITS,
                                                 WGMMA_SPLIT_STEPS,
                                                 WGMMA_TILES, amax_blocks,
                                                 clamp_floor, gemm_plan,
                                                 grid_resident, k_operand,
                                                 k_slices, padded_k,
                                                 quant_blocks)
from torch_cases import (ENGINE_SHAPES, PREFILL_SHAPES, QLINEAR_CASES,
                         SKINNY_SHAPES, gemm_inputs, qlinear_w, qlinear_x)

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
#: (M, N, K) of every quantized linear the LM paths serve: Llama-3.2-3B
#: (q, k/v, o, MLP in, MLP out) and zamba2-1.2b (in_proj, out_proj, the
#: shared block's), at the decode step's 4 rows and the prefill's 16
LM_SHAPES = [(m, n, k) for m in (4, 16) for n, k in (
    (3072, 3072), (1024, 3072), (8192, 3072), (3072, 8192), (8384, 2048),
    (2048, 4096), (2048, 2048), (8192, 2048), (2048, 8192))]


# ----------------------------------------------------------------------
# quantized_linear: the fused prologue and epilogue, float by float
# ----------------------------------------------------------------------
def prologue_model(x2: torch.Tensor, x_scale=None):
    """The kernel's steps on plain torch float32 scalars, in its order:
    (x_q int8, x_scale float32)."""
    xf = x2.to(torch.float32)                    # exact widening
    if x_scale is None:
        bits = xf.abs().view(torch.int32)        # |x| >= 0 orders as bits
        amax = bits.max().view(torch.float32) if xf.numel() else \
            torch.zeros((), dtype=torch.float32)
        lo = torch.tensor(clamp_floor(x2.dtype), dtype=torch.float32)
        a = torch.maximum(amax, lo)
        s = torch.div(a, torch.tensor(127.0, dtype=torch.float32))
        x_scale = s.to(x2.dtype).to(torch.float32)  # nearest even in dtype
    else:
        x_scale = torch.as_tensor(x_scale, dtype=torch.float32)
    q = torch.div(xf, x_scale)                   # IEEE, element by element
    q = torch.round(q)                           # rint: half to even
    q = torch.clamp(q, -128.0, 127.0)
    return q.to(torch.int8), x_scale


def epilogue_model(x_q, w_q, w_scale, x_scale, dtype):
    """float(acc) * (w_scale[n] * x_scale), each product rounded once to
    float32, then rounded to x's dtype."""
    acc = torch.matmul(x_q.to(torch.int64), w_q.to(torch.int64)) \
        .to(torch.int32)
    s = w_scale.to(torch.float32) * x_scale
    return (acc.to(torch.float32) * s).to(dtype)


def _spy(monkeypatch, module):
    seen = []
    real = module.vta_gemm

    def spy(a, *args, **kw):
        seen.append(np.asarray(a))
        return real(a, *args, **kw)
    monkeypatch.setattr(module, "vta_gemm", spy)
    return seen


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("case", QLINEAR_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_prologue_model_bytes_equal(monkeypatch, dtype, case,
                                          use_pallas):
    tdt, jdt = DTYPES[dtype]
    M, K, N = 6, 96, 40
    x = torch.from_numpy(qlinear_x(M, K, case, 7)).to(tdt)
    w_nk, sc = qlinear_w(K, N, 8)
    w_q = torch.from_numpy(w_nk).t()
    w_scale = torch.from_numpy(sc)
    model_q, model_s = prologue_model(x)
    chain_q, chain_s = quantize_activations(x)
    assert torch.equal(model_q, chain_q)
    assert torch.equal(model_s.reshape(()), chain_s.reshape(()))
    r_seen = _spy(monkeypatch, r_vta_ops)
    t_seen = _spy(monkeypatch, t_vta_ops)
    want = r_vta_ops.quantized_linear(
        jnp.asarray(x.float().numpy(), jdt), jnp.asarray(w_nk.T),
        jnp.asarray(sc), use_pallas=use_pallas)
    got = quantized_linear(x, w_q, w_scale)
    assert len(r_seen) == len(t_seen) == 1
    np.testing.assert_array_equal(model_q.numpy(), r_seen[0])
    np.testing.assert_array_equal(model_q.numpy(), t_seen[0])
    model_y = epilogue_model(model_q, w_q, w_scale, model_s, tdt)
    assert torch.equal(got, model_y)
    assert torch.equal(got, quantized_linear_ref(x, w_q, w_scale))
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_given_scale_rounds_half_even_then_clips(monkeypatch, dtype):
    """x at +-127.5, -128.5 and far past a given x_scale of 0.25."""
    tdt, jdt = DTYPES[dtype]
    x = torch.tensor([[127.5, -127.5, -128.5, 1000.0, 0.5, 2.5, -2.5,
                       1.5]]) * 0.25
    x = x.to(tdt)
    model_q, _ = prologue_model(x, 0.25)
    assert model_q.tolist() == [[127, -128, -128, 127, 0, 2, -2, 2]]
    w_nk, sc = qlinear_w(8, 16, 2)
    r_seen = _spy(monkeypatch, r_vta_ops)
    t_seen = _spy(monkeypatch, t_vta_ops)
    r_vta_ops.quantized_linear(jnp.asarray(x.float().numpy(), jdt),
                               jnp.asarray(w_nk.T), jnp.asarray(sc),
                               jnp.float32(0.25))
    quantized_linear(x, torch.from_numpy(w_nk).t(), torch.from_numpy(sc),
                     torch.tensor(0.25))
    np.testing.assert_array_equal(model_q.numpy(), r_seen[0])
    np.testing.assert_array_equal(model_q.numpy(), t_seen[0])


def test_scale_divides_where_a_reciprocal_would_differ():
    """float32 amax / 127 by IEEE division, not amax * (1 / 127) (what
    PyTorch's kernels do for a Python-scalar divisor on the card): at
    these amaxes the two differ in the last bit, and the plain chain takes
    the division, as the reference does."""
    inv = torch.tensor(1.0, dtype=torch.float32) / 127.0
    amax = torch.linspace(1.0, 2.0, 4001, dtype=torch.float32)
    div = amax / torch.tensor(127.0)
    differ = amax[div != amax * inv]
    assert differ.numel() > 0
    for a in differ[:5].tolist():
        x = torch.tensor([[a, -0.5, 0.25]], dtype=torch.float32)
        _, s = quantize_activations(x)
        want = np.float32(a) / np.float32(127.0)
        assert s.item() == want
        assert s.item() != (torch.tensor(a) * inv).item()


# ----------------------------------------------------------------------
# vta_gemm: the skinny instance's plan and split of K
# ----------------------------------------------------------------------
def split_model(a, w, bias, scale, plan, epilogue, shift):
    """The skinny kernel's sums: per slice an exact partial, each wrapped
    to uint32, added mod 2^32 (the atomics' order does not matter), then
    vta_gemm_ref's epilogue on the int32 result."""
    K = a.shape[-1]
    total = torch.zeros(a.shape[:-1] + w.shape[-1:], dtype=torch.int64)
    for k0, k1 in k_slices(plan, K):
        part = torch.matmul(a[..., k0:k1].to(torch.int64),
                            w[..., k0:k1, :].to(torch.int64))
        total = (total + (part & 0xFFFFFFFF)) & 0xFFFFFFFF
    acc = torch.where(total >= 1 << 31, total - (1 << 32), total) \
        .to(torch.int32)
    if bias is not None:
        acc = (acc.to(torch.int64) + bias.to(torch.int64)).to(torch.int32)
    if epilogue == "none":
        return acc
    if epilogue == "requant":
        return (acc >> min(shift, 31)).clamp(-128, 127).to(torch.int8)
    return acc.to(torch.float32) * scale


@pytest.mark.parametrize("M,N,K", LM_SHAPES + [
    (m, n, k) for m, k, n in SKINNY_SHAPES])
def test_skinny_plan_partitions_k(M, N, K):
    plan = gemm_plan(1, M, N, K)
    if M > SKINNY_MAX_M:
        assert plan.route == "wgmma"
        assert_wgmma_slices(plan, K)
        return
    assert plan.route == "skinny"
    assert plan.kslice % SKINNY_KC == 0 and plan.kslice <= SKINNY_KMAX
    covered = np.zeros(K, np.int64)
    for k0, k1 in k_slices(plan, K):
        assert k0 < k1
        covered[k0:k1] += 1
    assert (covered == 1).all()
    blocks = plan.splits * -(-N // SKINNY_BN)
    assert blocks <= 2 * 132
    assert grid_resident(plan, 1, N)
    if (M, N, K) in LM_SHAPES:
        # every LM decode linear fills the card: at least one block a SM
        assert blocks >= 132, (M, N, K, plan)


@pytest.mark.parametrize("epilogue,shift", [("none", 0), ("requant", 9),
                                            ("dequant", 0)])
@pytest.mark.parametrize("M,N,K", [(4, 200, 1000), (1, 203, 1000),
                                   (16, 136, 4100), (3, 8, 64),
                                   (4, 130, 7000), (49, 64, 4608),
                                   (28, 64, 2304), (17, 203, 1000),
                                   (56, 72, 4100)])
def test_skinny_split_model_equals_plain(M, N, K, epilogue, shift):
    """Both instances' splits of K: at reduced N and K the skinny plan
    splits K into many slices (down to one 64-byte step each), and the
    wgmma plan splits the engine's deep K into whole 128-byte steps
    (over K zero-padded to 16 bytes); the wrapped partials add up to the
    plain GEMM, with bias and every epilogue, also at the operands'
    extremes."""
    a, w, bias, scale = (torch.from_numpy(x) for x in
                         gemm_inputs(M, K, N, seed=M + N + K))
    a[0] = -128
    w[:, 0] = -128
    plan = gemm_plan(1, M, N, K)
    ak, wk = a, w
    if M <= SKINNY_MAX_M:
        assert plan.splits == -(-K // SKINNY_KC)  # one 64-byte step a slice
    else:
        assert plan.route == "wgmma" and plan.splits > 1
        assert_wgmma_slices(plan, K)
        ak = k_operand(a, K)                      # what the kernel reads
        wk = k_operand(w.t().contiguous(), K).t()
    for b in (None, bias):
        got = split_model(ak, wk, b, scale, plan, epilogue, shift)
        want = vta_gemm_ref(a, w, b, scale, epilogue=epilogue, shift=shift)
        assert torch.equal(got, want)


# ----------------------------------------------------------------------
# vta_gemm: the wgmma instance's plan (M > 16)
# ----------------------------------------------------------------------
def assert_wgmma_slices(plan, K):
    """The plan's K slices partition [0, K) in whole 128-byte steps: each
    starts on a step, all but the last are whole steps, none is empty."""
    assert plan.kslice % WGMMA_KSTEP == 0
    covered = np.zeros(K, np.int64)
    for k0, k1 in k_slices(plan, K):
        assert k0 % WGMMA_KSTEP == 0 and 0 <= k0 < k1
        covered[k0:k1] += 1
    assert (covered == 1).all()
    steps = -(-padded_k(K) // WGMMA_KSTEP)
    assert plan.splits == -(-steps // (plan.kslice // WGMMA_KSTEP))


#: row tiles in a group of the wgmma grid's raster (vta_wgmma.cu GROUP_M)
GROUP_M = 8


def grid_blocks(plan, T, M, N):
    """The (t, rows, columns) each block of the kernel's grid stores, in
    the kernel's index arithmetic (vta_wgmma.cu: grid (ceil(M / bm) *
    ceil(N / bn), 1, T * splits), block x rastered in groups of GROUP_M
    row tiles), once per tile (its other slices add to the same one)."""
    tiles_m, tiles_n = -(-M // plan.bm), -(-N // plan.bn)
    tiles = []
    for z in range(0, T * plan.splits, plan.splits):
        for x in range(tiles_m * tiles_n):
            group = x // (GROUP_M * tiles_n)
            gsize = min(GROUP_M, tiles_m - group * GROUP_M)
            in_group = x - group * GROUP_M * tiles_n
            m0 = (group * GROUP_M + in_group % gsize) * plan.bm
            n0 = (in_group // gsize) * plan.bn
            tiles.append((z // plan.splits, m0, min(M, m0 + plan.bm), n0,
                          min(N, n0 + plan.bn)))
    return tiles


WGMMA_PLAN_SHAPES = [(T, M, N, K) for T, M, N, K, _, _ in ENGINE_SHAPES] + [
    (1, M, N, K) for M, N, K in PREFILL_SHAPES] + [
    (3, 130, 203, 1000), (1, 17, 1, 5), (1, 65, 257, 129), (2, 300, 64, 4608)]


@pytest.mark.parametrize("T,M,N,K", WGMMA_PLAN_SHAPES)
def test_wgmma_plan_covers_every_output_once(T, M, N, K):
    """Above 16 rows the plan takes the wgmma instance, a tile it is built
    for, K slices of whole 128-byte steps, and a grid whose tiles store
    every output element once; at the engine's shapes and at 512 prefill
    rows the grid is at most one round of resident blocks."""
    sms = 132
    plan = gemm_plan(T, M, N, K, sms)
    assert plan.route == "wgmma" and (plan.bm, plan.bn) in WGMMA_TILES
    assert_wgmma_slices(plan, K)
    seen = np.zeros((T, M, N), np.int64)
    for t, m0, m1, n0, n1 in grid_blocks(plan, T, M, N):
        assert m0 < m1 and n0 < n1      # no block past the edge
        seen[t, m0:m1, n0:n1] += 1
    assert (seen == 1).all()
    blocks = T * -(-M // plan.bm) * -(-N // plan.bn) * plan.splits
    if M <= 512:
        assert blocks <= sms, plan


def test_wgmma_plan_fills_the_card():
    """The grid is about one wave or more where the output allows it:
    every LM prefill shape takes the largest tile whose grid gives 70% of
    the SMs a block (zamba2's 512-row in_proj: 4 x 33 = 132 tiles of
    128 x 256); the engine's small tiles are 64 x 64, and from 8 K steps
    on their K is split into one cluster of up to 8 slices of at least
    two steps (T2 M49 N64 K4608: 8 slices of 5 steps); a one-step K is
    never split."""
    sms = 132
    p = gemm_plan(1, 512, 8384, 2048, sms)
    assert (p.bm, p.bn, p.splits) == (128, 256, 1)
    assert -(-512 // 128) * -(-8384 // 256) == sms
    for M, N, K in PREFILL_SHAPES:
        p = gemm_plan(1, M, N, K, sms)
        blocks = -(-M // p.bm) * -(-N // p.bn)
        assert p.splits == 1 and blocks >= WGMMA_FILL * sms, (M, N, K, p)
        larger = [t for t in WGMMA_TILES if t[0] * t[1] > p.bm * p.bn]
        assert all(-(-M // bm) * -(-N // bn) < WGMMA_FILL * sms
                   for bm, bn in larger)
    assert gemm_plan(1, 4096, 8192, 3072).bn == 256
    p = gemm_plan(2, 49, 64, 4608, sms)
    assert (p.bm, p.bn, p.splits, p.kslice) == (64, 64, 8, 5 * WGMMA_KSTEP)
    for T, M, N, K, _, _ in ENGINE_SHAPES:
        p = gemm_plan(T, M, N, K, sms)
        steps = -(-padded_k(K) // WGMMA_KSTEP)
        assert (p.bm, p.bn) == (64, 64)
        assert (p.splits > 1) == (steps >= WGMMA_SPLIT_STEPS)
        assert p.splits <= WGMMA_MAX_SPLITS and p.kslice >= min(
            steps, 2) * WGMMA_KSTEP
        assert T * -(-M // 64) * -(-N // 64) * p.splits <= sms
    assert quant_blocks(17, 1008) == 5 and quant_blocks(4096, 8192) == 528


@pytest.mark.parametrize("K", [5, 70, 200, 1000])
def test_zero_padding_k_is_exact(K):
    """K padded with zero columns to a multiple of 16 (what TMA reads)
    leaves every integer sum, the amax and the quantized values as they
    were; a K that is already a multiple of 16 at an aligned base is not
    copied."""
    M, N = 37, 50
    a, w, bias, scale = (torch.from_numpy(x) for x in
                         gemm_inputs(M, K, N, seed=K))
    ak = k_operand(a, K)
    wk = k_operand(w.t().contiguous(), K)
    assert ak.shape == (M, padded_k(K)) and padded_k(K) % K_ALIGN == 0
    assert not ak[:, K:].any() and not wk[:, K:].any()
    for epi, shift in (("none", 0), ("requant", 9), ("dequant", 0)):
        assert torch.equal(
            vta_gemm_ref(ak, wk.t(), bias, scale, epilogue=epi, shift=shift),
            vta_gemm_ref(a, w, bias, scale, epilogue=epi, shift=shift))
    x = torch.from_numpy(qlinear_x(M, K, "normal", K))
    xp = torch.nn.functional.pad(x, (0, padded_k(K) - K))
    q, s = prologue_model(x)
    qp, sp = prologue_model(xp)
    assert torch.equal(sp, s) and torch.equal(qp[:, :K], q)
    assert not qp[:, K:].any()
    x16 = torch.zeros(4, 32, dtype=torch.int8)
    assert k_operand(x16, 32) is x16


def quantize_once_model(x2, w_q, w_scale, x_scale=None):
    """quantized_linear above 16 rows, step by step as the kernels run it:
    the quantize launch writes x_q (M, padded_k(K)) once, zero past K;
    the wgmma instance sums x_q against the zero-padded weights over the
    plan's K slices (uint32-wrapped partials); the QLINEAR epilogue
    scales each int32 sum, in x's dtype.  Returns (y, x_q)."""
    M, K = x2.shape
    N = w_q.shape[1]
    x_q, xs = prologue_model(x2, x_scale)
    xq = k_operand(x_q, K)
    wk = k_operand(w_q.t().contiguous(), K).t()
    plan = gemm_plan(1, M, N, K)
    assert plan.route == "wgmma"
    acc = split_model(xq, wk, None, None, plan, "none", 0)
    s = w_scale.to(torch.float32) * xs
    return (acc.to(torch.float32) * s).to(x2.dtype), x_q


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("case", QLINEAR_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [17, 130, 512])
def test_quantize_once_chain_bytes_equal_reference(monkeypatch, M, dtype,
                                                   case, use_pallas):
    """x_q as the quantize launch writes it equals the int8 operand the
    reference's quantized_linear hands its GEMM, and y equals the
    reference's bytes (and the port's CPU route's), at K and N not
    multiples of 16."""
    tdt, jdt = DTYPES[dtype]
    K, N = 200, 72
    x = torch.from_numpy(qlinear_x(M, K, case, M + 3)).to(tdt)
    w_nk, sc = qlinear_w(K, N, M)
    w_q = torch.from_numpy(w_nk).t()
    w_scale = torch.from_numpy(sc)
    y, x_q = quantize_once_model(x, w_q, w_scale)
    r_seen = _spy(monkeypatch, r_vta_ops)
    want = r_vta_ops.quantized_linear(
        jnp.asarray(x.float().numpy(), jdt), jnp.asarray(w_nk.T),
        jnp.asarray(sc), use_pallas=use_pallas)
    np.testing.assert_array_equal(x_q.numpy(), r_seen[0])
    np.testing.assert_array_equal(
        y.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert torch.equal(y, quantized_linear(x, w_q, w_scale))


def test_plan_routes_and_amax_blocks():
    assert gemm_plan(1, 17, 64, 64).route == "wgmma"
    assert gemm_plan(2, 112, 64, 576).route == "wgmma"
    assert gemm_plan(1, 16, 64, 64).route == "skinny"
    # the plan is a function of the shape and the card's SMs only
    assert gemm_plan(1, 112, 128, 1152) == gemm_plan(1, 112, 128, 1152,
                                                     sms=132)
    # a tile axis multiplies the column blocks; only T = 1 shares an amax
    p1, p3 = gemm_plan(1, 4, 3000, 1152), gemm_plan(8, 4, 3000, 1152)
    assert p3.splits < p1.splits
    assert grid_resident(p1, 1, 3000) and not grid_resident(p3, 8, 3000)
    assert amax_blocks(1) == 1 and amax_blocks(512 * 2048) == 264
    assert clamp_floor(torch.bfloat16) != 1e-6
    assert clamp_floor(torch.bfloat16) == float(
        torch.tensor(1e-6).to(torch.bfloat16))


# ----------------------------------------------------------------------
# decode_attention: the plan and the split-and-merge model
# ----------------------------------------------------------------------
DECODE_SHAPES = [(4, 8, 3, 256), (4, 32, 1, 1024), (1, 2, 1, 96),
                 (8, 8, 3, 32768), (1, 4, 9, 4096), (2, 2, 3, 300)]


@pytest.mark.parametrize("B,KH,G,S", DECODE_SHAPES)
def test_decode_plan_covers_every_position_once(B, KH, G, S):
    _, split_len = decode_plan(B, KH, G, S, None)
    for kv_len in (0, 1, S - 1, S):
        for host in (True, False):
            splits, sl = decode_plan(B, KH, G, S, kv_len if host else None)
            assert sl == split_len       # a host and a device kv_len alike
            assert sl >= MIN_SPLIT or sl >= S
            seen = np.zeros(S, np.int64)
            for s0, s1 in split_ranges(splits, sl, kv_len):
                seen[s0:s1] += 1
            assert (seen[:kv_len] == 1).all() and not seen[kv_len:].any()
            if host:
                assert splits == max(1, -(-kv_len // sl))


def test_decode_plan_fills_the_card_at_the_llama_step():
    splits, _ = decode_plan(4, 8, 3, 256, 256)
    assert 4 * 8 * head_blocks(3) * splits >= 132
    assert decode_plan(4, 8, 3, 256, None)[0] == splits
    # the served kv_len 32 of a 256-row cache: one split
    assert decode_plan(4, 8, 3, 256, 32) == (1, 32)
    assert head_blocks(9) == 2 and head_blocks(8) == 1


def split_merge_model(q, k, v, kv_len, splits, split_len):
    """The kernel's arithmetic in float32: q scaled by 1/sqrt(D) first;
    per split a max, a sum of exponentials and a weighted sum of V; the
    splits merged in split order; the sum clamped at 1e-30."""
    B, _, HQ, D = q.shape
    KH = k.shape[2]
    qg = q.reshape(B, KH, HQ // KH, D).float() * (1.0 / D ** 0.5)
    M = torch.full((B, KH, HQ // KH, 1), -1e30)
    parts = []
    for s0, s1 in split_ranges(splits, split_len, kv_len):
        if s0 >= s1:
            continue
        s = torch.einsum("bhgd,bshd->bhgs", qg, k[:, s0:s1].float())
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("bhgs,bshd->bhgd", p, v[:, s0:s1].float())))
        M = torch.maximum(M, m)
    L = torch.zeros_like(M)
    A = torch.zeros(qg.shape)
    for m, l, acc in parts:
        w = torch.exp(m - M)
        L = L + l * w
        A = A + acc * w
    out = A / L.clamp_min(1e-30)
    return out.reshape(B, 1, HQ, D).to(q.dtype)


@pytest.mark.parametrize("B,S,HQ,KH,D", [(4, 256, 24, 8, 128),
                                         (2, 300, 6, 2, 64),
                                         (1, 96, 2, 2, 32),
                                         (1, 130, 36, 4, 16)])
def test_split_merge_model_matches_plain_and_reference(B, S, HQ, KH, D):
    rng = np.random.default_rng(S + HQ)
    q, k, v = (rng.normal(size=sh).astype(np.float32) for sh in
               ((B, 1, HQ, D), (B, S, KH, D), (B, S, KH, D)))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    for kv_len in (1, 33, S - 1, S):
        for host in (True, False):
            splits, sl = decode_plan(B, KH, HQ // KH, S,
                                     kv_len if host else None)
            got = split_merge_model(tq, tk, tv, kv_len, splits, sl)
            want = decode_attention_ref_4d(tq, tk, tv, kv_len)
            assert (got - want).abs().max().item() <= 1e-5
            ref = np.asarray(r_decode_ref_4d(jnp.asarray(q), jnp.asarray(k),
                                             jnp.asarray(v),
                                             jnp.int32(kv_len)))
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    got = split_merge_model(tq, tk, tv, 0, *decode_plan(B, KH, HQ // KH, S,
                                                        None))
    assert not got.abs().any()
    # bfloat16 caches and query: within 2^-6 of max|want| (phase 7's limit)
    bq, bk, bv = (t.to(torch.bfloat16) for t in (tq, tk, tv))
    splits, sl = decode_plan(B, KH, HQ // KH, S, S)
    got = split_merge_model(bq, bk, bv, S, splits, sl)
    want = decode_attention_ref_4d(bq, bk, bv, S)
    assert (got.float() - want.float()).abs().max().item() <= \
        2.0 ** -6 * want.float().abs().max().item()
