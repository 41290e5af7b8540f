"""The dry run (``repro_torch.launch.dryrun``) against the reference's,
its rendering, and the kernel ops' meta routes, on the CPU.

  (a) Against the reference (``repro.launch.dryrun.run_cell`` with
      ``make_production_mesh`` patched to a small mesh, in a subprocess
      on XLA host devices; the port's in another, as rank 0 of a fake
      process group): a reduced llama3.2-3b and phi3.5-moe (2 layers,
      d_model 64, 4 experts for the moe) on a 128-token, batch-8 train
      shape, and reduced llama3.2-3b prefill and decode cells of the same
      size, float and int8 (PTQ: the heads split over "model" with the
      int8 weights, ``sharding.model_split_leaves``).  The port's
      ``argument_size_in_bytes`` (the rank's parameter, optimizer,
      batch and cache shards) equals the reference's at a
      multi-device mesh -- (2, 4) for the train cells, (4, 2) for the
      serve cells, where "model" divides the 2 kv heads (at (2, 4) the
      reference splits the cache's positions over "model", which the
      port's layers never do: they hold them whole) -- and its
      ``dot_flops_per_device`` is within 2% of the reference's at (1, 1)
      (the kernels report the reference oracles' FLOPs; measured equal);
      the int8 cells all-reduce each quantized linear's activation max
      over "data", the row-parallel ones' over "model" too.  A reduced
      kimi-k2 prefill cell, float and int8 at (4, 2), runs on the port
      alone (the reference's fused expert-parallel layer raises KeyError
      on int8 weights under a mesh): its shared expert's linears reduce
      their activation max as the dense MLP's do.
  (c) ``tools/make_experiments.py``, unedited, run in a temporary
      directory holding the port's cell JSONs written by the CLI,
      prints a row for each cell.
  (d) The meta routes: each kernel op on ``meta`` tensors returns the
      shapes and dtypes of its CPU route, launches nothing, allocates
      what its card route allocates (the scratch each plan asks for:
      the flash backward's (L, Delta) rows, the wide kernel's L above
      256, ``quantized_linear``'s int8 x_q and its split-K partials, the
      decode split's partials, the gla backward's tile states) and
      reports the reference oracle's FLOPs to ``op_analysis``.

The collectives against real ``gloo`` ranks are
``tests/test_torch_dryrun_ranks.py``.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from torch_cases import ROOT

#: reduced widths of the comparison cells (the reference's and the port's
#: overrides of the production configs)
LLAMA = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab_size=512)
PHI = dict(LLAMA, moe_experts=4, moe_top_k=2, moe_d_ff=64)
#: (arch, shape name, overrides, the multi-device mesh, int8 PTQ)
CELLS = [("llama3.2-3b", "train_128", LLAMA, (2, 4), False),
         ("phi3.5-moe-42b-a6.6b", "train_128", PHI, (2, 4), False),
         ("llama3.2-3b", "prefill_128", LLAMA, (4, 2), False),
         ("llama3.2-3b", "decode_128", LLAMA, (4, 2), False),
         ("llama3.2-3b", "prefill_128", LLAMA, (4, 2), True),
         ("llama3.2-3b", "decode_128", LLAMA, (4, 2), True)]
IDS = ["llama-train", "phi-train", "llama-prefill", "llama-decode",
       "llama-prefill-int8", "llama-decode-int8"]
KIMI = dict(PHI, n_shared_experts=1)
#: cells only the port runs: the reference's fused expert-parallel layer
#: reads the shared experts' float ``w`` and raises KeyError on int8
#: weights under a mesh
PORT_CELLS = [("kimi-k2-1t-a32b", "prefill_128", KIMI, (4, 2), False),
              ("kimi-k2-1t-a32b", "prefill_128", KIMI, (4, 2), True)]
PORT_IDS = ["kimi-prefill", "kimi-prefill-int8"]

RUN_CELLS = """
import json, sys
which = sys.argv[1]
if which == "ref":
    import repro.launch.dryrun as D
    from repro.configs import SHAPES
    from repro.configs.base import ShapeSpec
    from repro.launch.mesh import make_mesh
else:
    import repro_torch.launch.dryrun as D
    from repro_torch.configs import SHAPES
    from repro_torch.configs.base import ShapeSpec
for kind in ("train", "prefill", "decode"):
    SHAPES[kind + "_128"] = ShapeSpec(kind + "_128", 128, 8, kind)
out = {}
for i, (arch, shape, ov, mesh, q) in enumerate(json.loads(sys.argv[2])):
    for m in (tuple(mesh), (1, 1)):
        if which == "ref":
            D.make_production_mesh = (
                lambda multi_pod=False, m=m: make_mesh(m, ("data", "model")))
            c = D.run_cell(arch, shape, False, quantized=q, overrides=ov,
                           verbose=False)
        else:
            c = D.run_cell(arch, shape, False, quantized=q, overrides=ov,
                           verbose=False, mesh_shape=m)
        out[f"{i} {m}"] = dict(args=c["memory"]["argument_size_in_bytes"],
                               flops=c["hlo"]["dot_flops_per_device"],
                               coll=c["hlo"].get("collective_counts_by_axis"))
print("OUT" + json.dumps(out))
"""


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]), JAX_PLATFORMS="cpu",
        OMP_NUM_THREADS="2")


@pytest.fixture(scope="module")
def both():
    """{"ref"|"port": {"<cell> <mesh>": {args, flops}}}: the reference and
    the port, each in its own subprocess, run at once."""
    cells = {"ref": json.dumps(CELLS), "port": json.dumps(CELLS + PORT_CELLS)}
    procs = {w: subprocess.Popen(
        [sys.executable, "-c", RUN_CELLS, w, cells[w]], env=_env(),
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for w in ("ref", "port")}
    out = {}
    try:
        for w, p in procs.items():
            stdout, stderr = p.communicate(timeout=150)
            assert p.returncode == 0, f"{w}: {stderr[-3000:]}"
            line = next(x for x in stdout.splitlines()
                        if x.startswith("OUT"))
            out[w] = json.loads(line[3:])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.mark.parametrize("i", range(len(CELLS)), ids=IDS)
def test_argument_bytes_equal_reference(both, i):
    key = f"{i} {tuple(CELLS[i][3])}"
    assert both["port"][key]["args"] == both["ref"][key]["args"]


@pytest.mark.parametrize("i", range(len(CELLS)), ids=IDS)
def test_one_device_dot_flops_match_reference(both, i):
    key = f"{i} {(1, 1)}"
    assert both["ref"][key]["args"] == both["port"][key]["args"]
    ref, port = both["ref"][key]["flops"], both["port"][key]["flops"]
    assert abs(port - ref) <= 0.02 * ref, (port, ref)


@pytest.mark.parametrize("kind", ["prefill", "decode", "kimi-prefill"])
def test_int8_cells_reduce_the_activation_max(both, kind):
    """At (4, 2) the int8 serve cell all-reduces each quantized linear's
    activation max over "data" (the batch is split there: 7 linears a
    layer, the shared expert's in kimi-k2's moe layers) and each
    row-parallel one's over "model" too (wo, mlp or shared-expert wo):
    the float cell's all-reduces plus seven a layer over "data" and two
    over "model" (none over "data" in llama's float cell)."""
    ids = IDS + PORT_IDS
    if kind.startswith("kimi"):
        i_f = ids.index(kind)
    else:
        i_f = ids.index(f"llama-{kind}")
    i_q = ids.index(f"{ids[i_f]}-int8")
    mesh = tuple((CELLS + PORT_CELLS)[i_q][3])
    f = both["port"][f"{i_f} {mesh}"]["coll"]
    q = both["port"][f"{i_q} {mesh}"]["coll"]
    layers = LLAMA["n_layers"]
    f_data = f.get("data", {}).get("all-reduce", 0)
    if not kind.startswith("kimi"):
        assert f_data == 0
    assert q["data"]["all-reduce"] == f_data + 7 * layers
    assert q["model"]["all-reduce"] == f["model"]["all-reduce"] + 2 * layers


def test_make_experiments_renders_the_ports_cells(tmp_path):
    """The CLI writes its cells (a full-size llama3.2-3b train_4k and a
    reduced llama3.2-3b decode_32k, both on the 16x16 production mesh)
    under experiments/dryrun; the reference's renderer prints a row for
    each."""
    env = _env()
    out = tmp_path / "experiments" / "dryrun"
    runs = [["--arch", "llama3.2-3b", "--shape", "train_4k"],
            ["--arch", "llama3.2-3b", "--shape", "decode_32k",
             "--override", json.dumps(dict(LLAMA, n_kv_heads=4)),
             "--tag", "reduced"]]
    for argv in runs:
        p = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                            "--mesh", "single", "--out", str(out)] + argv,
                           env=env, cwd=str(tmp_path), capture_output=True,
                           text=True, timeout=120)
        assert p.returncode == 0, p.stderr[-3000:]
        assert "cells traced OK" in p.stdout
    names = sorted(os.listdir(out))
    assert names == ["llama3.2-3b__decode_32k__single__reduced.json",
                     "llama3.2-3b__train_4k__single.json"]
    cell = json.loads((out / names[1]).read_text())
    assert cell["memory"]["total_bytes_per_device"] > \
        cell["memory"]["argument_size_in_bytes"] > 0
    assert cell["hlo"]["collective_counts"]["all-reduce"] > 0
    p = subprocess.run([sys.executable,
                        str(ROOT / "tools" / "make_experiments.py")],
                       env=env, cwd=str(tmp_path), capture_output=True,
                       text=True, timeout=60)
    assert p.returncode == 0, p.stderr
    rows = [x for x in p.stdout.splitlines()
            if x.startswith("| llama3.2-3b |")]
    assert len(rows) == 2
    assert any("| train_4k | 16x16 |" in r for r in rows)
    assert any("decode_32k" in r and "| 16x16 |" in r for r in rows)


# ----------------------------------------------------------------------
# (d) the meta routes
# ----------------------------------------------------------------------
class _Allocs(TorchDispatchMode):
    """(op, shape, dtype) of every tensor the block's factory, copy and
    pad ops make."""
    MAKERS = ("empty", "zeros", "empty_like", "zeros_like", "new_empty",
              "new_zeros", "empty_strided", "constant_pad_nd", "clone")

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func._opname in self.MAKERS and isinstance(out, torch.Tensor):
            self.made.append((func._opname, tuple(out.shape), out.dtype))
        return out


def _meta_and_cpu(fn, *tensors, **kw):
    """fn on meta copies of `tensors` (allocations recorded, the analysis
    on) and on the CPU tensors: (meta outputs, cpu outputs, allocations,
    the analysis)."""
    from repro_torch.launch import op_analysis
    metas = [None if t is None else t.to("meta") for t in tensors]
    rec = _Allocs()
    with op_analysis.analyze() as stats, rec:
        got = fn(*metas, **kw)
    want = fn(*tensors, **kw)
    return got, want, rec.made, stats


def _same_outputs(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.device.type == "meta"
        assert a.shape == b.shape and a.dtype == b.dtype


def _rand(*shape, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


@pytest.mark.parametrize("D,dtype", [(64, torch.bfloat16),
                                     (72, torch.bfloat16),
                                     (20, torch.float32), (160, torch.float32),
                                     (320, torch.bfloat16),
                                     (200, torch.bfloat16),
                                     (160, torch.bfloat16)],
                         ids=["64-bf16", "72-bf16", "20-f32", "160-f32",
                              "320-bf16", "200-bf16", "160-bf16"])
def test_flash_meta_route(D, dtype):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd,
                                                     flash_attention_fwd)
    from repro_torch.kernels.flash_attention.kernel import (
        ROW_PAD, head_dim_plan, wide_fwd_launches)
    B, S, HQ, KH = 2, 40, 4, 2
    q, k, v = (_rand(B, S, h, D, dtype=dtype, seed=i)
               for i, h in enumerate((HQ, KH, KH)))
    before = (flash_attention.launches, flash_attention.bwd_launches)
    plan = head_dim_plan(D, dtype)
    # a served call: the wide kernels' L is scratch where their plan asks
    got, want, made, _ = _meta_and_cpu(
        lambda *t: flash_attention(*t, causal=True), q, k, v)
    _same_outputs(got, want)
    scratch = plan.kernels == "wide" and wide_fwd_launches(plan.dp,
                                                           dtype) == 2
    assert (("empty", (B, HQ, S), torch.float32) in made) == scratch
    got, want, made, stats = _meta_and_cpu(
        lambda *t: flash_attention_fwd(*t, causal=True), q, k, v)
    _same_outputs(got, want)
    if plan.dp != D:                   # zero-padded operands
        assert ("constant_pad_nd", (B, S, HQ, plan.dp), dtype) in made
    assert ("empty", (B, HQ, S), torch.float32) in made    # L
    assert stats.kernels["flash_attention"][1] == 4 * B * HQ * S * S * D
    o, lse = want
    do = _rand(B, S, HQ, D, dtype=dtype, seed=9)
    got, want, made, stats = _meta_and_cpu(
        lambda *t: flash_attention_bwd(*t[:5], causal=True, lse=t[5]),
        q, k, v, o, do, lse)
    _same_outputs(got, want)
    if plan.kernels == "tensor":       # each row's (L, Delta), padded rows
        assert ("empty", (B * HQ, -(-S // ROW_PAD) * ROW_PAD, 2),
                torch.float32) in made
    else:                              # Delta
        assert ("empty", (B, HQ, S), torch.float32) in made
    assert stats.kernels["flash_attention_bwd"][1] == 8 * B * HQ * S * S * D
    assert (flash_attention.launches, flash_attention.bwd_launches) == before


def test_flash_meta_route_carries_autograd():
    """A train step's attention on meta: the autograd Function saves L and
    its backward takes the meta route too."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import op_analysis
    q = torch.empty(1, 32, 4, 64, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.empty(1, 32, 2, 64, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    with op_analysis.analyze() as stats:
        dq, dk = torch.autograd.grad(flash_attention(q, k, k).sum(), [q, k])
    assert dq.shape == q.shape and dk.shape == k.shape
    assert set(stats.kernels) == {"flash_attention", "flash_attention_bwd"}


@pytest.mark.parametrize("heads", [4, 1], ids=["per-head", "broadcast"])
def test_gla_meta_route(heads):
    from repro_torch.kernels.gla_chunk import gla_chunk, gla_chunk_bwd
    from repro_torch.kernels.gla_chunk.kernel import BWD_TILE
    B, S, H, N, P, Q = 1, 64, 4, 16, 24, 32
    q, k = (_rand(B, S, heads, N, seed=i) for i in (0, 1))
    v = _rand(B, S, H, P, seed=2)
    la = -torch.rand(B, S, H, generator=torch.Generator().manual_seed(3))
    before = (gla_chunk.launches, gla_chunk.bwd_launches)
    got, want, made, stats = _meta_and_cpu(
        lambda *t: gla_chunk(*t, chunk=Q), q, k, v, la)
    _same_outputs(got, want)
    flops = B * H * (S // Q) * (2 * Q * Q * (N + P) + 4 * Q * N * P)
    assert stats.kernels["gla_chunk"][1] == flops
    dy = _rand(B, S, H, P, seed=4)
    got, want, made, stats = _meta_and_cpu(
        lambda *t: gla_chunk_bwd(*t[:4], None, t[4], None, chunk=Q),
        q, k, v, la, dy)
    _same_outputs(got, want)
    nt = -(-S // BWD_TILE)
    assert made.count(("empty", (B * H, nt, N, P), torch.float32)) == 2
    assert stats.kernels["gla_chunk_bwd"][1] == 2 * flops
    assert (gla_chunk.launches, gla_chunk.bwd_launches) == before


def test_decode_meta_route():
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention.kernel import (SMS,
                                                             decode_plan)
    B, S, HQ, KH, D = 2, 512, 8, 2, 64
    q = _rand(B, 1, HQ, D, dtype=torch.bfloat16)
    kc, vc = _rand(B, S, KH, D, seed=1), _rand(B, S, KH, D, seed=2)
    before = decode_attention.launches
    got, want, made, stats = _meta_and_cpu(
        lambda *t: decode_attention(*t, S), q, kc, vc)
    _same_outputs(got, want)
    G = HQ // KH
    splits, _ = decode_plan(B, KH, G, S, S, SMS)
    assert splits > 1
    assert ("empty", (B * KH * splits * G * (D + 2),), torch.float32) in made
    assert stats.kernels["decode_attention"][1] == 4 * B * HQ * S * D
    assert decode_attention.launches == before


@pytest.mark.parametrize("M", [4, 48], ids=["skinny", "wgmma"])
def test_quantized_linear_meta_route(M):
    from repro_torch.kernels.vta_gemm import quantized_linear, vta_gemm
    from repro_torch.kernels.vta_gemm.kernel import gemm_plan, padded_k
    K, N = 200, 96
    x = _rand(M, K)
    g = torch.Generator().manual_seed(5)
    w = torch.randint(-128, 128, (N, K), generator=g, dtype=torch.int8).t()
    sc = torch.rand(N, generator=g) * 1e-2
    before = vta_gemm.launches
    got, want, made, stats = _meta_and_cpu(quantized_linear, x, w, sc)
    _same_outputs(got, want)
    plan = gemm_plan(1, M, N, K, 132)
    if plan.route == "wgmma":          # x quantized once into x_q
        assert ("empty", (M, padded_k(K)), torch.int8) in made
        assert ("constant_pad_nd", (N, padded_k(K)), torch.int8) in made
    else:                              # the split's int32 partial sums
        assert plan.splits > 1
        assert any(op == "zeros" and dt == torch.int32
                   and shape[0] >= M * N for op, shape, dt in made)
    assert stats.kernels["quantized_linear"][1] == 2 * M * N * K
    assert vta_gemm.launches == before
