"""Seeded kernel inputs shared by the port's kernel tests (CPU parity in
test_torch_kernels.py, kernel against plain version in test_torch_cuda.py),
the int8 activation check the LM tests share, and the launcher of the
mesh tests' ``gloo`` ranks.  Imports neither JAX nor the reference
package."""
import os
import socket
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

INT_MIN = -(1 << 31)
INT_MAX = (1 << 31) - 1

# (M, K, N): one block-aligned shape, one ragged in every dimension
SHAPES = [(128, 128, 128), (37, 70, 50)]
# (epilogue, shift)
EPILOGUES = [("none", 0), ("requant", 0), ("requant", 5), ("requant", 31),
             ("requant", 40), ("dequant", 0)]


def gemm_inputs(M, K, N, seed):
    """a (M, K) int8, w (K, N) int8, bias (N,) int32, scale (N,) f32."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-128, 128, size=(M, K), dtype=np.int8)
    w = rng.integers(-128, 128, size=(K, N), dtype=np.int8)
    bias = rng.integers(-(1 << 20), 1 << 20, size=N, dtype=np.int32)
    scale = (rng.random(N, dtype=np.float32) * 1e-3).astype(np.float32)
    return a, w, bias, scale


def alu_cases():
    """(name, dst, src, chain): the edge cases of the VTA shift rules
    (shr by -3, 0, 31, 33 and INT_MIN through a src tensor), wrapping add
    and mul, and tensor-tensor steps."""
    rng = np.random.default_rng(5)
    M, N = 24, 40
    dst = rng.integers(INT_MIN, INT_MAX, size=(M, N), dtype=np.int64) \
        .astype(np.int32)
    dst[0, :6] = [INT_MIN, INT_MAX, -1, 0, 1, -5]
    shifts = np.full((M, N), 3, np.int32)
    shifts.reshape(-1)[:6 * N] = np.repeat(
        np.array([-3, 0, 31, 33, INT_MIN, 40], np.int32), N)
    src = rng.integers(INT_MIN, INT_MAX, size=(M, N), dtype=np.int64) \
        .astype(np.int32)
    return [
        ("shr_src_edges", dst, shifts, (("shr", None),)),
        ("shr_imm_neg3", dst, None, (("shr", -3),)),
        ("shr_imm_0", dst, None, (("shr", 0),)),
        ("shr_imm_31", dst, None, (("shr", 31),)),
        ("shr_imm_33", dst, None, (("shr", 33),)),
        ("mul_add_overflow", dst, None, (("mul", 3), ("add", INT_MAX))),
        ("tensor_add_mul_overflow", dst, src,
         (("add", None), ("mul", None), ("min", 1000), ("max", -1000))),
        ("relu_requant_chain", dst, None,
         (("shr", 7), ("max", 0), ("max", -128), ("min", 127))),
        ("tensor_min_max", dst, src, (("min", None), ("max", None))),
        ("long_chain_split", dst, None, tuple(
            ("add", i) if i % 2 else ("mul", 3) for i in range(11))),
    ]


# (M, K, N) of the skinny vta_gemm instance: M 1, 3, 16 and 17 (one past
# the cut) with K not a multiple of 16 and N not a multiple of 8, and
# Llama-3.2-3B's and zamba2-1.2b's decode-step linears at M 4
SKINNY_SHAPES = [(1, 1000, 203), (3, 1000, 203), (16, 1000, 203),
                 (17, 1000, 203), (4, 8192, 3072), (4, 3072, 8192),
                 (4, 3072, 1024), (4, 2048, 8384)]
#: activation cases of quantized_linear (see qlinear_x)
QLINEAR_CASES = ("normal", "ties", "zeros", "tiny", "outlier")


def qlinear_x(M, K, case, seed):
    """(M, K) float32 activations for quantized_linear, exact in bfloat16
    except "normal" and "outlier": "ties" puts every x / x_scale on k + 0.5
    (amax 127/16, so x_scale = 1/16 exactly in both dtypes: round half to
    even decides), "zeros" has amax 0 and "tiny" amax below 1e-6 (the
    clamp decides the scale), "outlier" one value 1e4 among unit normals."""
    rng = np.random.default_rng(seed)
    if case == "normal":
        return (rng.normal(size=(M, K)) * 4).astype(np.float32)
    if case == "ties":
        k = rng.integers(-127, 127, size=(M, K))
        x = ((2 * k + 1) / 32.0).astype(np.float32)
        x.reshape(-1)[0] = 127 / 16
        return x
    if case == "zeros":
        return np.zeros((M, K), np.float32)
    if case == "tiny":
        return (rng.integers(-64, 64, size=(M, K)) * 2.0 ** -33) \
            .astype(np.float32)
    if case == "outlier":
        x = rng.normal(size=(M, K)).astype(np.float32)
        x.reshape(-1)[K // 2] = 1e4
        return x
    raise ValueError(case)


def qlinear_w(K, N, seed):
    """w_q (K, N) int8 as a transposed view of a contiguous (N, K) array,
    and w_scale (N,) float32, as quantize_params stores them."""
    rng = np.random.default_rng(seed)
    w_nk = rng.integers(-128, 128, size=(N, K), dtype=np.int8)
    scale = (rng.random(N) * 1e-2 + 1e-4).astype(np.float32)
    return w_nk, scale


#: (T, M, N, K, epilogue, shift) of every vta_gemm launch above 16 rows the
#: task-ISA engine makes on ResNet-18's layers C2-C12, the layer2.0 block
#: and the C2 chain at full width (chip_smoke.py phase 2)
ENGINE_SHAPES = [
    (2, 112, 64, 576, "none", 0), (2, 256, 64, 64, "requant", 6),
    (1, 64, 64, 64, "requant", 6), (1, 112, 128, 576, "none", 0),
    (1, 112, 128, 64, "requant", 6), (2, 112, 128, 1152, "none", 0),
    (1, 112, 128, 1152, "none", 0), (2, 28, 128, 1152, "none", 0),
    (1, 112, 256, 128, "requant", 6), (1, 56, 256, 128, "requant", 6),
    (1, 28, 256, 128, "requant", 6), (2, 56, 64, 2304, "none", 0),
    (2, 28, 64, 2304, "none", 0), (2, 49, 128, 2304, "none", 0),
    (1, 28, 512, 256, "requant", 6), (1, 21, 512, 256, "requant", 6),
    (2, 49, 64, 4608, "none", 0), (2, 112, 64, 1152, "none", 0),
    (2, 256, 64, 64, "none", 0), (1, 64, 64, 64, "none", 0)]
#: (M, N, K) of the LM prefill linears above 16 rows: zamba2-1.2b's
#: 512-token prompt (in_proj, out_proj, attention, gate/up, down) and
#: Llama-3.2-3B's at 512 and 4096 tokens (q/o, k/v, gate/up, down)
PREFILL_SHAPES = [(512, 8384, 2048), (512, 2048, 4096), (512, 2048, 2048),
                  (512, 8192, 2048), (512, 2048, 8192)] + [
    (m, n, k) for m in (512, 4096) for n, k in (
        (3072, 3072), (1024, 3072), (8192, 3072), (3072, 8192))]


#: chains of the scatter instance's cases: none, the 3x3 conv's epilogue
#: (bias add, shift, relu, clip), every op with the shr edge amounts, and
#: a tensor step in the middle
SCATTER_CHAINS = {
    "none": (),
    "bias_shr_relu_clip": (("add", None), ("shr", 8), ("max", 0),
                           ("max", -128), ("min", 127)),
    "every_op": (("mul", 3), ("add", INT_MAX), ("shr", 33), ("min", 1000),
                 ("max", -1000), ("shr", -3), ("shr", 31)),
    "shr_src_edges": (("shr", None), ("add", 5)),
    "mid_tensor": (("shr", 2), ("mul", None), ("max", -7)),
}


def scatter_case(seed, T, chain_name, batch=1, block_out=16,
                 src_int8=False):
    """Random inputs of the scatter instance: a tile grid of accumulator
    ids in shuffled order, 1-3 weight groups of 1-3 parts each (row
    ranges of the grid, a fixed column range per group: parts and groups
    overlap, and some blocks are covered by none), T tiles of GEMM
    outputs (int32 over the full range, so sums wrap, or int8), bias
    operands whose first values are the shr edge amounts, and the chain.
    Returns (grid, groups, mats, bias, chain): groups as lists of (part
    grid, first row), mats[t][g] numpy, bias numpy (T, R, C) or None."""
    rng = np.random.default_rng(seed)
    io, ii = int(rng.integers(2, 7)), int(rng.integers(1, 6))
    base = int(rng.integers(0, 500))
    grid = base + rng.permutation(io * ii).reshape(io, ii)
    groups = []
    for _ in range(int(rng.integers(1, 4))):
        c0 = int(rng.integers(0, ii))
        w = int(rng.integers(1, ii - c0 + 1))
        parts, row = [], 0
        for _ in range(int(rng.integers(1, 4))):
            r0 = int(rng.integers(0, io))
            r1 = int(rng.integers(r0 + 1, io + 1))
            parts.append((grid[r0:r1, c0:c0 + w], row))
            row += (r1 - r0) * batch
        groups.append(parts)
    mats = []
    for _ in range(T):
        tile = []
        for parts in groups:
            rows = sum(g.shape[0] for g, _ in parts) * batch
            shape = (rows, parts[0][0].shape[1] * block_out)
            tile.append(rng.integers(-128, 128, shape, dtype=np.int8)
                        if src_int8 else
                        rng.integers(INT_MIN, INT_MAX, shape, dtype=np.int64)
                        .astype(np.int32))
        mats.append(tile)
    chain = SCATTER_CHAINS[chain_name]
    bias = None
    if any(imm is None for _, imm in chain):
        R, C = io * batch, ii * block_out
        bias = rng.integers(-40, 40, (T, R, C), dtype=np.int32)
        edges = np.array([-3, 0, 31, 33, INT_MIN, 40], np.int32)
        bias.reshape(T, -1)[:, :edges.size] = edges
    return grid, groups, mats, bias, chain


# ----------------------------------------------------------------------
# int8 activations of quantized_linear, port against reference
# ----------------------------------------------------------------------
def _host(a):
    """A torch tensor or a JAX / numpy array as a numpy array (floats as
    float32)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu()
        return (a.float() if a.is_floating_point() else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def record_int8_activations(monkeypatch, layers_module, gemm_module):
    """Record every quantized_linear call a model makes: its float
    activations x (rows, K) and the int8 operand x_q its GEMM receives.
    `layers_module` holds the name ``quantized_linear`` that linear_apply
    calls, `gemm_module` the name ``vta_gemm`` that the quantized_linear
    chain calls (the port's CPU route and the reference's both).  Returns
    the list the calls are appended to, as [x, x_q] pairs."""
    calls = []
    real_ql, real_gemm = layers_module.quantized_linear, gemm_module.vta_gemm

    def ql(x, *args, **kw):
        calls.append([_host(x).reshape(-1, x.shape[-1]), None])
        return real_ql(x, *args, **kw)

    def gemm(a, *args, **kw):
        if calls and calls[-1][1] is None:
            calls[-1][1] = _host(a)
        return real_gemm(a, *args, **kw)
    monkeypatch.setattr(layers_module, "quantized_linear", ql)
    monkeypatch.setattr(gemm_module, "vta_gemm", gemm)
    return calls


def assert_int8_activations_match(got, want, ulps=4):
    """Hold each quantized_linear call's int8 activations (`got`, the
    port's record_int8_activations list) to the reference's (`want`), call
    by call: equal, except by one step where the reference's x / x_scale
    lies within `ulps` float32 ulps of a .5 rounding tie (there an ulp of
    difference in x, which the two frameworks' norms and sums leave,
    rounds to the other side).  x_scale is the reference's: max|x|
    clamped at 1e-6, over 127, in float32.  Returns the number of such
    tie flips."""
    assert len(got) == len(want), (len(got), len(want))
    flips = 0
    for i, ((_, q_got), (x, q_want)) in enumerate(zip(got, want)):
        assert q_got is not None and q_want is not None, i
        assert q_got.dtype == q_want.dtype == np.int8, i
        assert q_got.shape == q_want.shape, (i, q_got.shape, q_want.shape)
        diff = q_got.astype(np.int32) - q_want.astype(np.int32)
        if not diff.any():
            continue
        scale = np.float32(max(np.abs(x).max(), np.float32(1e-6))) \
            / np.float32(127.0)
        t = np.abs(x.astype(np.float64) / np.float64(scale))
        near_tie = np.abs(t - np.floor(t) - 0.5) \
            <= ulps * np.finfo(np.float32).eps * np.maximum(t, 1.0)
        off = (diff != 0) & ~((np.abs(diff) == 1) & near_tie)
        assert not off.any(), (
            f"call {i}: {int(off.sum())} int8 activations differ from the "
            f"reference away from a rounding tie (x / scale "
            f"{t[off][:4].tolist()}, got {q_got[off][:4].tolist()}, want "
            f"{q_want[off][:4].tolist()})")
        flips += int((diff != 0).sum())
    return flips


# ----------------------------------------------------------------------
# gloo ranks on the CPU
# ----------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_cfg(arch):
    """The reduced config the mesh tests train (llama3.2-3b with remat)."""
    from repro_torch.configs import get_arch, reduced
    cfg = reduced(get_arch(arch).model).replace(max_seq=128)
    return cfg.replace(remat=True) if arch == "llama3.2-3b" else cfg


def mesh_vs_meshless(cfg, shape, steps, optimizer="adamw", fsdp=False):
    """In a rank of ``spawn_ranks``: `cfg` trained `steps` steps through
    ``Trainer(mesh=)`` on a (data, model) mesh of `shape`, and on rank 0
    the meshless Trainer from the same seed beside it.  Returns a record:
    the mesh run's losses and gradient norms, the leaves it computes split
    over "model" with their local and whole shapes, the (query, KV) head
    counts its flash calls saw; on rank 0 also the meshless run's losses
    and gradient norms, and for each leaf its largest difference from the
    meshless run (gathered whole): of the first step's gradient over the
    meshless gradient's max|.| (``grad_err``), and of the parameter after
    the steps over the meshless run's largest change of it
    (``param_err``)."""
    import torch
    import torch.distributed as dist
    from repro_torch import tree
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import (Trainer, _from_local, _gather,
                                          build_mesh_grad_fn)
    from repro_torch.models import attention
    from repro_torch.models import transformer as T

    def rel(a, b, scale):
        return float((a - b).abs().max() / scale.abs().max().clamp_min(1e-30))

    kw = dict(optimizer=optimizer, seq_len=32, global_batch=4,
              peak_lr=3e-3, seed=0, torch_device="cpu")
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    tr = Trainer(cfg, mesh=mesh, fsdp=fsdp, **kw)
    sh = tree.flatten(tr.p_shard)
    batch = tr.batch(0)
    _, grads = build_mesh_grad_fn(cfg, mesh, tr.p_shard, tr.model_split)(
        tr.params, batch)
    grads = {k: _gather(_from_local(g, sh[k]), ())
             for k, g in tree.flatten(grads).items()}
    real, heads = attention.flash_attention, set()

    def spy(q, k, v, causal=True):
        heads.add((q.shape[2], k.shape[2]))
        return real(q, k, v, causal=causal)
    attention.flash_attention = spy
    try:
        hist = tr.train(steps, log_every=1000)
    finally:
        attention.flash_attention = real
    flat = tree.flatten(tr.params)
    rec = dict(shape=list(shape), loss=hist["loss"],
               grad_norm=hist["grad_norm"], heads=sorted(heads),
               split=sorted(k for k, v in tr.model_split.items() if v),
               local={k: list(v.to_local().shape) for k, v in flat.items()},
               whole={k: list(v.shape) for k, v in flat.items()})
    after = {k: _gather(v, ()).detach() for k, v in flat.items()}
    if dist.get_rank() == 0:
        ref = Trainer(cfg, **kw)
        flat0 = tree.flatten(ref.params)
        loss, _ = T.forward_train(ref.params, cfg, batch)
        g0 = torch.autograd.grad(loss, list(flat0.values()))
        rec["grad_err"] = {k: rel(grads[k], g, g)
                           for k, g in zip(flat0, g0)}
        init = {k: v.detach().clone() for k, v in flat0.items()}
        want = ref.train(steps, log_every=1000)
        rec["meshless"] = dict(loss=want["loss"],
                               grad_norm=want["grad_norm"])
        rec["param_err"] = {k: rel(after[k], v.detach(),
                                   v.detach() - init[k])
                            for k, v in flat0.items()}
    return rec


def mask_targets(tr):
    """Unequal counted targets across a 2-rank split of `tr`'s batches:
    the first 10 targets of row 0 ignored (-1) in every batch."""
    real = tr.data.batch

    def batch(step):
        b = real(step)
        b["targets"][0, :10] = -1
        return b
    tr.data.batch = batch


def spawn_ranks(body: str, world: int, timeout: float = 240.0):
    """Run the Python source `body` in `world` processes joined by a
    ``gloo`` process group (``RANK`` and ``WORLD`` are defined for it,
    ``dist`` is ``torch.distributed``), with the repository's ``src`` and
    ``tests`` on the path.  Returns each rank's stdout.  A rank that exits non-zero
    fails the call with its stderr; every process still running at
    `timeout` seconds is killed and the call fails."""
    pre = textwrap.dedent(f"""
        import os
        import torch
        import torch.distributed as dist
        torch.set_num_threads(2)
        RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD"])
        dist.init_process_group(
            "gloo", init_method="tcp://127.0.0.1:{_free_port()}",
            rank=RANK, world_size=WORLD)
    """)
    code = pre + textwrap.dedent(body) + "\ndist.destroy_process_group()\n"
    procs, files = [], []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD=str(world),
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src"), str(ROOT / "tests")]),
                   OMP_NUM_THREADS="2")
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        files.append((out, err))
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env,
                                      cwd=str(ROOT), stdout=out, stderr=err,
                                      text=True))

    def read(f):
        f.seek(0)
        return f.read()

    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:     # the others may wait on it in a collective
                raise AssertionError(
                    f"rank {bad[0]} exited {codes[bad[0]]}:\n"
                    f"{read(files[bad[0]][1])[-4000:]}")
            if all(c == 0 for c in codes):
                return [read(out) for out, _ in files]
            if time.monotonic() > deadline:
                raise AssertionError(f"ranks still running after {timeout} "
                                     f"s:\n{read(files[0][1])[-2000:]}")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in files:
            out.close()
            err.close()
