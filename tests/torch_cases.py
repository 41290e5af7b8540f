"""Seeded kernel inputs shared by the port's kernel tests (CPU parity in
test_torch_kernels.py, kernel against plain version in test_torch_cuda.py).
Imports neither JAX nor the reference package."""
import numpy as np

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
