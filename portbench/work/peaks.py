"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

#: bfloat16 and float16 on the tensor cores, FLOP/s
BF16_FLOPS = 989e12
#: TF32 on the tensor cores, FLOP/s (no float32 product runs faster)
TF32_FLOPS = 494.5e12
#: HBM3 bandwidth, bytes/s
HBM_BYTES = 3.35e12

#: bytes of an element of each dtype a counter key names
ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def flops_peak(dtype: str) -> float:
    """The tensor-core rate of products whose operands are `dtype`."""
    return BF16_FLOPS if ELEMENT_BYTES.get(dtype, 4) == 2 else TF32_FLOPS
