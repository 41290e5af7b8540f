"""flash_attention_roofline: the flash op's least time over its kernels'
device time, forward and backward together (``work/flash_attention.py``).
Layer: the kernels."""
from ..harness.roofline import share
from ..work import flash_attention as work

NAME = "flash_attention_roofline"
UNIT = "%"


def read(rec: dict):
    return share(rec["trace"], work) if rec.get("trace") else None
