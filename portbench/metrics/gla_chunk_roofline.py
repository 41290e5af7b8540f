"""gla_chunk_roofline: the scan op's least time over its kernels' device
time, forward and backward together (``work/gla_chunk.py``).  Layer: the
kernels."""
from ..harness.roofline import share
from ..work import gla_chunk as work

NAME = "gla_chunk_roofline"
UNIT = "%"


def read(rec: dict):
    return share(rec["trace"], work) if rec.get("trace") else None
