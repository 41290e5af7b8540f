"""step_mfu: the whole training step's share of the card's bfloat16 peak:
the model FLOPs (``work/model_flops.py``) of the steps of the measured
window, over the window's seconds and 989 TFLOP/s.  Layer: the training
step (``launch/train.py``).  It bounds every kernel's gain once a kernel
leaves the path."""
from ..work.peaks import BF16_FLOPS

NAME = "step_mfu"
UNIT = "%"


def read(rec: dict):
    w = rec.get("window")
    if not w or not w.get("steps") or "model_flops_per_step" not in rec:
        return None
    return 100.0 * rec["model_flops_per_step"] * w["steps"] \
        / w["seconds"] / BF16_FLOPS
