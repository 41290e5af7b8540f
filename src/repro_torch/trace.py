"""Named spans of the training step, for a profiler to read.

``with span(MAMBA2): ...`` records one CPU op of that name on the
profiler's own clock while ``torch.profiler`` records, and costs about
half a microsecond when it does not.  A span is not a user annotation
(``record_function``), so the profiler does not project it onto the
device's timeline: the device holds kernels alone, and a reader places
each kernel under the spans open where it was launched.  The spans sit
around the step's phases (``launch/train.py``), the model's layers
(``models/``) and the two kernel ops' forward and backward.
"""
from torch._C._profiler import _RecordFunctionFast as span

#: the phases of one training step, in order
TRAIN_BATCH = "train.batch"            # the draw and the copy to the card
TRAIN_FORWARD = "train.forward"
TRAIN_BACKWARD = "train.backward"
TRAIN_CLIP = "train.clip"
TRAIN_OPTIMIZER = "train.optimizer"    # the schedule and the update
TRAIN_LOSS_READ = "train.loss_read"    # the host's read of the loss

#: the model's layers
EMBED = "embed"
BLOCK = "block"                        # one block, norms and residuals too
MAMBA2 = "mamba2"
MAMBA2_IN_PROJ = "mamba2.in_proj"
MAMBA2_OUT_PROJ = "mamba2.out_proj"
ATTENTION = "attention"
MLP = "mlp"
LOSS = "loss"

#: the kernel ops, forward and backward
GLA_CHUNK = "gla_chunk"
FLASH_ATTENTION = "flash_attention"

