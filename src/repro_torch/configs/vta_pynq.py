"""The paper's own hardware configuration (§5): PYNQ-Z1 VTA build.
Not an LM architecture — exposed so examples/benchmarks can grab the
evaluation-platform spec from the same registry."""
from repro_torch.core import hwspec

SPEC = hwspec.pynq()
