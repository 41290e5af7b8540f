from .ops import (gla_chunk, gla_chunk_bwd, gla_chunk_bwd_plain,  # noqa: F401
                  gla_chunk_plain)
from .ref import gla_chunk_bwd_ref, gla_chunk_ref, gla_recurrence  # noqa: F401
