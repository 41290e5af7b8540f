from .ops import gla_chunk, gla_chunk_plain  # noqa: F401
from .ref import gla_chunk_ref, gla_recurrence  # noqa: F401
