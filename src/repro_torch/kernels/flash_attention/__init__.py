from .ops import flash_attention, flash_attention_plain  # noqa: F401
from .ref import attention_ref, attention_ref_chunked  # noqa: F401
