from .ops import decode_attention  # noqa: F401
from .ref import (NEG_INF, decode_attention_ref,  # noqa: F401
                  decode_attention_ref_4d)
