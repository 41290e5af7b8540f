from .ops import (flash_attention, flash_attention_bwd,  # noqa: F401
                  flash_attention_plain)
from .ref import (attention_bwd_ref, attention_ref,  # noqa: F401
                  attention_ref_chunked)
