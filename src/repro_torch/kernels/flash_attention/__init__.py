from .ops import (flash_attention, flash_attention_bwd,  # noqa: F401
                  flash_attention_fwd, flash_attention_plain)
from .ref import (attention_bwd_ref, attention_lse_ref,  # noqa: F401
                  attention_ref, attention_ref_chunked)
