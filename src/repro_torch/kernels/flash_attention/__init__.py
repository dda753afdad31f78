from .ops import (HEAD_DIMS, LAUNCHES, decode_attention, flash_attention,  # noqa: F401
                  reset_launches)
from .ref import attention_plain  # noqa: F401
