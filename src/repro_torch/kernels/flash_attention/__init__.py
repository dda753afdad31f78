from .ops import (HEAD_DIMS, LAUNCHES, MIN_SPLIT_ROWS, ROUTES, TC_HEAD_DIMS,  # noqa: F401
                  attention_route, decode_attention, decode_splits, flash_attention,
                  reset_launches)
from .ref import attention_plain, decode_attention_split_plain, visible_rows  # noqa: F401
