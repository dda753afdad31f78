from .ops import (HEAD_DIMS, INT8_HEAD_DIMS, LAUNCHES, MIN_SPLIT_ROWS, ROUTES,  # noqa: F401
                  TC_HEAD_DIMS, attention_route, decode_attention, decode_splits,
                  flash_attention, reset_launches)
from .ref import (attention_int8_plain, attention_plain, decode_attention_split_plain,  # noqa: F401
                  dequantize_kv, visible_rows)
