from .ops import LAUNCHES, interval_warp, reset_launches  # noqa: F401
from .ref import interval_warp_plain  # noqa: F401
