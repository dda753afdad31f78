from .ops import LAUNCHES, ScatterLayout, bucket_scatter, build_layout, reset_launches  # noqa: F401
from .ref import bucket_scatter_plain  # noqa: F401
