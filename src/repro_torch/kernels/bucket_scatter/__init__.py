from .ops import (LAUNCHES, ScatterLayout, bucket_scatter, build_layout,  # noqa: F401
                  reset_launches)
from .ref import bucket_scatter_lanes_plain, bucket_scatter_plain  # noqa: F401
