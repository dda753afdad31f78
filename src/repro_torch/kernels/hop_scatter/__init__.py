from .ops import (LAUNCHES, fused_hop_cols, fused_hop_cols_plain,  # noqa: F401
                  fused_hop_interval, fused_hop_interval_plain,
                  interval_apply_plain, reset_launches, scatter_cols,
                  scatter_cols_plain, scatter_extremum, scatter_extremum_plain,
                  segment_ids)
