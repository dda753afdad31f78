from .ops import (LAUNCHES, fused_hop_cols, fused_hop_cols_plain,  # noqa: F401
                  EXT_TILE, SECTOR_FLOATS, VEC, WARP, cols_vector_width,
                  extremum_tiles, lane_group, query_stride, vector_width,
                  fused_hop_interval, fused_hop_interval_plain,
                  interval_apply_plain, reset_launches, scatter_cols,
                  scatter_cols_plain, scatter_extremum, scatter_extremum_plain,
                  segment_ids, WorkerCSR, worker_csr)
