"""Plan-tensor compiler: query batches → padded parameter tensors.

The engines take the query *structure* as Python-static and the
*parameters* as data (core/query.py), so every group of instances sharing
``shape_key()`` can run as one stacked tensor batch.  This module is the
lowering step the scheduler feeds the engines:

  * ``bucket_key(qry)`` — the shape bucket an instance lands in (the
    executable-cache key component);
  * ``compile_plan_tensor(queries)`` — stack the per-instance parameter rows
    into one int32[B_pad, n_clauses, 3] tensor, padding the batch axis up to
    the next power of two.

Why pad: an executable's working set (and, in the reference, its trace) is
specialised on B, so rounding B up to pow-2 size buckets bounds the
executables per shape bucket at log2(max batch) — after a short warm phase
the executable cache (cache.py) absorbs every dispatch, exactly as the
reference's does.  Pad slots repeat the first instance's parameters (any
valid row works: batch elements are independent) and are sliced off the
outputs by the scheduler.

The port's copy of the reference package's ``serving/compile.py``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from ..core import query as Q


def bucket_key(qry: Q.PathQuery) -> tuple:
    """The shape bucket of an instance: its hashable structural key."""
    return qry.shape_key()


def pad_batch_size(n: int) -> int:
    """Next power-of-two size bucket (1 → 1, 3 → 4, 5 → 8, ...)."""
    assert n >= 1
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass
class PlanTensor:
    """One shape bucket's batch, lowered to the stacked parameter tensor."""
    key: tuple                 # shape bucket (queries[0].shape_key())
    queries: List[Q.PathQuery]
    params: np.ndarray         # int32[B_pad, n_clauses, 3]
    n_real: int                # live instances; rows [n_real:] are padding

    @property
    def n_pad(self) -> int:
        return self.params.shape[0] - self.n_real


def compile_plan_tensor(queries: Sequence[Q.PathQuery],
                        pad: bool = True) -> PlanTensor:
    """Lower a same-shape batch into one padded parameter tensor."""
    from ..core.engine import check_batch_shape
    key = check_batch_shape(queries)
    rows = np.stack([Q.query_params(q) for q in queries])
    n_real = rows.shape[0]
    if pad:
        b_pad = pad_batch_size(n_real)
        if b_pad > n_real:
            fill = np.broadcast_to(rows[:1], (b_pad - n_real,) + rows.shape[1:])
            rows = np.concatenate([rows, fill], axis=0)
    return PlanTensor(key, list(queries), np.ascontiguousarray(rows), n_real)
