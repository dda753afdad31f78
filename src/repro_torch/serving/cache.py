"""Serving caches: plans and bound executables.

Steady-state serving must not re-plan or rebuild.  Two caches make that an
invariant the scheduler can assert on, with hit/miss counters the replay
harness reports:

  PlanCache        (shape bucket, graph fingerprint, mode, engine[, workers])
                   → chosen (split, hop impl).  The first batch of a bucket
                   pays one batch-aware planner pass; every later batch
                   reuses it.
  ExecutableCache  full dispatch key (plan key + hop-layout signature +
                   padded batch size) → the bound batched executable from
                   the engines.  Together with pow-2 size buckets
                   (compile.py) this caps the executables per shape bucket
                   at log2(max batch size).

The graph fingerprint keys cache entries to graph *content* rather than
object identity, so a regenerated-but-identical graph still hits while a
different graph cannot alias.

The port's copy of the reference package's ``serving/cache.py``.  The
fingerprint hashes the same content, so one graph has one fingerprint in
both packages; the layout signature keys on what the port's hop kernels
bind (the arrival CSR and the lane group), since the port has no block
layouts.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, Optional

from ..core import engine_sliced as _ES
from ..kernels.common import lane_group


def graph_fingerprint(graph) -> str:
    """Content fingerprint of a graph, cached on the graph object.

    Covers everything query results depend on: topology, types, vertex/edge
    lifespans, and the property columns (K_PROP clauses and MIN/MAX
    aggregation read them) — two graphs may only share a fingerprint if every
    engine answer over them is identical."""
    fp = getattr(graph, "_serving_fingerprint", None)
    if fp is None:
        h = hashlib.sha1()
        h.update(repr((graph.n_vertices, graph.n_edges, graph.lifespan,
                       graph.n_vertex_types, graph.n_edge_types)).encode())
        for arr in (graph.v_type, graph.v_life, graph.e_src, graph.e_dst,
                    graph.e_type, graph.e_life):
            h.update(arr.tobytes())
        for name, props in (("v", graph.vprops), ("e", graph.eprops)):
            for key in sorted(props):
                col = props[key]
                h.update(f"{name}{key}".encode())
                h.update(col.vals.tobytes())
                h.update(col.life.tobytes())
        fp = h.hexdigest()[:16]
        graph._serving_fingerprint = fp
    return fp


def layout_signature(graph, engine: str, qry, impl: str,
                     n_workers: int = 0) -> tuple:
    """The static hop-kernel launch identity an executable binds.

    On the kernel path (``impl='cuda'``) the hop kernels B1 and B3 walk an
    arrival CSR — the whole graph's on the dense engine, one arrival type's
    slice per hop on the sliced engine — with a lane group chosen from its
    shape on the host (``kernels.common.lane_group``; one lane an edge).
    Those shapes are part of the dispatch key: two graphs may share a
    content fingerprint yet be served by different launch shapes only if
    the key says so.  On the partitioned engine the kernels walk every
    worker's local CSR flattened into one over the real owned edges
    (``kernels.hop_scatter.WorkerCSR``): its shapes and lane group, for
    ``n_workers``.  Building the signature warms the graph's partition
    cache, as the executable will read it.  ``impl='torch'`` binds nothing:
    ``()``."""
    if impl == "torch":
        return ()
    if engine == "partitioned":
        from ..core import engine_partitioned as _EP

        _, arrays = _EP.partition_for(graph, n_workers)
        W, n_dst = arrays.n_workers, arrays.n_workers * arrays.v_max
        n_real = int(arrays.n_edges.sum())
        return ("worker_csr", W, (n_real,), (n_dst + 1,),
                lane_group(n_real, n_dst, 1))
    n_v = graph.n_vertices
    n_e = int(graph.traversal["arr_ptr"][-1])
    if engine == "sliced":
        sb = _ES.SliceBounds.from_graph(graph)
        types = sorted({vp.vtype for vp in qry.v_preds})
        return tuple(
            (vt, sb.v[vt], sb.e[vt],
             lane_group(sb.e[vt][1] - sb.e[vt][0],
                        sb.v[vt][1] - sb.v[vt][0], 1))
            for vt in types)
    return ("arrival_csr", (n_e,), (n_v + 1,), lane_group(n_e, n_v, 1))


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    invalidations: int = 0   # whole-cache clears (online θ refits) count 1;
                             # targeted evictions (epoch compaction) count
                             # one per dropped entry

    @property
    def lookups(self) -> int:
        return self.hits + self.misses

    def as_dict(self) -> dict:
        return dict(hits=self.hits, misses=self.misses,
                    invalidations=self.invalidations)


class PlanCache:
    """(shape bucket, graph fingerprint, ...) → (split point, hop impl)."""

    def __init__(self):
        self._plans: Dict[tuple, tuple] = {}
        self.stats = CacheStats()

    def get(self, key: tuple) -> Optional[tuple]:
        plan = self._plans.get(key)
        if plan is None:
            self.stats.misses += 1
        else:
            self.stats.hits += 1
        return plan

    def put(self, key: tuple, plan: tuple) -> None:
        self._plans[key] = plan

    def peek(self, key: tuple) -> Optional[tuple]:
        """Lookup WITHOUT touching the hit/miss counters — for admission
        control, which consults the cache but must not skew the steady-state
        no-replan invariant the counters assert."""
        return self._plans.get(key)

    def clear(self) -> None:
        """Drop every cached plan (an online θ refit invalidates them: the
        best split may have moved).  Counters are kept — clears are part of
        the serving history, not a reset of it (``invalidations`` counts
        them)."""
        self._plans.clear()
        self.stats.invalidations += 1

    def evict(self, pred: Callable[[tuple], bool]) -> int:
        """Targeted invalidation: drop entries whose KEY matches ``pred``;
        returns the count.  Unlike ``clear`` (one whole-cache event), every
        evicted entry counts as one invalidation — the live-graph path
        (ROADMAP A8) evicts only keys mentioning retired fingerprints at
        compaction, and the counters are how tests assert that nothing else
        was touched."""
        dead = [k for k in self._plans if pred(k)]
        for k in dead:
            del self._plans[k]
        self.stats.invalidations += len(dead)
        return len(dead)

    def __len__(self) -> int:
        return len(self._plans)


class ExecutableCache:
    """Dispatch key → bound batched executable (``fn(params) -> ExecOutput``).

    ``get_or_build`` runs ``builder`` exactly once per key; the builder
    returns the engine's batched callable already bound to graph/plan/mode.
    """

    def __init__(self):
        self._fns: Dict[tuple, Callable] = {}
        self.stats = CacheStats()

    def get_or_build(self, key: tuple, builder: Callable[[], Callable]):
        fn = self._fns.get(key)
        if fn is None:
            self.stats.misses += 1
            fn = builder()
            self._fns[key] = fn
        else:
            self.stats.hits += 1
        return fn

    def __contains__(self, key: tuple) -> bool:
        return key in self._fns

    def evict(self, pred: Callable[[tuple], bool]) -> int:
        """Targeted invalidation mirroring ``PlanCache.evict`` (one
        invalidation per dropped executable)."""
        dead = [k for k in self._fns if pred(k)]
        for k in dead:
            del self._fns[k]
        self.stats.invalidations += len(dead)
        return len(dead)

    def __len__(self) -> int:
        return len(self._fns)
