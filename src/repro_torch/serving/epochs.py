"""Epoch-pinned snapshot serving over a streaming event log.

``EpochManager`` is the control loop between a ``graphdata.ingest.EventLog``
and a ``BatchScheduler``: ingest events → seal an epoch → materialize it
incrementally → decide compaction → retire stale cache entries → pin the
scheduler.  Queries keep serving during ingestion because pinning is the
ONLY point where the serving graph changes, and every pinned epoch is an
immutable snapshot (bit-identical to a from-scratch build of its graph —
the conformance harness's ingestion leg).

Fingerprint model (the delta-aware cache invalidation of ROADMAP item 1):

  epoch fingerprint   chained ``events_fingerprint``: hash(prev fp + the
                      epoch's events in canonical order).  O(delta) per
                      epoch; identifies graph *content* because replay is
                      deterministic.  Keys merged-graph executables.
  base fingerprint    ``graph_fingerprint`` of the last compacted graph.
                      Keys plans and base+delta executables — both survive
                      every pure edge-append epoch unchanged, which is why
                      steady-state ingestion costs zero recompilation.
  part fingerprints   one per vertex type, evolved only when an epoch
                      touches that type (vertex events → the vertex's type,
                      edge events → both endpoint types).  The per-
                      partition half of "invalidate only what changed":
                      consumers holding per-type artifacts compare these
                      instead of the whole-graph fingerprint.

Compaction policy: epoch 0 always compacts (it IS the base); afterwards a
window closes when it stops being delta-pure, when ``compact_every`` epochs
have accumulated, or when the delta outgrows ``max_delta_frac`` of the base
edge count — whichever comes first (or on an explicit ``compact=True``).
Compaction re-bases the materializer, recomputes the base fingerprint, and
evicts exactly the cache entries whose keys mention a retired fingerprint
(counted per entry in ``granite_cache_total{event="invalidation"}``).

The port's copy of the reference package's ``serving/epochs.py``: the same
epochs, fingerprints, compaction decisions, WAL notes, metrics and spans.
The vertex types an epoch touches are read a column at a time.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterable, List, Optional

import numpy as np

from ..graphdata.ingest import (EV_ADD_EDGE, EV_ADD_VERTEX, EV_CLOSE_EDGE,
                                EV_CLOSE_VERTEX, EV_SET_EPROP, EV_SET_VPROP,
                                DeltaSpec, Event, EventLog, Materializer,
                                event_columns, events_fingerprint)
from ..obs.trace import NULL_TRACER
from .cache import graph_fingerprint


@dataclasses.dataclass
class Epoch:
    """One sealed, immutable snapshot of the evolving graph."""
    id: int
    n_events: int                     # events sealed into this epoch
    fingerprint: str                  # chained event fingerprint (content id)
    base_fingerprint: str             # fingerprint of the compaction base
    part_fingerprints: Dict[int, str]  # vertex type → per-partition fp
    graph: object                     # the epoch's merged TemporalGraph
    base_graph: object                # compaction base (== graph right after
                                      # a compaction)
    delta: Optional[DeltaSpec]        # pure edge-append window, else None
    compacted: bool                   # this seal closed a compaction window
    n_delta_edges: int                # edges appended since the base


def _mentions(key, fps: frozenset) -> bool:
    """Does a (nested-tuple) cache key mention any retired fingerprint?"""
    if isinstance(key, tuple):
        return any(_mentions(k, fps) for k in key)
    return isinstance(key, str) and key in fps


class EpochManager:
    """Streams events into an ``EventLog`` and serves sealed epochs.

    Typical loop (``launch/query.py --live`` runs it)::

        log, _ = ingest.log_from_graph(seed_graph)    # or a fresh EventLog
        mgr = EpochManager(log, metrics=registry)
        e0 = mgr.seal()                               # epoch 0 == the base
        sched = BatchScheduler(e0.graph, metrics=registry)
        mgr.attach(sched)                             # pins e0
        while serving:
            mgr.ingest(new_events)
            mgr.advance(sched)     # seal → materialize → evict → pin
            sched.run(batch)       # answers AS OF the pinned epoch

    ``seal``/``advance`` are the only methods that change what queries see;
    between them ``ingest`` can run freely (unsealed events are invisible
    to every pinned scheduler — snapshot isolation is structural, not
    locked: each epoch is a fresh immutable graph object).
    """

    def __init__(self, log: EventLog, compact_every: int = 8,
                 max_delta_frac: float = 0.5, metrics=None, tracer=None):
        self.log = log
        self.mat = Materializer(log)
        self.compact_every = int(compact_every)
        self.max_delta_frac = float(max_delta_frac)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        self.current: Optional[Epoch] = None
        self.n_compactions = 0
        self._since_compact = 0
        self._window_fps: List[str] = []   # fingerprints live in this window
        self._part_fps: Dict[int, str] = {}
        if metrics is not None:
            self._mx_events = metrics.counter(
                "granite_ingest_events_total", "events ingested into the log")
            self._mx_epochs = metrics.counter(
                "granite_epochs_total", "epochs sealed")
            self._mx_compactions = metrics.counter(
                "granite_compactions_total", "compaction windows closed")
            self._mx_delta_edges = metrics.gauge(
                "granite_delta_edges", "edges appended since the base")
            self._mx_cache = metrics.counter(
                "granite_cache_total", "serving cache events",
                labelnames=("cache", "event"))
            self._mx_recovery = metrics.counter(
                "granite_recovery_epochs",
                "sealed epochs replayed from a WAL at crash recovery")

    # ------------------------------------------------------------- ingest
    def ingest(self, events: Iterable[Event]) -> int:
        """Append events to the open (unsealed) suffix of the log.  Pinned
        epochs cannot observe them until the next ``seal``/``advance``."""
        sp = self.tracer.start("ingest")
        n = self.log.extend(events)
        self.tracer.end(sp, n_events=n)
        if self.metrics is not None:
            self._mx_events.inc(n)
        return n

    # ------------------------------------------------------------- sealing
    def _touched_types(self, events) -> set:
        """Vertex types an epoch's events touch (computed AFTER the epoch is
        applied, so every key resolves)."""
        cols = event_columns(events)
        out = set(cols[EV_ADD_VERTEX][1][:, 0].tolist())
        vkeys = np.concatenate([cols[k][0] for k in (EV_SET_VPROP,
                                                     EV_CLOSE_VERTEX)])
        ekeys = np.concatenate([cols[k][0] for k in (EV_ADD_EDGE, EV_SET_EPROP,
                                                     EV_CLOSE_EDGE)])
        if len(vkeys):
            out.update(self.mat.vertex_types_of_keys(vkeys).tolist())
        if len(ekeys):
            out.update(self.mat.edge_endpoint_types_of_keys(ekeys)
                       .reshape(-1).tolist())
        return out

    def _should_compact(self) -> bool:
        if not self.mat.delta_pure:
            return True
        if self._since_compact + 1 >= self.compact_every:
            return True
        base_e = max(1, self.mat.base_n_edges)
        delta_e = self.mat.graph.n_edges - self.mat.base_n_edges
        return delta_e > self.max_delta_frac * base_e

    def seal(self, compact: Optional[bool] = None) -> Epoch:
        """Seal the open suffix as the next epoch and materialize it.

        ``compact`` forces (True) or suppresses (False) compaction; None
        applies the policy.  Epoch 0 always compacts — it is the base."""
        # The log may already hold sealed-but-unapplied epochs (e.g. epoch 0
        # from ``log_from_graph``); only seal the open suffix when there is
        # nothing pending, and always read the events of the epoch actually
        # being applied — sealing unconditionally would drift seal() one
        # epoch ahead of apply_next().
        fresh = self.mat.applied >= self.log.n_epochs
        if fresh:
            self.log.seal()
        sp = self.tracer.start("epoch", id=self.mat.applied)
        events = self.log.epoch_events(self.mat.applied)
        ms = self.tracer.start("materialize", parent=sp)
        g = self.mat.apply_next()
        self.tracer.end(ms, n_vertices=g.n_vertices, n_edges=g.n_edges)
        eid = self.mat.applied - 1
        first = self.current is None
        if first:
            fp = graph_fingerprint(g)
        else:
            fp = events_fingerprint(self.current.fingerprint, events)
        do_compact = first or (self._should_compact() if compact is None
                               else bool(compact))
        if do_compact:
            cs = self.tracer.start("compact", parent=sp,
                                   n_delta_edges=(g.n_edges
                                                  - self.mat.base_n_edges))
            self.mat.compact()
            base_fp = graph_fingerprint(g)
            # per-partition fingerprints restart from the new base content
            self._part_fps = {
                t: hashlib.sha1(f"{base_fp}/{t}".encode()).hexdigest()[:16]
                for t in range(g.n_vertex_types)}
            self._since_compact = 0
            self.n_compactions += 1
            if not first:
                self.tracer.end(cs)
            else:
                self.tracer.end(cs, bootstrap=True)
            if self.metrics is not None:
                self._mx_compactions.inc()
        else:
            base_fp = self.current.base_fingerprint
            self._since_compact += 1
            # evolve exactly the touched partitions' fingerprints
            self._part_fps = dict(self._part_fps)
            for t in self._touched_types(events):
                prev = self._part_fps.get(t, "")
                self._part_fps[t] = hashlib.sha1(
                    f"{prev}+{fp}".encode()).hexdigest()[:16]
        if fresh and getattr(self.log, "_wal", None) is not None:
            # journal the decision (policy or forced) so ``recover`` replays
            # it exactly — the recovered base fingerprint must match even
            # when a caller forced compaction off-policy
            self.log.wal_note(eid, compacted=bool(do_compact))
        delta = None if do_compact else self.mat.delta_spec()
        n_delta = g.n_edges - self.mat.base_n_edges
        hint = self.mat.partition_hint()
        if hint is not None:
            g._partition_hint = hint
        ep = Epoch(eid, len(events), fp, base_fp, dict(self._part_fps), g,
                   self.mat.base_graph, delta, do_compact, n_delta)
        self._window_fps.append(fp)
        self.current = ep
        self.tracer.end(sp, fingerprint=fp, compacted=do_compact,
                        n_delta_edges=n_delta)
        if self.metrics is not None:
            self._mx_epochs.inc()
            self._mx_delta_edges.set(n_delta)
        return ep

    # ------------------------------------------------------------ recovery
    @classmethod
    def recover(cls, path, compact_every: int = 8,
                max_delta_frac: float = 0.5, metrics=None, tracer=None,
                fault_plan=None) -> "EpochManager":
        """Rebuild a manager from a WAL after a crash.

        ``EventLog.from_wal`` truncates the torn tail and restores sealed
        epochs + the open suffix; the manager then replays every sealed
        epoch through ``seal`` — compaction decisions come from the
        journaled ``wal_note`` records (policy decisions replay identically
        anyway given the same ``compact_every``/``max_delta_frac``).
        Replay is deterministic, so the recovered pinned epoch's
        fingerprint is bit-identical to the pre-crash one (pinned by
        tests/test_torch_ingest_serving.py).  The WAL is
        re-attached in append mode: ingestion continues where it left off.
        """
        from ..graphdata.ingest import EventLog
        log, notes = EventLog.from_wal(path, fault_plan=fault_plan)
        mgr = cls(log, compact_every=compact_every,
                  max_delta_frac=max_delta_frac, metrics=metrics,
                  tracer=tracer)
        decisions = {int(n["epoch"]): bool(n["compacted"])
                     for n in notes if "compacted" in n}
        n_sealed = log.n_epochs
        sp = mgr.tracer.start("recover", path=str(path), n_epochs=n_sealed,
                              n_open=log.n_open)
        for i in range(n_sealed):
            mgr.seal(compact=decisions.get(i))
        mgr.tracer.end(sp, fingerprint=(mgr.current.fingerprint
                                        if mgr.current else None))
        if metrics is not None and n_sealed:
            mgr._mx_recovery.inc(n_sealed)
        return mgr

    # ------------------------------------------------------------- serving
    def attach(self, scheduler) -> None:
        """Pin ``scheduler`` to the current epoch (seals epoch 0 first if
        the log has open events and nothing was ever sealed)."""
        if self.current is None:
            self.seal()
        scheduler.pin_epoch(self.current)

    def advance(self, scheduler, compact: Optional[bool] = None) -> Epoch:
        """Seal the next epoch, retire stale cache entries, pin the
        scheduler.  The serving-loop step: everything submitted after this
        call answers AS OF the new epoch.

        Cache handling is delta-aware: a non-compacted epoch evicts NOTHING
        (plans and delta executables keep their base-fingerprint keys;
        merged-graph executables of earlier epochs age out at the next
        compaction).  A compacting epoch evicts exactly the entries whose
        keys mention a retired fingerprint — the old base or a superseded
        epoch — and counts each one in
        ``granite_cache_total{cache=...,event="invalidation"}``."""
        prev = self.current
        ep = self.seal(compact=compact)
        if ep.compacted and prev is not None:
            # retire the closed window: the old base fp (plans + delta
            # executables) and superseded epoch fps (merged executables).
            # The new epoch's own fp stays valid — it names the new base.
            retired = (frozenset([prev.base_fingerprint] + self._window_fps)
                       - frozenset([ep.fingerprint, ep.base_fingerprint]))
            n_plans = scheduler.plan_cache.evict(
                lambda k: _mentions(k, retired))
            n_execs = scheduler.exec_cache.evict(
                lambda k: _mentions(k, retired))
            self._window_fps = [ep.fingerprint]
            if self.metrics is not None:
                if n_plans:
                    self._mx_cache.inc(n_plans, cache="plan",
                                       event="invalidation")
                if n_execs:
                    self._mx_cache.inc(n_execs, cache="executable",
                                       event="invalidation")
        scheduler.pin_epoch(ep)
        return ep
