"""Streaming ingestion: append-only temporal event log + canonical replay.

Every structure downstream of this module — sorted-CSR traversal layouts,
partition tables, serving-cache fingerprints — assumes a frozen graph.  This
module is the boundary that makes "frozen" a *per-epoch* notion instead of a
forever one (ROADMAP item 1; the snapshot/delta storage split of "Storing and
Querying Evolving Graphs in NoSQL Storage Models"):

  EventLog      append-only log of temporal events (vertex/edge add, property
                set, interval close) with external integer keys.  ``seal()``
                freezes the current suffix as one **epoch**; sealed prefixes
                are immutable forever.
  materialize   from-scratch canonical replay of the first k epochs into a
                TemporalGraph — the reference semantics.  The canonical
                orders are chosen so that (a) replay is insensitive to event
                order within an epoch and (b) every epoch's arrays are an
                *extension* of the previous epoch's (append-friendly).
  Materializer  the incremental path: applies one sealed epoch to the
                previous epoch's graph with a monotone gid remap, a
                searchsorted merge of new traversal entries into the
                arrival-sorted order (no O(E log E) re-lexsort), and
                copy-on-write property columns — **bit-identical** to
                ``materialize`` (pinned by tests/test_torch_ingest.py).
  DeltaSpec     padded arrays for the base-CSR + delta-segment
                execution path (``engine.batch_executable_delta``): when the
                window since the last compaction is pure edge-appends, the
                serving scheduler keeps dispatching the *base* graph's
                executables and adds an unsorted delta-segment delivery per
                hop — cross-epoch executable-cache hits.

Canonical orders (the whole module hangs on these three):

  vertices   (vtype, epoch introduced, external key)  — type-major is
             preserved (``type_ranges`` stays a range check) and new
             vertices of a type append at the end of its block, so the gid
             remap between epochs is monotone;
  edges      (epoch introduced, src key, dst key, etype, external key) —
             edge ids are append-only across epochs, so eprop rows and
             traversal ``t_eid`` entries never move;
  prop rows  per entity (epoch, life start, life end, value) — a set, not a
             sequence: any within-epoch event permutation pivots to the same
             PropColumn.

Within one epoch the materializer groups events by kind before applying
them, so replay is order-insensitive *by construction*; the only
order-sensitive part is the log's optional incremental referential-integrity
validation (``validate=False`` to ingest unordered streams).

The port's copy of the reference package's ``graphdata/ingest.py``: the same
events, log, WAL bytes, fingerprints and epoch arrays.  Replay works on
columns (one numpy pass per event kind, external keys mapped to dense ids by
``KeyIndex``'s sorted search) where the reference walks entity by entity,
and ``DeltaSpec.device(device)`` gives torch tensors on an explicit device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.graph import (NO_VALUE, PropColumn, TemporalGraph,
                          make_prop_column)

# ---------------------------------------------------------------- events
EV_ADD_VERTEX = 0    # key=vertex key,  data=(vtype, life0, life1)
EV_ADD_EDGE = 1      # key=edge key,    data=(src key, dst key, etype, l0, l1)
EV_SET_VPROP = 2     # key=vertex key,  data=(prop key, value, l0, l1)
EV_SET_EPROP = 3     # key=edge key,    data=(prop key, value, l0, l1)
EV_CLOSE_VERTEX = 4  # key=vertex key,  data=(t,)   → life1 = min(life1, t)
EV_CLOSE_EDGE = 5    # key=edge key,    data=(t,)

EVENT_KINDS = (EV_ADD_VERTEX, EV_ADD_EDGE, EV_SET_VPROP, EV_SET_EPROP,
               EV_CLOSE_VERTEX, EV_CLOSE_EDGE)


@dataclasses.dataclass(frozen=True, order=True)
class Event:
    """One temporal event.  ``order=True`` gives the canonical within-epoch
    sort (kind, key, data) used by the permutation-invariant fingerprints."""
    kind: int
    key: int
    data: Tuple[int, ...]


def add_vertex(key: int, vtype: int, life: Tuple[int, int]) -> Event:
    return Event(EV_ADD_VERTEX, int(key), (int(vtype), int(life[0]), int(life[1])))


def add_edge(key: int, src_key: int, dst_key: int, etype: int,
             life: Tuple[int, int]) -> Event:
    return Event(EV_ADD_EDGE, int(key),
                 (int(src_key), int(dst_key), int(etype),
                  int(life[0]), int(life[1])))


def set_vprop(key: int, pkey: int, value: int, life: Tuple[int, int]) -> Event:
    return Event(EV_SET_VPROP, int(key),
                 (int(pkey), int(value), int(life[0]), int(life[1])))


def set_eprop(key: int, pkey: int, value: int, life: Tuple[int, int]) -> Event:
    return Event(EV_SET_EPROP, int(key),
                 (int(pkey), int(value), int(life[0]), int(life[1])))


def close_vertex(key: int, t: int) -> Event:
    return Event(EV_CLOSE_VERTEX, int(key), (int(t),))


def close_edge(key: int, t: int) -> Event:
    return Event(EV_CLOSE_EDGE, int(key), (int(t),))


# ------------------------------------------------------------------- WAL
#: genesis value of the WAL's chained record fingerprint
WAL_GENESIS = "wal:genesis"


def _wal_payload(obj: dict) -> str:
    """Canonical serialization a record's chain fingerprint is computed
    over (sorted keys, no whitespace — byte-stable across processes)."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.bool_):
        return bool(o)
    raise TypeError(f"not JSON-serializable: {type(o).__name__}")


def _json_safe_meta(meta: dict) -> dict:
    """The journalable subset of a log's meta: entries that survive a JSON
    round trip (numpy scalars normalised).  Non-serializable attachments
    (e.g. the LDBC generator's ``builder`` object, kept for query
    rewriting) are dropped — nothing fingerprint- or execution-relevant
    lives there, and a recovered deployment regenerates them from
    ``meta["params"]``."""
    out = {}
    for k, v in meta.items():
        try:
            out[k] = json.loads(json.dumps(v, default=_json_default))
        except TypeError:
            continue
    return out


def _wal_chain(prev_fp: str, payload: str) -> str:
    return hashlib.sha1((prev_fp + payload).encode()).hexdigest()[:16]


def events_fingerprint(prev_fp: str, events: Sequence[Event]) -> str:
    """Chained, permutation-invariant fingerprint: hash of the previous
    fingerprint plus the epoch's events in canonical sorted order.  Two logs
    share an epoch fingerprint iff they share base content and (as sets) the
    same event history — O(delta) per epoch, never O(graph)."""
    h = hashlib.sha1(prev_fp.encode())
    for ev in sorted(events):
        h.update(repr((ev.kind, ev.key, ev.data)).encode())
    return h.hexdigest()[:16]


class EventLog:
    """Append-only temporal event log with sealed-epoch boundaries.

    The log carries the fixed schema every materialization shares (type
    counts, the global ``lifespan`` that bucket edges derive from, ``meta``
    passed through to graphs).  ``append``/``extend`` add events to the
    *open* suffix; ``seal()`` freezes that suffix as the next epoch.  Sealed
    events are immutable — epoch-pinned queries (serving/epochs.py) rely on
    that for snapshot isolation.

    With ``validate=True`` (default) appends check referential integrity
    incrementally: known endpoint keys, no duplicate adds, edge lifespans
    within both endpoints' current lifespans, and vertex closes never
    truncating below a live incident edge (the engine's graph-level
    invariant).  Validation is the only order-sensitive part of ingestion;
    disable it to ingest streams whose within-epoch order is arbitrary.

    Durability (``attach_wal`` / ``from_wal``): an append-only JSONL
    write-ahead log mirrors every event, seal, and manager note.  Records
    carry a chained fingerprint (``sha1(prev_fp + canonical payload)``),
    seal records are flushed + fsync'd (the atomic commit point — an epoch
    either has its seal on disk or it does not), and recovery truncates the
    first torn or chain-breaking record and everything after it.  Events
    after the last intact seal are replayed as the open suffix, exactly the
    pre-crash unsealed state.
    """

    def __init__(self, n_vertex_types: int, n_edge_types: int,
                 lifespan: Tuple[int, int], meta: Optional[dict] = None,
                 validate: bool = True):
        self.n_vertex_types = int(n_vertex_types)
        self.n_edge_types = int(n_edge_types)
        self.lifespan = (int(lifespan[0]), int(lifespan[1]))
        self.meta = dict(meta or {})
        self.validate = validate
        self._events: List[Event] = []
        self._seals: List[int] = []          # event-count boundary per epoch
        # validation state (only maintained when validate=True)
        self._v: Dict[int, list] = {}   # key -> [vtype, l0, l1, max_inc_end]
        self._e: Dict[int, list] = {}   # key -> [skey, dkey, l0, l1]
        # write-ahead log (attach_wal / from_wal); clones never share it
        self._wal = None
        self._wal_fp = WAL_GENESIS
        self._wal_path: Optional[str] = None
        self._wal_plan = None           # FaultPlan consulted at "wal" point

    # ------------------------------------------------------------- append
    def _check(self, ev: Event) -> None:
        k = ev.kind
        if k == EV_ADD_VERTEX:
            if ev.key in self._v:
                raise ValueError(f"duplicate vertex key {ev.key}")
            vt, l0, l1 = ev.data
            if not (0 <= vt < self.n_vertex_types):
                raise ValueError(f"vertex type {vt} out of range")
            if l0 >= l1:
                raise ValueError(f"empty vertex lifespan ({l0}, {l1})")
            self._v[ev.key] = [vt, l0, l1, l0]
        elif k == EV_ADD_EDGE:
            if ev.key in self._e:
                raise ValueError(f"duplicate edge key {ev.key}")
            sk, dk, et, l0, l1 = ev.data
            if not (0 <= et < self.n_edge_types):
                raise ValueError(f"edge type {et} out of range")
            if l0 >= l1:
                raise ValueError(f"empty edge lifespan ({l0}, {l1})")
            for ep in (sk, dk):
                v = self._v.get(ep)
                if v is None:
                    raise ValueError(f"edge {ev.key} references unknown vertex {ep}")
                if l0 < v[1] or l1 > v[2]:
                    raise ValueError(
                        f"edge {ev.key} lifespan ({l0}, {l1}) outside vertex "
                        f"{ep} lifespan ({v[1]}, {v[2]})")
                v[3] = max(v[3], l1)
            self._e[ev.key] = [sk, dk, l0, l1]
        elif k in (EV_SET_VPROP, EV_SET_EPROP):
            tab = self._v if k == EV_SET_VPROP else self._e
            if ev.key not in tab:
                raise ValueError(f"property on unknown entity key {ev.key}")
            if ev.data[2] >= ev.data[3]:
                raise ValueError(f"empty property lifespan {ev.data[2:]}")
        elif k == EV_CLOSE_VERTEX:
            v = self._v.get(ev.key)
            if v is None:
                raise ValueError(f"close of unknown vertex {ev.key}")
            (t,) = ev.data
            if t <= v[1]:
                raise ValueError(f"vertex close at {t} not after start {v[1]}")
            if t < v[3]:
                raise ValueError(
                    f"vertex close at {t} truncates a live incident edge "
                    f"(ends {v[3]})")
            v[2] = min(v[2], t)
        elif k == EV_CLOSE_EDGE:
            e = self._e.get(ev.key)
            if e is None:
                raise ValueError(f"close of unknown edge {ev.key}")
            (t,) = ev.data
            if t <= e[2]:
                raise ValueError(f"edge close at {t} not after start {e[2]}")
            e[3] = min(e[3], t)
        else:
            raise ValueError(f"unknown event kind {k}")

    def append(self, ev: Event) -> None:
        if self.validate:
            self._check(ev)
        self._events.append(ev)
        if self._wal is not None:
            self._wal_write(dict(k="ev", kind=int(ev.kind), key=int(ev.key),
                                 data=[int(x) for x in ev.data]))

    def extend(self, events: Iterable[Event]) -> int:
        n = 0
        for ev in events:
            self.append(ev)
            n += 1
        return n

    # -------------------------------------------------------------- epochs
    def seal(self) -> List[Event]:
        """Freeze the open suffix as the next epoch; returns its events
        (possibly empty — an empty epoch is a valid no-op snapshot)."""
        self._seals.append(len(self._events))
        i = len(self._seals) - 1
        events = self.epoch_events(i)
        if self._wal is not None:
            # the atomic commit point: flushed + fsync'd, so a crash either
            # leaves the epoch sealed on disk or recovery reopens its events
            self._wal_write(dict(k="seal", epoch=i, n=len(events)),
                            sync=True)
        return events

    @property
    def n_epochs(self) -> int:
        return len(self._seals)

    @property
    def n_open(self) -> int:
        """Events appended but not yet sealed into an epoch."""
        start = self._seals[-1] if self._seals else 0
        return len(self._events) - start

    def epoch_events(self, i: int) -> List[Event]:
        lo = self._seals[i - 1] if i > 0 else 0
        return self._events[lo:self._seals[i]]

    def __len__(self) -> int:
        return len(self._events)

    def clone(self) -> "EventLog":
        """Independent copy (events, seals, validation state) — replay the
        same stream through several managers without sharing seal state."""
        out = EventLog(self.n_vertex_types, self.n_edge_types, self.lifespan,
                       meta=self.meta, validate=self.validate)
        out._events = list(self._events)
        out._seals = list(self._seals)
        out._v = {k: list(v) for k, v in self._v.items()}
        out._e = {k: list(v) for k, v in self._e.items()}
        return out

    # ---------------------------------------------------------------- WAL
    def _wal_write(self, obj: dict, consult: bool = True,
                   sync: bool = False) -> None:
        """Append one chained record; the "wal" fault point tears the write
        (a prefix reaches disk, then the simulated crash) when it fires."""
        if self._wal is None:
            return
        payload = _wal_payload(obj)
        fp = _wal_chain(self._wal_fp, payload)
        line = _wal_payload({**obj, "fp": fp}) + "\n"
        if (consult and self._wal_plan is not None
                and self._wal_plan.should_fail("wal")):
            self._wal.write(line[: max(1, len(line) // 2)])
            self._wal.flush()
            os.fsync(self._wal.fileno())
            self._wal.close()
            self._wal = None
            from ..serving.faults import TornWriteError
            raise TornWriteError(f"torn WAL write at {self._wal_path}")
        self._wal.write(line)
        self._wal_fp = fp
        if sync:
            self._wal.flush()
            os.fsync(self._wal.fileno())

    def attach_wal(self, path, fault_plan=None) -> None:
        """Start journaling to ``path`` (truncates any existing file): one
        header record, the log's existing history (events interleaved with
        their seal records), then every future ``append``/``seal``/
        ``wal_note`` live.  ``fault_plan``'s "wal" point is consulted for
        live writes only — never while dumping history."""
        self._wal_path = str(path)
        self._wal = open(path, "w", encoding="utf-8")
        self._wal_fp = WAL_GENESIS
        self._wal_plan = None
        self._wal_write(dict(k="hdr", nvt=self.n_vertex_types,
                             net=self.n_edge_types,
                             life=[int(x) for x in self.lifespan],
                             meta=_json_safe_meta(self.meta),
                             validate=bool(self.validate)))
        lo = 0
        for s, hi in enumerate(self._seals):
            for ev in self._events[lo:hi]:
                self._wal_write(dict(k="ev", kind=int(ev.kind),
                                     key=int(ev.key),
                                     data=[int(x) for x in ev.data]))
            self._wal_write(dict(k="seal", epoch=s, n=hi - lo))
            lo = hi
        for ev in self._events[lo:]:
            self._wal_write(dict(k="ev", kind=int(ev.kind), key=int(ev.key),
                                 data=[int(x) for x in ev.data]))
        self._wal.flush()
        os.fsync(self._wal.fileno())
        self._wal_plan = fault_plan

    def wal_note(self, epoch: int, **fields) -> None:
        """Durable side-channel record (fsync'd) — the EpochManager journals
        its per-seal compaction decision here so recovery replays even
        forced decisions exactly."""
        self._wal_write(dict(k="note", epoch=int(epoch), **fields),
                        sync=True)

    def close_wal(self) -> None:
        if self._wal is not None:
            self._wal.flush()
            os.fsync(self._wal.fileno())
            self._wal.close()
            self._wal = None

    @classmethod
    def from_wal(cls, path, fault_plan=None) -> Tuple["EventLog", List[dict]]:
        """Rebuild a log from its WAL — the crash-recovery path.

        Scans records validating the chained fingerprint; the first torn
        line (no newline / invalid JSON) or chain break marks the torn
        tail, which is truncated from the file.  Sealed epochs are restored
        as sealed; intact events after the last seal become the open
        suffix, exactly the pre-crash unsealed state.  Returns
        ``(log, notes)`` with the WAL re-attached in append mode (the
        surviving chain continues), ``notes`` the intact ``wal_note``
        records in order."""
        with open(path, "rb") as f:
            data = f.read()
        fp = WAL_GENESIS
        records: List[dict] = []
        pos = good = 0
        while pos < len(data):
            nl = data.find(b"\n", pos)
            if nl < 0:
                break                      # torn: line never finished
            try:
                obj = json.loads(data[pos:nl].decode("utf-8"))
                rec_fp = obj.pop("fp")
            except Exception:
                break                      # torn: unparseable record
            if rec_fp != _wal_chain(fp, _wal_payload(obj)):
                break                      # chain break: corrupt tail
            records.append(obj)
            fp = rec_fp
            pos = good = nl + 1
        if good < len(data):
            with open(path, "r+b") as f:
                f.truncate(good)
        if not records or records[0].get("k") != "hdr":
            raise ValueError(f"WAL {path} has no intact header record")
        hdr = records[0]
        log = cls(hdr["nvt"], hdr["net"],
                  (int(hdr["life"][0]), int(hdr["life"][1])),
                  meta=hdr["meta"], validate=bool(hdr["validate"]))
        notes: List[dict] = []
        for obj in records[1:]:
            kind = obj["k"]
            if kind == "ev":
                log.append(Event(int(obj["kind"]), int(obj["key"]),
                                 tuple(int(x) for x in obj["data"])))
            elif kind == "seal":
                log._seals.append(len(log._events))
            elif kind == "note":
                notes.append(obj)
        log._wal_path = str(path)
        log._wal = open(path, "a", encoding="utf-8")
        log._wal_fp = fp
        log._wal_plan = fault_plan
        return log, notes


# ------------------------------------------------------- canonical tables
class KeyIndex:
    """External integer keys → dense ids (the position of each key in
    ``keys``), looked up a column at a time by a search over the sorted
    keys.  The replay's stand-in for a ``{key: id}`` dict: the same answers,
    no per-key Python work on a graph of millions of entities."""

    def __init__(self, keys: np.ndarray):
        self.keys = np.asarray(keys, np.int64).reshape(-1)
        self._order = np.argsort(self.keys, kind="stable")
        self._sorted = self.keys[self._order]

    def __len__(self) -> int:
        return int(self.keys.shape[0])

    def _pos(self, keys: np.ndarray):
        keys = np.asarray(keys, np.int64).reshape(-1)
        if not len(self):
            return keys, np.zeros(keys.shape, np.int64), np.zeros(keys.shape, bool)
        pos = np.minimum(np.searchsorted(self._sorted, keys), len(self) - 1)
        return keys, pos, self._sorted[pos] == keys

    def contains(self, keys: np.ndarray) -> np.ndarray:
        return self._pos(keys)[2]

    def ids(self, keys: np.ndarray) -> np.ndarray:
        """int64 ids of ``keys``; KeyError on the first unknown key."""
        keys, pos, hit = self._pos(keys)
        if not hit.all():
            raise KeyError(int(keys[np.argmin(hit)]))
        return self._order[pos]


#: columns of each event kind's ``data`` tuple
_DATA_WIDTH = {EV_ADD_VERTEX: 3, EV_ADD_EDGE: 5, EV_SET_VPROP: 4,
               EV_SET_EPROP: 4, EV_CLOSE_VERTEX: 1, EV_CLOSE_EDGE: 1}


def event_columns(events: Sequence[Event]) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Split events by kind into columns: ``{kind: (keys int64[n],
    data int64[n, width])}``, each kind's rows in event order."""
    by_kind: Dict[int, list] = {k: [] for k in EVENT_KINDS}
    for ev in events:
        by_kind[ev.kind].append(ev)
    out = {}
    for k, evs in by_kind.items():
        keys = np.fromiter((e.key for e in evs), np.int64, len(evs))
        data = np.array([e.data for e in evs], np.int64).reshape(
            len(evs), _DATA_WIDTH[k])
        out[k] = (keys, data)
    return out


def _prop_rows(keys: np.ndarray, data: np.ndarray, epoch: int) -> Dict[int, np.ndarray]:
    """Property-set events as canonical rows per property key:
    ``{pkey: int64[n, 5]}`` of (epoch, entity key, l0, l1, value), in event
    order."""
    out = {}
    if not len(keys):
        return out
    rows = np.stack([np.full(len(keys), epoch, np.int64), keys, data[:, 2],
                     data[:, 3], data[:, 1]], axis=1)
    pk = data[:, 0]
    for p in np.unique(pk):
        out[int(p)] = rows[pk == p]
    return out


def _append_rows(acc: Dict[int, np.ndarray], new: Dict[int, np.ndarray]) -> None:
    for pk, rows in new.items():
        acc[pk] = rows if pk not in acc else np.concatenate([acc[pk], rows])


def _check_unique(keys: np.ndarray, what: str) -> None:
    if len(keys) > 1:
        s = np.sort(keys)
        dup = np.nonzero(s[1:] == s[:-1])[0]
        if len(dup):
            raise ValueError(f"duplicate {what} key {int(s[dup[0]])}")


def _canonical_tables(log: EventLog, upto: int) -> dict:
    """Entity/prop tables for the first ``upto`` epochs in canonical order.

    Closes are applied after all adds (min over close times), so the result
    depends only on the *set* of events per epoch, never their order."""
    vk, vd, ve, ek, ed, ee = [], [], [], [], [], []
    vrows: Dict[int, np.ndarray] = {}
    erows: Dict[int, np.ndarray] = {}
    cv, ce = [], []
    for ep in range(upto):
        cols = event_columns(log.epoch_events(ep))
        k, d = cols[EV_ADD_VERTEX]
        vk.append(k), vd.append(d), ve.append(np.full(len(k), ep, np.int64))
        k, d = cols[EV_ADD_EDGE]
        ek.append(k), ed.append(d), ee.append(np.full(len(k), ep, np.int64))
        _append_rows(vrows, _prop_rows(*cols[EV_SET_VPROP], ep))
        _append_rows(erows, _prop_rows(*cols[EV_SET_EPROP], ep))
        cv.append(cols[EV_CLOSE_VERTEX])
        ce.append(cols[EV_CLOSE_EDGE])
    v_key = np.concatenate(vk) if vk else np.zeros(0, np.int64)
    v_cols = np.concatenate([np.concatenate(vd).reshape(-1, 3),
                             np.concatenate(ve)[:, None]], axis=1) if vk \
        else np.zeros((0, 4), np.int64)
    e_key = np.concatenate(ek) if ek else np.zeros(0, np.int64)
    e_cols = np.concatenate([np.concatenate(ed).reshape(-1, 5),
                             np.concatenate(ee)[:, None]], axis=1) if ek \
        else np.zeros((0, 6), np.int64)
    _check_unique(v_key, "vertex")
    _check_unique(e_key, "edge")
    for closes, index, cols, col in ((cv, KeyIndex(v_key), v_cols, 2),
                                     (ce, KeyIndex(e_key), e_cols, 4)):
        for keys, d in closes:
            if len(keys):
                np.minimum.at(cols[:, col], index.ids(keys), d[:, 0])
    vo = np.lexsort((v_key, v_cols[:, 3], v_cols[:, 0])) if len(v_key) else \
        np.zeros(0, np.int64)
    eo = np.lexsort((e_key, e_cols[:, 2], e_cols[:, 1], e_cols[:, 0],
                     e_cols[:, 5])) if len(e_key) else np.zeros(0, np.int64)
    return dict(
        v_key=v_key[vo], v_type=v_cols[vo, 0].astype(np.int32),
        v_life=v_cols[vo, 1:3].astype(np.int32),
        v_epoch=v_cols[vo, 3].astype(np.int32),
        e_key=e_key[eo], e_srck=e_cols[eo, 0], e_dstk=e_cols[eo, 1],
        e_type=e_cols[eo, 2].astype(np.int32),
        e_life=e_cols[eo, 3:5].astype(np.int32),
        e_epoch=e_cols[eo, 5].astype(np.int32),
        vrows=vrows, erows=erows,
    )


def _pivot_rows(rows: np.ndarray, index: KeyIndex,
                n_entities: int) -> PropColumn:
    """Canonical PropColumn pivot: rows (epoch, key, l0, l1, value) globally
    sorted by (epoch, l0, l1, value) so each entity's slot order is
    canonical (``make_prop_column`` preserves the given within-entity row
    order)."""
    a = np.asarray(rows, np.int64).reshape(-1, 5)
    order = np.lexsort((a[:, 4], a[:, 3], a[:, 2], a[:, 0]))
    a = a[order]
    return make_prop_column(n_entities, index.ids(a[:, 1]),
                            a[:, 4].astype(np.int32), a[:, 2:4].astype(np.int32))


def _graph_from_tables(log: EventLog, t: dict) -> TemporalGraph:
    gid, eid = KeyIndex(t["v_key"]), KeyIndex(t["e_key"])
    e_src = gid.ids(t["e_srck"]).astype(np.int32)
    e_dst = gid.ids(t["e_dstk"]).astype(np.int32)
    vprops = {pk: _pivot_rows(rows, gid, len(gid))
              for pk, rows in sorted(t["vrows"].items())}
    eprops = {pk: _pivot_rows(rows, eid, len(eid))
              for pk, rows in sorted(t["erows"].items())}
    return TemporalGraph(
        t["v_type"], t["v_life"], e_src, e_dst, t["e_type"], t["e_life"],
        vprops, eprops, log.n_vertex_types, log.n_edge_types, log.lifespan,
        meta=dict(log.meta))


def materialize(log: EventLog, upto: Optional[int] = None) -> TemporalGraph:
    """From-scratch canonical replay of the first ``upto`` sealed epochs.

    This is the *reference* build: plain canonical sorts, traversal arrays
    via the graph's own lexsort.  ``Materializer`` must produce bit-identical
    arrays for every epoch (test-pinned) — a pinned epoch served from the
    incremental path answers exactly like this rebuild."""
    upto = log.n_epochs if upto is None else int(upto)
    return _graph_from_tables(log, _canonical_tables(log, upto))


# ---------------------------------------------------- incremental replay
@dataclasses.dataclass
class DeltaSpec:
    """Padded block for the base-CSR + delta-segment execution path.

    Holds the traversal entries (both directions) of every edge appended
    since the last compaction, padded to a pow-2 ``capacity`` so the delta
    executable's shapes change at most log2 times as the delta grows.
    Padded slots carry an empty lifespan and ``valid=False`` — doubly masked
    out of every predicate.  ``eprop_slots`` mirrors the base graph's
    edge-property schema with all-missing columns (delta-pure edges carry no
    properties by construction), so property clauses evaluate identically
    to the merged graph."""
    n_edges: int
    capacity: int
    arrays: Dict[str, np.ndarray]
    eprop_slots: Dict[int, int]

    def device(self, device) -> dict:
        """torch tensors on ``device`` shaped like an engine ``gdev``
        (``core/engine.prepare_gdev``: int32 index arrays plus their int64
        copies for indexing), cached per device."""
        import torch

        device = torch.device(device)
        cache = self.__dict__.setdefault("_device", {})
        dev = cache.get(str(device))
        if dev is None:
            n = 2 * self.capacity
            dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                   for k, v in self.arrays.items()}
            dev["t_src_l"] = dev["t_src"].long()
            dev["t_dst_l"] = dev["t_dst"].long()
            dev["eprops_t"] = {
                k: (torch.full((n, s), NO_VALUE, dtype=torch.int32, device=device),
                    torch.zeros((n, s, 2), dtype=torch.int32, device=device))
                for k, s in self.eprop_slots.items()
            }
            cache[str(device)] = dev
        return dev


def _pow2(n: int, floor: int = 256) -> int:
    c = floor
    while c < n:
        c *= 2
    return c


class Materializer:
    """Incremental epoch-by-epoch materialization of an EventLog.

    ``apply_next()`` folds the next sealed epoch into the previous epoch's
    graph without re-sorting the world:

      * new vertices insert at the end of their type block — the gid remap
        is monotone, so every sorted structure stays sorted under it;
      * new edges append (edge ids never move) and their 2·d traversal
        entries merge into the arrival-sorted order with two searchsorted
        calls (O(E + d log d), vs the O(E log E) from-scratch lexsort);
      * untouched property columns are reused (or row-extended) by
        reference; touched keys re-pivot from the accumulated canonical
        rows.

    Each epoch yields a NEW immutable TemporalGraph (previous epochs' arrays
    are never mutated — snapshot isolation is structural).  ``compact()``
    re-bases the delta window: the current graph becomes the base every
    later ``DeltaSpec`` is measured against.
    """

    def __init__(self, log: EventLog):
        self.log = log
        self.applied = 0
        self.graph: Optional[TemporalGraph] = None
        self._v_key = np.zeros(0, np.int64)
        self._v_epoch = np.zeros(0, np.int32)
        self._e_key = np.zeros(0, np.int64)
        self._key2gid = KeyIndex(self._v_key)
        self._key2eid = KeyIndex(self._e_key)
        self._vrows: Dict[int, np.ndarray] = {}
        self._erows: Dict[int, np.ndarray] = {}
        # delta window since the last compaction
        self.base_graph: Optional[TemporalGraph] = None
        self.base_n_edges = 0
        self._delta_pure = True
        self._remap_from_base = np.zeros(0, np.int64)

    # ------------------------------------------------------------ helpers
    def _bootstrap(self) -> TemporalGraph:
        t = _canonical_tables(self.log, 1)
        g = _graph_from_tables(self.log, t)
        self._v_key, self._v_epoch = t["v_key"], t["v_epoch"]
        self._e_key = t["e_key"]
        self._key2gid = KeyIndex(self._v_key)
        self._key2eid = KeyIndex(self._e_key)
        self._vrows = dict(t["vrows"])
        self._erows = dict(t["erows"])
        self.graph = g
        self.applied = 1
        self.compact()
        return g

    def vertex_types_of_keys(self, keys: np.ndarray) -> np.ndarray:
        """Vertex types of vertex keys (the reference's
        ``vertex_type_of_key``, a column at a time)."""
        return self.graph.v_type[self._key2gid.ids(keys)]

    def edge_endpoint_types_of_keys(self, keys: np.ndarray) -> np.ndarray:
        """Endpoint vertex types of edge keys, int32[n, 2] (the reference's
        ``edge_endpoint_types``, a column at a time)."""
        e = self._key2eid.ids(keys)
        g = self.graph
        return np.stack([g.v_type[g.e_src[e]], g.v_type[g.e_dst[e]]], axis=1)

    # ----------------------------------------------------------- epochs
    def apply_next(self) -> TemporalGraph:
        """Apply the next sealed epoch; returns that epoch's graph."""
        if self.applied >= self.log.n_epochs:
            raise ValueError("no sealed epoch to apply — call log.seal()")
        if self.graph is None:
            return self._bootstrap()
        p = self.applied
        cols = event_columns(self.log.epoch_events(p))
        g = self.graph
        nk, dv = cols[EV_ADD_VERTEX]
        ek, de = cols[EV_ADD_EDGE]
        cv_k, cv_d = cols[EV_CLOSE_VERTEX]
        ce_k, ce_d = cols[EV_CLOSE_EDGE]
        rows_v = _prop_rows(*cols[EV_SET_VPROP], p)
        rows_e = _prop_rows(*cols[EV_SET_EPROP], p)
        V0, E0 = g.n_vertices, g.n_edges

        # ---- vertices: monotone insert at type-block ends
        remap = None
        v_type, v_life = g.v_type, g.v_life
        v_key, v_epoch = self._v_key, self._v_epoch
        if len(nk):
            nt = dv[:, 0].astype(np.int32)
            nl = dv[:, 1:3].astype(np.int32)
            o = np.lexsort((nk, nt))
            nk, nt, nl = nk[o], nt[o], nl[o]
            known = self._key2gid.contains(nk)
            if known.any():
                raise ValueError(f"duplicate vertex key {int(nk[np.argmax(known)])}")
            per_type = np.bincount(nt, minlength=g.n_vertex_types)
            before = np.concatenate(([0], np.cumsum(per_type)))
            remap = np.arange(V0, dtype=np.int64) + before[g.v_type]
            rank = np.arange(len(nt)) - before[nt]
            new_gids = (g.type_ranges[nt, 1].astype(np.int64)
                        + before[nt] + rank)
            V = V0 + len(nk)
            v_type = np.empty(V, np.int32)
            v_type[remap], v_type[new_gids] = g.v_type, nt
            v_life = np.empty((V, 2), np.int32)
            v_life[remap], v_life[new_gids] = g.v_life, nl
            v_key = np.empty(V, np.int64)
            v_key[remap], v_key[new_gids] = self._v_key, nk
            v_epoch = np.empty(V, np.int32)
            v_epoch[remap], v_epoch[new_gids] = self._v_epoch, p
            self._key2gid = KeyIndex(v_key)
        V = v_type.shape[0]
        if len(cv_k):
            v_life = v_life.copy() if v_life is g.v_life else v_life
            np.minimum.at(v_life[:, 1], self._key2gid.ids(cv_k),
                          cv_d[:, 0].astype(np.int32))

        # ---- edges: append in canonical order, remap endpoints
        if remap is not None:
            e_src = remap[g.e_src].astype(np.int32)
            e_dst = remap[g.e_dst].astype(np.int32)
        else:
            e_src, e_dst = g.e_src, g.e_dst
        e_type, e_life, e_key = g.e_type, g.e_life, self._e_key
        d_src = d_dst = None
        if len(ek):
            o = np.lexsort((ek, de[:, 2], de[:, 1], de[:, 0]))
            ek, de = ek[o], de[o]
            known = self._key2eid.contains(ek)
            if known.any():
                raise ValueError(f"duplicate edge key {int(ek[np.argmax(known)])}")
            d_src = self._key2gid.ids(de[:, 0]).astype(np.int32)
            d_dst = self._key2gid.ids(de[:, 1]).astype(np.int32)
            e_src = np.concatenate([e_src, d_src])
            e_dst = np.concatenate([e_dst, d_dst])
            e_type = np.concatenate([e_type, de[:, 2].astype(np.int32)])
            e_life = np.concatenate([e_life, de[:, 3:5].astype(np.int32)])
            e_key = np.concatenate([e_key, ek])
            self._key2eid = KeyIndex(e_key)
        E = e_src.shape[0]
        if len(ce_k):
            e_life = e_life.copy() if e_life is g.e_life else e_life
            np.minimum.at(e_life[:, 1], self._key2eid.ids(ce_k),
                          ce_d[:, 0].astype(np.int32))

        # ---- properties: copy-on-write columns
        _append_rows(self._vrows, rows_v)
        _append_rows(self._erows, rows_e)
        vprops: Dict[int, PropColumn] = {}
        for pk in sorted(set(g.vprops) | set(rows_v)):
            if pk in rows_v:
                vprops[pk] = _pivot_rows(self._vrows[pk], self._key2gid, V)
            elif remap is not None:
                col = g.vprops[pk]
                vals = np.full((V, col.n_slots), NO_VALUE, np.int32)
                life = np.zeros((V, col.n_slots, 2), np.int32)
                vals[remap], life[remap] = col.vals, col.life
                vprops[pk] = PropColumn(vals, life)
            else:
                vprops[pk] = g.vprops[pk]
        eprops: Dict[int, PropColumn] = {}
        for pk in sorted(set(g.eprops) | set(rows_e)):
            if pk in rows_e:
                eprops[pk] = _pivot_rows(self._erows[pk], self._key2eid, E)
            elif len(ek):
                col = g.eprops[pk]
                d = E - E0
                vals = np.concatenate(
                    [col.vals, np.full((d, col.n_slots), NO_VALUE, np.int32)])
                life = np.concatenate(
                    [col.life, np.zeros((d, col.n_slots, 2), np.int32)])
                eprops[pk] = PropColumn(vals, life)
            else:
                eprops[pk] = g.eprops[pk]

        # ---- traversal: monotone remap + searchsorted merge of new entries
        tr = g.traversal
        tb_eid = tr["t_eid"].astype(np.int64)
        tb_fwd = tr["t_isfwd"].astype(np.int64)
        if remap is not None:
            tb_src = remap[tr["t_src"]]
            tb_dst = remap[tr["t_dst"]]
        else:
            tb_src = tr["t_src"].astype(np.int64)
            tb_dst = tr["t_dst"].astype(np.int64)
        if len(ek):
            d = E - E0
            dd_eid = np.concatenate([np.arange(E0, E), np.arange(E0, E)])
            dd_fwd = np.concatenate([np.ones(d, np.int64),
                                     np.zeros(d, np.int64)])
            dd_src = np.concatenate([d_src, d_dst]).astype(np.int64)
            dd_dst = np.concatenate([d_dst, d_src]).astype(np.int64)
            od = np.lexsort((dd_eid, 1 - dd_fwd, dd_src, dd_dst))
            dd_eid, dd_fwd = dd_eid[od], dd_fwd[od]
            dd_src, dd_dst = dd_src[od], dd_dst[od]

            def enc(dst, src, fwd):
                return (dst * (V + 1) + src) * 2 + (1 - fwd)

            eb, ed = enc(tb_dst, tb_src, tb_fwd), enc(dd_dst, dd_src, dd_fwd)
            # merged positions: equal keys put base entries first (base edge
            # ids < appended ids, matching the from-scratch stable lexsort)
            pos_b = np.arange(len(eb)) + np.searchsorted(ed, eb, side="left")
            pos_d = np.arange(len(ed)) + np.searchsorted(eb, ed, side="right")
            m_eid = np.empty(len(eb) + len(ed), np.int64)
            m_fwd = np.empty_like(m_eid)
            m_eid[pos_b], m_eid[pos_d] = tb_eid, dd_eid
            m_fwd[pos_b], m_fwd[pos_d] = tb_fwd, dd_fwd
        else:
            m_eid, m_fwd = tb_eid, tb_fwd
        t_src = np.where(m_fwd == 1, e_src[m_eid], e_dst[m_eid])
        t_dst = np.where(m_fwd == 1, e_dst[m_eid], e_src[m_eid])
        arr_ptr = np.zeros(V + 1, np.int64)
        np.cumsum(np.bincount(t_dst, minlength=V), out=arr_ptr[1:])
        trav = dict(
            t_src=t_src.astype(np.int32), t_dst=t_dst.astype(np.int32),
            t_life=e_life[m_eid], t_type=e_type[m_eid],
            t_isfwd=m_fwd.astype(np.int32), t_eid=m_eid.astype(np.int32),
            arr_ptr=arr_ptr.astype(np.int32),
        )

        ng = TemporalGraph(v_type, v_life, e_src, e_dst, e_type, e_life,
                           vprops, eprops, g.n_vertex_types, g.n_edge_types,
                           self.log.lifespan, meta=dict(g.meta))
        ng.__dict__["traversal"] = trav   # bypass the cached_property lexsort

        # ---- delta-window bookkeeping
        if remap is not None:
            self._remap_from_base = remap[self._remap_from_base]
        if len(nk) or rows_v or rows_e or len(cv_k):
            self._delta_pure = False
        if len(ce_k) and (self._key2eid.ids(ce_k) < self.base_n_edges).any():
            self._delta_pure = False
        self._v_key, self._v_epoch, self._e_key = v_key, v_epoch, e_key
        self.graph = ng
        self.applied += 1
        return ng

    # ------------------------------------------------------------- delta
    def compact(self) -> None:
        """Re-base the delta window: the current graph becomes the base the
        next DeltaSpec (and the serving caches' base fingerprint) refer to."""
        self.base_graph = self.graph
        self.base_n_edges = self.graph.n_edges
        self._delta_pure = True
        self._remap_from_base = np.arange(self.graph.n_vertices,
                                          dtype=np.int64)

    @property
    def delta_pure(self) -> bool:
        """True while every event since the last compaction is an edge
        append or a close on an appended edge — the delta-executable
        eligibility condition."""
        return self._delta_pure

    def delta_spec(self) -> Optional[DeltaSpec]:
        """Padded delta-segment block since the base, or None when the
        window is impure (or empty): impure windows fall back to the merged
        epoch graph."""
        g, b0 = self.graph, self.base_n_edges
        if not self._delta_pure or g is None:
            return None
        nd = g.n_edges - b0
        if nd == 0:
            return None
        cap = _pow2(nd)
        n = 2 * cap

        def pad(a, fill=0):
            out = np.full((n,) + a.shape[1:], fill, a.dtype)
            out[:2 * nd] = np.concatenate([a, a]) if a.ndim > 0 else a
            return out

        src, dst = g.e_src[b0:], g.e_dst[b0:]
        arrays = dict(
            t_src=np.full(n, 0, np.int32), t_dst=np.full(n, 0, np.int32),
            t_life=np.zeros((n, 2), np.int32),
            t_type=pad(g.e_type[b0:]),
            t_isfwd=np.zeros(n, np.int32),
            valid=np.zeros(n, bool),
        )
        arrays["t_src"][:2 * nd] = np.concatenate([src, dst])
        arrays["t_dst"][:2 * nd] = np.concatenate([dst, src])
        arrays["t_life"][:2 * nd] = np.concatenate([g.e_life[b0:]] * 2)
        arrays["t_isfwd"][:nd] = 1
        arrays["valid"][:2 * nd] = True
        return DeltaSpec(nd, cap, arrays,
                         {k: c.n_slots for k, c in g.eprops.items()})

    def partition_hint(self) -> Optional[Callable]:
        """Partition carry-over for the current epoch graph: a callable
        ``(n_workers, parts_per_type) -> Partitioning | None`` extending the
        base graph's cached partitioning over the delta (partitioner
        ``extend_partitioning``) instead of re-running BFS growth.  Any
        assignment is bit-identical on the partitioned executor; the hint
        only saves repartitioning time."""
        base, g = self.base_graph, self.graph
        if base is None or g is None or g is base:
            return None
        remap = self._remap_from_base.copy()

        def hint(n_workers: int, parts_per_type: int):
            from .partitioner import extend_partitioning
            cache = getattr(base, "_partition_cache", None) or {}
            hit = cache.get((n_workers, parts_per_type))
            if hit is None:
                return None
            return extend_partitioning(hit[0], g, remap)

        return hint


# --------------------------------------------------------- stream helpers
def _events(kind: int, keys: np.ndarray, *cols: np.ndarray) -> List[Event]:
    """Events of one kind from columns: ``Event(kind, keys[i], (cols[0][i],
    cols[1][i], ...))`` with Python ints, as the constructors above build
    them."""
    new = object.__new__   # Event.__init__ of a frozen dataclass is slow

    def make(key, data):
        ev = new(Event)
        ev.__dict__.update(kind=kind, key=key, data=data)
        return ev

    return [make(k, d)
            for k, d in zip(keys.tolist(), zip(*(c.tolist() for c in cols)))]


def _prop_events(kind: int, props: Dict[int, PropColumn],
                 keep: Optional[np.ndarray] = None) -> List[Event]:
    """Property-set events of every populated slot, key by key in sorted
    order and row-major within a column (entity, then slot)."""
    out: List[Event] = []
    for pk, col in sorted(props.items()):
        ent, slot = np.nonzero(col.vals != NO_VALUE)
        if keep is not None:
            ok = keep[ent]
            ent, slot = ent[ok], slot[ok]
        life = col.life[ent, slot]
        out += _events(kind, ent, np.full(len(ent), int(pk), np.int64),
                       col.vals[ent, slot], life[:, 0], life[:, 1])
    return out


def log_from_graph(graph: TemporalGraph, holdout_edges: int = 0,
                   seed: int = 0) -> Tuple[EventLog, List[Event]]:
    """Decompose a built TemporalGraph into an EventLog whose epoch 0
    rebuilds it minus ``holdout_edges`` random edges; the held-out edges are
    returned as pure ADD_EDGE events (properties dropped, which keeps later
    epochs delta-executable) for the caller to ingest in later epochs.

    External keys are the source graph's vertex/edge ids, so epoch-0
    materialization reproduces the vertex order exactly (edges re-sort into
    canonical key order; engine results are unaffected by edge order).
    The events are built a column at a time and equal the reference's, in
    the same order."""
    rng = np.random.default_rng(seed)
    E = graph.n_edges
    held = np.zeros(E, bool)
    if holdout_edges:
        held[rng.choice(E, size=min(holdout_edges, E), replace=False)] = True
    log = EventLog(graph.n_vertex_types, graph.n_edge_types, graph.lifespan,
                   meta=dict(graph.meta))
    log.extend(_events(EV_ADD_VERTEX, np.arange(graph.n_vertices),
                       graph.v_type, graph.v_life[:, 0], graph.v_life[:, 1]))
    log.extend(_prop_events(EV_SET_VPROP, graph.vprops))

    def edges(ids):
        return _events(EV_ADD_EDGE, ids, graph.e_src[ids], graph.e_dst[ids],
                       graph.e_type[ids], graph.e_life[ids, 0],
                       graph.e_life[ids, 1])

    log.extend(edges(np.nonzero(~held)[0]))
    log.extend(_prop_events(EV_SET_EPROP, graph.eprops, keep=~held))
    log.seal()
    return log, edges(np.nonzero(held)[0])
