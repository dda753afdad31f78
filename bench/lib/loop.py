"""The load loops: a mix's queries through the server on the wall clock.

One thread plays the clients and the front end.  Each turn it hands the
server the waiting queries (the oldest first, at most ``max_batch`` of one
template), calls ``flush`` once and takes the answers.  A query's latency runs
from its due time (open loop: its arrival; closed loop: the moment its client
issued it, which is when the client's previous answer returned) to the return
of the flush that answered it.

Open loop: arrivals come at their offsets whatever the server does; while
nothing waits, the loop sleeps until the next one.  After the window no query
arrives, and the loop drains what is left.  Closed loop: ``clients`` clients
each keep one query outstanding and issue the next when the answer returns;
after the window none issues another.

Per flush the loop records its host times and the scheduler's dispatch rows
(``GroupDispatch``); per query its due and done times and status.  A seeded
reservoir per template keeps the served answers that the check will judge.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Judged:
    """A served answer kept for the check."""
    index: int
    query: dict
    count: float                      # the served count (a series' sum)
    total: Optional[np.ndarray]       # the rest only where the server
    per_vertex: Optional[np.ndarray]  # returns them (``keep_outputs``)
    minmax: Optional[np.ndarray]


class Reservoir:
    """A uniform sample of ``k`` served answers per template, from ``rng``."""

    def __init__(self, k: int, rng):
        self.k, self.rng = k, rng
        self.seen: Dict[str, int] = collections.Counter()
        self.kept: Dict[str, List[Judged]] = collections.defaultdict(list)

    def offer(self, index: int, query: dict, result) -> None:
        t = query["template"]
        self.seen[t] += 1
        slot = len(self.kept[t])
        if slot >= self.k:
            slot = int(self.rng.integers(self.seen[t]))
            if slot >= self.k:
                return
        # views into the group's arrays: copying a bucket-mode per-vertex
        # series (88 MB at 1.38 M vertices) would cost host time in the window
        j = Judged(index, query, result.count, result.total, result.per_vertex,
                   result.minmax)
        if slot == len(self.kept[t]):
            self.kept[t].append(j)
        else:
            self.kept[t][slot] = j

    def all(self) -> List[Judged]:
        return [j for t in sorted(self.kept) for j in self.kept[t]]


@dataclasses.dataclass
class Window:
    """What one measured window recorded."""
    t0: float
    seconds: float
    flushes: List[dict] = dataclasses.field(default_factory=list)
    due: Dict[int, float] = dataclasses.field(default_factory=dict)
    done: Dict[int, float] = dataclasses.field(default_factory=dict)
    status: Dict[int, str] = dataclasses.field(default_factory=dict)
    wake_late_s: List[float] = dataclasses.field(default_factory=list)
    t_last: float = 0.0

    @property
    def n_attempted(self) -> int:
        return len(self.due)

    @property
    def n_done(self) -> int:
        return sum(s == "done" for s in self.status.values())

    @property
    def n_failed(self) -> int:
        return self.n_attempted - self.n_done

    def latencies_ms(self) -> np.ndarray:
        return np.asarray([(self.done[i] - self.due[i]) * 1e3
                           for i, s in self.status.items() if s == "done"])

    @property
    def elapsed_s(self) -> float:
        """From the window's start to the last answer."""
        return self.t_last - self.t0


class Profiler:
    """Runs ``torch.profiler`` over the last ``slice_s`` seconds of the
    window, switched on and off between flushes."""

    def __init__(self, slice_s: float, dev):
        self.slice_s = slice_s
        self.dev = dev
        self.prof = None
        self.span: Optional[tuple] = None     # host clock (start, stop)
        self.flushes: Optional[tuple] = None  # (first, end) flush indices
        self._first = 0

    def activities(self) -> list:
        from torch.profiler import ProfilerActivity

        cuda = [ProfilerActivity.CUDA] if self.dev.type == "cuda" else []
        return [ProfilerActivity.CPU] + cuda

    @property
    def active(self) -> bool:
        return self.span is not None and self.span[1] is None

    def maybe_start(self, now: float, t_end: float, clock, n_flushes: int) -> None:
        if self.span is None and now >= t_end - self.slice_s:
            from torch.profiler import profile

            self.prof = profile(activities=self.activities())
            self.prof.__enter__()
            self.span = (clock(), None)
            self._first = n_flushes

    def stop(self, clock, n_flushes: int) -> None:
        if self.active:
            self.span = (self.span[0], clock())
            self.prof.__exit__(None, None, None)
            self.flushes = (self._first, n_flushes)

    def label(self, name: str):
        if not self.active:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)


def _label(prof: Optional[Profiler], name: str):
    return prof.label(name) if prof is not None else contextlib.nullcontext()


def _take(waiting: collections.OrderedDict, stream: List[dict], cap: int) -> List[int]:
    """The waiting queries to hand the server: oldest first, at most ``cap``
    of one template."""
    per: Dict[str, int] = collections.Counter()
    out = []
    for i in waiting:
        t = stream[i % len(stream)]["template"]
        if per[t] < cap:
            per[t] += 1
            out.append(i)
    for i in out:
        del waiting[i]
    return out


def _dispatch_row(d, stream, index_of) -> dict:
    return dict(template=stream[index_of[d.indices[0]] % len(stream)]["template"],
                engine=d.engine, split=d.split, impl=d.impl, n_real=d.n_real,
                n_pad=d.n_pad, service_s=d.service_s, event_ms=d.event_ms,
                predicted_ms=d.predicted_ms, exec_cached=d.exec_cached)


def _serve(server, instances, stream, take, win: Window, judge: Reservoir,
           prof: Optional[Profiler], clock) -> float:
    """Submit ``take``, flush once, record; returns the flush's end time."""
    n = len(stream)
    with _label(prof, "bench.submit"):
        for i in take:
            server.submit(instances[i % n])
    t_start = clock()
    with _label(prof, "bench.flush"):
        results = server.flush()
    t_end = clock()
    disp = server.last_dispatches
    win.flushes.append(dict(start=t_start, end=t_end, n=len(take),
                            dispatches=[_dispatch_row(d, stream, take) for d in disp]))
    for pos, i in enumerate(take):
        r = results[pos]
        win.done[i] = t_end
        win.status[i] = r.status if r is not None else "failed"
        if win.status[i] == "done":
            judge.offer(i, stream[i % n], r)
    del results
    win.t_last = t_end
    return t_end


def run_open(server, instances, stream, offsets: np.ndarray, cap: int,
             seconds: float, judge: Reservoir, prof: Optional[Profiler] = None,
             clock: Callable[[], float] = time.perf_counter,
             sleep: Callable[[float], None] = time.sleep) -> Window:
    """Open loop: query i (``stream[i % len(stream)]``) is due at
    ``t0 + offsets[i]``."""
    win = Window(t0=clock(), seconds=seconds)
    t0 = win.t0
    t_end = t0 + seconds
    waiting: collections.OrderedDict = collections.OrderedDict()
    nxt, n = 0, len(offsets)
    while True:
        now = clock()
        while nxt < n and t0 + offsets[nxt] <= now:
            waiting[nxt] = None
            win.due[nxt] = t0 + offsets[nxt]
            nxt += 1
        if not waiting:
            if nxt >= n:
                break
            target = t0 + offsets[nxt]
            with _label(prof, "bench.wait"):
                while clock() < target:
                    sleep(max(0.0, min(target - clock(), 0.05)))
            win.wake_late_s.append(clock() - target)
            continue
        if prof is not None:
            prof.maybe_start(now, t_end, clock, len(win.flushes))
        _serve(server, instances, stream, _take(waiting, stream, cap), win,
               judge, prof, clock)
        if prof is not None and clock() >= t_end:
            prof.stop(clock, len(win.flushes))
    if prof is not None:
        prof.stop(clock, len(win.flushes))
    return win


def run_closed(server, instances, stream, clients: int, cap: int,
               seconds: float, judge: Reservoir, prof: Optional[Profiler] = None,
               clock: Callable[[], float] = time.perf_counter) -> Window:
    """Closed loop: ``clients`` clients, each with one query outstanding;
    query i is ``stream[i % len(stream)]``."""
    win = Window(t0=clock(), seconds=seconds)
    t_end = win.t0 + seconds
    waiting: collections.OrderedDict = collections.OrderedDict()
    nxt = 0
    for _ in range(clients):
        waiting[nxt] = None
        win.due[nxt] = win.t0
        nxt += 1
    while waiting:
        now = clock()
        if prof is not None:
            prof.maybe_start(now, t_end, clock, len(win.flushes))
        take = _take(waiting, stream, cap)
        t_done = _serve(server, instances, stream, take, win, judge, prof, clock)
        if t_done < t_end:
            for _ in take:          # each answered client issues its next query
                waiting[nxt] = None
                win.due[nxt] = t_done
                nxt += 1
        elif prof is not None:
            prof.stop(clock, len(win.flushes))
    if prof is not None:
        prof.stop(clock, len(win.flushes))
    return win
