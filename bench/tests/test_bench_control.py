"""The check fails what it must: the control (the reference in bfloat16 put
in the server's place) and faults planted in the timed path, each through
the rest of a run on the CPU at a small size (the look for a card skipped)."""
import time

import numpy as np
import pytest
import torch

from bench import control
from bench import harness as H
from bench.lib import spec as SP
from bench.tests.bench_cells import small_cell

from repro_torch.kernels import hop_scatter as HK
from repro_torch.serving import BatchScheduler

CPU = torch.device("cpu")


def _run(cell, persons=40, seconds=2.0, seed=7):
    # the open loop offered fast enough that groups of several queries form
    w = small_cell(cell, persons=persons, rate=200.0)
    return H.run_cell(w, SP.benchmark(), seed, seconds, False, CPU, time.perf_counter())


CELLS = ("fs100k.static.closed64", "zd100k.interval.closed1")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    line = _run(cell)
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["count_rel_err"]["value"] == 0.0


@pytest.mark.parametrize("cell", ["fs100k.static.closed64", "zd100k.bucket.open",
                                  "zd100k.interval.closed1"])
def test_control_fails(cell):
    w = small_cell(cell, persons=50)
    got = control.control_numbers(w, 3, CPU)
    assert got["judged"] > 0
    assert got["count_rel_err"] > w["limits"]["count_rel_err"], got


def _alter_answers(monkeypatch):
    """Every answer off by one where the server produces it."""
    flush = BatchScheduler.flush

    def altered(self, *a, **kw):
        out = flush(self, *a, **kw)
        for r in out:
            if r is not None:
                r.count += 1
                if r.total is not None:
                    r.total = r.total + 1
        return out

    monkeypatch.setattr(BatchScheduler, "flush", altered)


def _half_batch(monkeypatch):
    """Each batched call computes the first half of its queries and answers
    the rest with their mean."""
    from repro_torch.core import engine as E

    build = E.batch_executable

    def halved(*a, **kw):
        run = build(*a, **kw)

        def run_half(params):
            params = np.asarray(params)
            k = max(1, params.shape[0] // 2)
            out = run(params[:k])
            fill = lambda x: None if x is None else torch.cat(  # noqa: E731
                [x, x.mean(dim=0, keepdim=True).expand((params.shape[0] - k,) + x.shape[1:])])
            return E.ExecOutput(fill(out.total), fill(out.per_vertex), fill(out.minmax),
                                out.stats)
        return run_half

    monkeypatch.setattr(E, "batch_executable", halved)


def _hop_unchanged(monkeypatch):
    """Every fused hop hands on its source state (and extremum channel)
    instead of delivering it along the edges."""
    def carry(x, V, fill):
        if x is None:
            return None
        out = torch.full((x.shape[0], V) + tuple(x.shape[2:]), fill, dtype=x.dtype)
        k = min(V, x.shape[1])
        out[:, :k] = x[:, :k]
        return out

    def cols(state, src, w, ptr, mch=None, neutral=0.0, op_is_min=True):
        V = ptr.shape[0] - 1
        return carry(state, V, 0.0), carry(mch, V, neutral)

    def interval(state, src, w, sb, eb, ptr, mch=None, neutral=0.0, op_is_min=True):
        V = ptr.shape[0] - 1
        return carry(state, V, 0.0), carry(mch, V, neutral)

    monkeypatch.setattr(HK, "fused_hop_cols", cols)
    monkeypatch.setattr(HK, "fused_hop_interval", interval)


def _permute_buckets(monkeypatch):
    """Each answer's per-bucket series (its total and an aggregate's
    per-first-vertex counts) with its buckets rolled by one: every count in
    the wrong bucket, the sums unchanged."""
    flush = BatchScheduler.flush

    def rolled(self, *a, **kw):
        out = flush(self, *a, **kw)
        for r in out:
            if r is not None and r.total is not None and np.ndim(r.total):
                r.total = np.roll(np.asarray(r.total), 1, axis=-1)
                if r.per_vertex is not None:
                    r.per_vertex = np.roll(np.asarray(r.per_vertex), 1, axis=-1)
        return out

    monkeypatch.setattr(BatchScheduler, "flush", rolled)


def test_bucket_series_are_judged(monkeypatch):
    """The bucket cell (its files kept for a later benchmark) judges every
    answer's 16-bucket series: exact in a sound run, failed with the buckets
    rolled.  (Its sound runs read MIN/MAX mismatches: the program's bucket
    MIN/MAX admits paths valid in no bucket, so the cell is not in
    BENCHMARK.json.)"""
    cell = "zd100k.bucket.open"
    limit = small_cell(cell)["limits"]["count_rel_err"]
    assert _run(cell)["checks"]["count_rel_err"]["value"] == 0.0
    _permute_buckets(monkeypatch)
    assert _run(cell)["checks"]["count_rel_err"]["value"] > limit


FAULTS = [(cell, fault) for cell in CELLS
          for fault in (_alter_answers, _half_batch, _hop_unchanged)
          # one query a call: the interval cell has no batch to halve
          if not (fault is _half_batch and cell == "zd100k.interval.closed1")]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, f in FAULTS])
def test_fault_fails(cell, fault, monkeypatch):
    fault(monkeypatch)
    line = _run(cell)
    assert line["correct"] is False, line["checks"]
