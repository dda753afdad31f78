"""Drive the PyTorch/CUDA port's main path on one NVIDIA H100 and check it.

    python3 chip_smoke.py [--report PATH]

Phases (each prints its lines; any failure raises and the exit code is 1):

  1. device    the card's name and power limit (nvidia-smi) and its compute
               capability, which must be (9, 0)
  2. build     compile the kernels from src/repro_torch/csrc/ with nvcc
  3. oracle    on a small LDBC graph, the port on the card (impl='cuda')
               against the port's pure-Python oracle (core/ref_engine.py):
               Q1-Q8 and the MIN/MAX shapes in static mode, exact
  4. main      the main path at full width: an LDBC graph of PERSONS
               persons (100,000; zipf degrees, dynamic properties,
               16 time buckets), the Q1-Q8 workload through
               ``execute_batch_out`` in static, bucket (8 queries a batch)
               and interval mode (1 query), each at the default split and at
               n_vertices // 2, plus the MIN/MAX shapes on the dense
               executor.  Every impl='cuda' answer is held against
               impl='torch' on the card.  The launch counters are set to 0
               just before and read just after; every kernel of the path
               (B1, B2, B3) must have launched.  Peak memory is read per
               timed call, beside the memory resident just before it.
  5. profile   one traced run (torch.profiler) of Q4, Q8 and agg-min-2hop
               in each mode: device busy share and the top kernels
  6. kernels   each kernel's wrapper against its plain PyTorch version on the
               inputs the main path gave it (the largest call of each
               variant, captured by re-running the job that made it), timed with CUDA events beside its bound and the
               PyTorch library call that computes the same function, where
               one exists.  B4, which no engine path reaches, is held on a
               main-path ETR delivery's edges.

Exactness: counts are integers in float32, so a kernel equals its plain
version bit for bit while magnitudes stay below 2^24; entries at or above
2^24 (where a float32 sum depends on its order) are held to rtol 1e-6 and
counted.  The last lines are the kernels' JSON line, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.  Details go to
``--report`` (default ``build/chip_smoke.json``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (data sheet)
F32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
EXACT = float(2 ** 24)
PERSONS = 100_000             # full size; a cut changes this and is listed in PERF.md
SEED = 1
N_BATCH = 8                   # queries per static / bucket batch
SOURCE = "src/repro_torch/csrc/hop_scatter.cu"
REPLACES = {
    "fused_hop_cols": "src/repro/kernels/hop_scatter/hop_scatter.py:198",
    "fused_hop_interval": "src/repro/kernels/hop_scatter/hop_scatter.py:243",
    "scatter_cols": "src/repro/kernels/hop_scatter/hop_scatter.py:293",
    "scatter_extremum": "src/repro/kernels/hop_scatter/hop_scatter.py:314",
}
REPORT: dict = {}


def log(*a):
    print(*a, flush=True)


# =========================================================================
# comparison and timing
# =========================================================================
def compare(got: torch.Tensor, want: torch.Tensor, what: str) -> dict:
    """Bit-equal below 2^24, rtol 1e-6 at or above; returns the error stats."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    g, w = got.double(), want.double()
    same = (g == w) | (torch.isnan(g) & torch.isnan(w))
    big = torch.isfinite(w) & (w.abs() >= EXACT)
    close = (g - w).abs() <= 1e-6 * w.abs()
    bad = ~same & (~big | ~close)
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        raise AssertionError(f"{what}: {int(bad.sum())} entries differ "
                             f"(first: got {g.flatten()[i].item()} want {w.flatten()[i].item()})")
    diff = torch.where(same, torch.zeros_like(g), (g - w).abs())
    return dict(max_abs_err=float(diff.max()) if diff.numel() else 0.0,
                n_ge_2_24=int(big.sum()))


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median of ``iters`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(nbytes: float, flops: float) -> tuple:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / F32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# =========================================================================
# phases
# =========================================================================
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    log(f"device: {smi}; capability {cap}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: the kernels target sm_90a, card is {cap}")
    REPORT["device"] = dict(nvidia_smi=smi, capability=list(cap),
                            torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def phase_build() -> None:
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    path, nvcc_s, _ = build.compile_source("hop_scatter")
    build.load("hop_scatter")
    dt = time.perf_counter() - t0
    log(f"build: {path.name} nvcc {nvcc_s:.1f}s, build+load {dt:.1f}s")
    REPORT["build"] = dict(library=path.name, nvcc_s=nvcc_s, total_s=dt)


def minmax_shapes(graph):
    """The conformance matrix's ETR-free MIN/MAX shapes (tests/conformance.py
    agg-min, agg-max, agg-min-2hop), in the port's AST."""
    from repro_torch.core import query as Q

    b = graph.meta["builder"]
    vt, et, k = b.v_type_ids, b.e_type_ids, b.key_ids
    person, post = vt["person"], vt["post"]
    created, follows = et["created"], et["follows"]
    vp = lambda t: Q.VertexPredicate(t, ())
    out = {}
    for op, tag in ((Q.AGG_MIN, "min"), (Q.AGG_MAX, "max")):
        out[f"agg-{tag}"] = Q.PathQuery(
            (vp(person), vp(post)), (Q.EdgePredicate(created, Q.DIR_OUT),),
            agg_op=op, agg_key=k["length"])
    out["agg-min-2hop"] = Q.PathQuery(
        (vp(person), vp(person), vp(post)),
        (Q.EdgePredicate(follows, Q.DIR_OUT), Q.EdgePredicate(created, Q.DIR_OUT)),
        agg_op=Q.AGG_MIN, agg_key=k["length"])
    return out


def phase_oracle() -> None:
    """The port on the card against its pure-Python oracle, on a small graph."""
    from repro_torch.core import engine as E
    from repro_torch.core.ref_engine import RefEngine
    from repro_torch.graphdata.ldbc import LdbcParams, generate_ldbc
    from repro_torch.graphdata.queries import make_workload

    g = generate_ldbc(LdbcParams(n_persons=200, seed=9, dynamic=True))
    oracle = RefEngine(g)
    n_nonzero = 0
    for inst in make_workload(g, n_per_template=1, seed=3):
        want = oracle.count(inst.qry, mode=E.MODE_STATIC)
        got = float(E.execute(g, inst.qry, mode=E.MODE_STATIC, impl="cuda").total)
        if got != want:
            raise AssertionError(f"oracle {inst.template}: engine {got} != oracle {want}")
        n_nonzero += want > 0
    for name, q in minmax_shapes(g).items():
        want = oracle.aggregate(q, mode=E.MODE_STATIC)
        out = E.execute(g, q, mode=E.MODE_STATIC, impl="cuda")
        pv, mm = out.per_vertex.cpu().numpy(), out.minmax.cpu().numpy()
        got = {int(i): float(mm[i]) for i in np.nonzero(pv)[0]}
        if got != want:
            raise AssertionError(f"oracle {name}: min/max aggregates differ")
    log(f"oracle: Q1-Q8 static counts and 3 MIN/MAX aggregates equal the "
        f"oracle on 200 persons ({n_nonzero} templates with matches)")
    REPORT["oracle"] = dict(persons=200, templates_with_matches=int(n_nonzero))


class Recorder:
    """Finds the largest main-path call of every kernel variant, then
    captures its inputs for the kernels phase.

    While the main path runs, the wrapped wrappers keep only each variant's
    (size, job index) and no tensor, so the main path's memory is its own.
    ``capture`` then re-runs each chosen job once and keeps the inputs of
    that call.  Launches are still counted inside the wrappers only."""

    def __init__(self, HK):
        self.HK = HK
        self.job = None          # index of the job being run
        self.best = {}           # variant key -> (size, job index)
        self.inputs = {}         # variant key -> (wrapper name, args, kwargs)
        self.capturing = False
        self.orig = {}

    def _wrap(self, name, key_fn, size_fn):
        orig = getattr(self.HK, name)
        self.orig[name] = orig

        def wrapped(*a, **kw):
            key, size = key_fn(*a, **kw), size_fn(*a, **kw)
            if self.capturing:
                if self.best.get(key) == (size, self.job) and key not in self.inputs:
                    self.inputs[key] = (name, a, kw)
            elif key not in self.best or size > self.best[key][0]:
                self.best[key] = (size, self.job)
            return orig(*a, **kw)

        setattr(self.HK, name, wrapped)

    def __enter__(self):
        self._wrap("fused_hop_cols",
                   lambda state, src, w, ptr, mch=None, **kw:
                   ("fused_hop_cols", state.shape[-1], mch is not None),
                   lambda state, src, w, ptr, **kw: src.numel() * w.shape[0] * w.shape[2])
        self._wrap("fused_hop_interval",
                   lambda state, src, w, sb, eb, ptr, mch=None, **kw:
                   ("fused_hop_interval", state.shape[-2], mch is not None),
                   lambda state, src, w, *a, **kw: src.numel() * w.shape[0])
        self._wrap("scatter_cols",
                   lambda contrib, ptr: ("scatter_cols", contrib[0, 0].numel(), False),
                   lambda contrib, ptr: contrib.numel())
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.HK, name, fn)

    def capture(self, run) -> None:
        """``run(j)`` re-runs job j; keeps each variant's largest call's inputs."""
        self.capturing = True
        with self:
            for j in sorted({j for _, j in self.best.values()}):
                self.job = j
                run(j)
        self.capturing = False
        missing = set(self.best) - set(self.inputs)
        if missing:
            raise AssertionError(f"re-run did not repeat the calls of {sorted(missing, key=str)}")


def run_job(graph, job, impl: str = "cuda"):
    """One main-path job (name, mode, split, batch) through execute_batch_out."""
    from repro_torch.core import engine as E

    _, mode, split, batch = job
    return E.execute_batch_out(graph, batch, impl=impl, split=split, mode=mode,
                               n_buckets=16, device="cuda")


def phase_main(recorder: Recorder):
    """Returns (report dict, graph, the jobs run: (name, mode, split, batch))."""
    from repro_torch.core import engine as E
    from repro_torch.core import engine_sliced as ES
    from repro_torch.graphdata.ldbc import LdbcParams, generate_ldbc
    from repro_torch.graphdata.queries import TEMPLATES, make_workload
    from repro_torch.kernels import hop_scatter as HK

    t0 = time.perf_counter()
    g = generate_ldbc(LdbcParams(n_persons=PERSONS, dynamic=True, degree_dist="zipf",
                                 align=16, seed=SEED))
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    g.traversal, g.etr_tables  # noqa: B018 — host CSR and ETR rank tables
    t_tables = time.perf_counter() - t0
    t0 = time.perf_counter()
    E.prepare_gdev(g, "cuda")
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t0
    info = dict(persons=PERSONS, seed=SEED, n_vertices=g.n_vertices, n_edges=g.n_edges,
                n_traversal_edges=2 * g.n_edges, generate_s=t_gen, tables_s=t_tables,
                upload_s=t_upload)
    log(f"main: graph {PERSONS} persons: {g.n_vertices} vertices, {g.n_edges} edges, "
        f"{2 * g.n_edges} traversal edges; generate {t_gen:.1f}s, tables "
        f"{t_tables:.1f}s, upload {t_upload:.1f}s")

    wl = make_workload(g, n_per_template=N_BATCH, seed=SEED)
    by_t = {t: [i.qry for i in wl if i.template == t] for t in TEMPLATES}
    jobs = []
    for t, qs in by_t.items():
        n = qs[0].n_vertices
        for mode in (E.MODE_STATIC, E.MODE_BUCKET, E.MODE_INTERVAL):
            batch = qs if mode != E.MODE_INTERVAL else qs[:1]
            for split in sorted({n - 1, n // 2}):
                jobs.append((t, mode, split, batch))
    for name, q in minmax_shapes(g).items():
        for mode in (E.MODE_STATIC, E.MODE_BUCKET, E.MODE_INTERVAL):
            jobs.append((name, mode, 0, [q] * (N_BATCH if mode != E.MODE_INTERVAL else 1)))

    rows = []
    HK.reset_launches()           # counts are 0 just before the main path
    with recorder:
        for j, job in enumerate(jobs):
            t, mode, split, batch = job
            recorder.job = j
            run_job(g, job)  # warm-up; its output is dropped at once
            before = dict(HK.LAUNCHES)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            ev0.record()
            out = run_job(g, job)
            ev1.record()
            torch.cuda.synchronize()
            cuda_ms = ev0.elapsed_time(ev1)
            host_ms = (time.perf_counter() - h0) * 1e3
            peak = torch.cuda.max_memory_allocated()
            launches = {k: HK.LAUNCHES[k] - before[k] for k in HK.LAUNCHES}
            ref = run_job(g, job, impl="torch")
            torch.cuda.synchronize()
            errs = {}
            for field in ("total", "per_vertex", "minmax"):
                a, b = getattr(out, field), getattr(ref, field)
                if a is None and b is None:
                    continue
                if a is None or b is None:
                    raise AssertionError(f"{t} mode {mode}: {field} missing on one impl")
                if not bool(torch.isfinite(a).all()) and field != "minmax":
                    raise AssertionError(f"{t} mode {mode}: non-finite {field}")
                errs[field] = compare(a, b, f"main {t} mode {mode} split {split} {field}")
            expect = (len(batch), 16) if mode == E.MODE_BUCKET else (len(batch),)
            if tuple(out.total.shape) != expect:
                raise AssertionError(f"{t}: total shape {tuple(out.total.shape)} != {expect}")
            engine = "sliced" if ES.sliceable(batch[0]) else "dense"
            row = dict(template=t, mode=["static", "bucket", "interval"][mode], split=split,
                       n_vertices=batch[0].n_vertices, batch=len(batch), engine=engine,
                       cuda_ms=cuda_ms, host_ms=host_ms, peak_bytes=peak,
                       resident_bytes=base, query_peak_bytes=peak - base,
                       launches=launches, errors=errs,
                       total_sum=float(out.total.double().sum()))
            del out, ref
            rows.append(row)
            log(f"main: {t:13s} {row['mode']:8s} split={split} Q={len(batch)} {engine:6s} "
                f"cuda_ms={cuda_ms:.3f} peak_GiB={peak / 2**30:.3f} "
                f"resident_GiB={base / 2**30:.3f} launches={launches} "
                f"total={row['total_sum']:.6g} "
                f"n>=2^24={sum(e['n_ge_2_24'] for e in errs.values())}")
    launches = dict(HK.LAUNCHES)  # read just after the main path
    info["launches"] = launches
    info["rows"] = rows
    log(f"main: launches over the main path: {launches}")
    missing = [k for k in ("fused_hop_cols", "fused_hop_interval", "scatter_cols")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")
    return info, g, jobs


PROFILED = ("Q4", "Q8", "agg-min-2hop")


def phase_profile(graph, jobs, top: int = 6) -> list:
    """Where a query's device time goes: one traced run of each PROFILED
    template in each mode (its first plan of the main path), with the idle
    share (1 - summed kernel time / traced wall time) and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = []
    seen = set()
    for job in jobs:
        name, mode, split, batch = job
        if name not in PROFILED or (name, mode) in seen:
            continue
        seen.add((name, mode))
        run_job(graph, job)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_job(graph, job)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # kernels only: the aten ops that launched them carry the same time
        rows = [(ev.self_device_time_total / 1e3, ev.key, ev.count)
                for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows)
        rec = dict(template=name, mode=["static", "bucket", "interval"][mode],
                   split=split, batch=len(batch), wall_ms=wall_ms, device_busy_ms=busy_ms,
                   idle_share=1.0 - busy_ms / wall_ms,
                   top=[dict(kernel=k[:90], ms=ms, calls=c) for ms, k, c in rows[:top]])
        out.append(rec)
        log(f"profile: {name} {rec['mode']} split={split} Q={len(batch)} wall_ms={wall_ms:.3f} "
            f"device_busy_ms={busy_ms:.3f} idle_share={rec['idle_share']:.3f}")
        for t in rec["top"]:
            log(f"profile:    {t['ms']:10.3f} ms  x{t['calls']:<4d} {t['kernel']}")
    return out


def _unique_rows(src: torch.Tensor, n_rows: int) -> int:
    u = torch.unique(src)
    return int((u < n_rows).sum())


def phase_kernels(recorder: Recorder, launches: dict) -> list:
    from repro_torch.kernels import hop_scatter as HK

    entries = []

    def entry(name, variant, kern, plain, library, nbytes, flops):
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        err = {"max_abs_err": 0.0, "n_ge_2_24": 0}
        for a, b, f in zip(got, want, ("out", "mch")):
            if a is None and b is None:
                continue
            e = compare(a, b, f"kernel {name}[{variant}] {f}")
            err["max_abs_err"] = max(err["max_abs_err"], e["max_abs_err"])
            err["n_ge_2_24"] += e["n_ge_2_24"]
        del got, want
        ms = time_ms(kern)
        plain_ms = time_ms(plain)
        library_ms = time_ms(library) if library is not None else None
        b_ms, b_by = bound(nbytes, flops)
        e = dict(name=f"{name}[{variant}]", route="cuda", source=SOURCE,
                 replaces=REPLACES[name], launches=launches[name],
                 max_abs_err=err["max_abs_err"], ms=ms, plain_ms=plain_ms,
                 bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                 n_ge_2_24=err["n_ge_2_24"], bytes=nbytes, flops=flops)
        entries.append(e)
        log(f"kernels: {e['name']:34s} ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms if library_ms is None else round(library_ms, 4)} "
            f"bound_ms={b_ms:.4f} ({b_by}) max_abs_err={err['max_abs_err']} "
            f"n>=2^24={err['n_ge_2_24']} launches={launches[name]}")
        torch.cuda.empty_cache()

    f32 = 4
    for key in sorted(recorder.inputs, key=str):
        name, a, kw = recorder.inputs[key]
        mch = kw.get("mch")
        if name == "fused_hop_cols":
            state, src, w, ptr = a
            Qn, N, C = state.shape
            E, V = src.numel(), ptr.numel() - 1
            U = _unique_rows(src, N)
            qw = 1 if (Qn == 1 or w.stride(0) == 0) else Qn
            nbytes = f32 * (V + 1 + E + qw * E * C + Qn * U * C + Qn * V * C)
            if mch is not None:
                nbytes += f32 * (Qn * U + Qn * V)
            library = None
            if C == 1 and mch is None and qw == 1:
                # one CSR SpMM computes the static hop for every query
                # edges from the zero row drop out; columns stay ascending
                # within each row (traversal edges are sorted by (dst, src))
                keep = src < N
                rows = HK.segment_ids(ptr, E)[keep]
                crow = torch.zeros(V + 1, dtype=torch.long, device=src.device)
                crow[1:] = torch.cumsum(torch.bincount(rows, minlength=V), 0)
                A = torch.sparse_csr_tensor(crow, src[keep].long(),
                                            w[0, keep, 0].contiguous(), size=(V, N))
                X = state[:, :, 0].t().contiguous()
                library = lambda A=A, X=X: torch.sparse.mm(A, X)
                compare(library().t(), HK.fused_hop_cols(*a, **kw)[0][:, :, 0],
                        "library sparse.mm vs fused_hop_cols")
            variant = f"C={C}" + (",extremum" if mch is not None else "")
            entry(name, variant, lambda: HK.fused_hop_cols(*a, **kw),
                  lambda: HK.fused_hop_cols_plain(*a, **kw), library, nbytes,
                  2.0 * Qn * E * C)
        elif name == "fused_hop_interval":
            state, src, w, sb, eb, ptr = a
            Qn, N, B, Bp1 = state.shape
            NC = B * Bp1
            E, V = src.numel(), ptr.numel() - 1
            U = _unique_rows(src, N)
            qw = 1 if (Qn == 1 or w.stride(0) == 0) else Qn
            active = int(((w != 0) & (src < N)[None]).sum())
            nbytes = f32 * (V + 1 + E + 3 * qw * E + Qn * U * NC + Qn * V * NC)
            if mch is not None:
                nbytes += f32 * (Qn * U + Qn * V)
            variant = f"B={B}" + (",extremum" if mch is not None else "")
            entry(name, variant, lambda: HK.fused_hop_interval(*a, **kw),
                  lambda: HK.fused_hop_interval_plain(*a, **kw), None, nbytes,
                  4.0 * active * NC)
        else:
            contrib, ptr = a
            Qn, E = contrib.shape[:2]
            C = contrib[0, 0].numel()
            V = ptr.numel() - 1
            seg = HK.segment_ids(ptr, E)
            out0 = contrib.new_zeros((Qn, V) + tuple(contrib.shape[2:]))
            library = lambda: out0.clone().index_add_(1, seg, contrib)
            nbytes = f32 * (V + 1 + Qn * E * C + Qn * V * C)
            entry(name, f"C={C}", lambda: (HK.scatter_cols(*a), None),
                  lambda: (HK.scatter_cols_plain(*a), None), library, nbytes,
                  1.0 * Qn * E * C)
    # B4 on the edges of the largest main-path ETR delivery (static, C = 1)
    key = ("scatter_cols", 1, False)
    contrib, ptr = recorder.inputs[key][1]
    Qn, E = contrib.shape[:2]
    V = ptr.numel() - 1
    rng = np.random.default_rng(0)
    m_e = torch.from_numpy(rng.integers(1, 500, size=(Qn, E)).astype(np.float32)).to(contrib.device)
    alive = (contrib.reshape(Qn, E) > 0).float()
    for op_is_min in (True, False):
        neutral = float("inf") if op_is_min else float("-inf")
        seg = HK.segment_ids(ptr, E).expand(Qn, E)
        gated = torch.where(alive > 0, m_e, torch.full_like(m_e, neutral))
        out0 = torch.full((Qn, V), neutral, device=m_e.device)
        red = "amin" if op_is_min else "amax"
        library = lambda out0=out0, gated=gated, red=red: out0.clone().scatter_reduce_(
            1, seg, gated, red, include_self=True)
        entry("scatter_extremum", "min" if op_is_min else "max",
              lambda op=op_is_min, n=neutral: (HK.scatter_extremum(m_e, alive, ptr, n, op), None),
              lambda op=op_is_min, n=neutral: (HK.scatter_extremum_plain(m_e, alive, ptr, n, op), None),
              library, 4.0 * (V + 1 + 2 * Qn * E + Qn * V), 1.0 * Qn * E)
    return entries


def main(argv=None) -> int:
    warnings.filterwarnings("ignore", message="Sparse")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", default=str(ROOT / "build" / "chip_smoke.json"),
                    help="where the full JSON report is written")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    smi = phase_device()
    from repro_torch.kernels import hop_scatter as HK

    phase_build()
    phase_oracle()
    rec = Recorder(HK)
    REPORT["main"], graph, jobs = phase_main(rec)
    REPORT["profile"] = phase_profile(graph, jobs)
    rec.capture(lambda j: run_job(graph, jobs[j]))
    kernels = phase_kernels(rec, REPORT["main"]["launches"])
    REPORT["kernels"] = kernels
    REPORT["wall_s"] = time.perf_counter() - t_start
    report = Path(args.report)
    report.parent.mkdir(parents=True, exist_ok=True)
    report.write_text(json.dumps(REPORT, indent=1))
    log(f"wall: {REPORT['wall_s']:.1f}s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
