"""One run of one cell: data from the seed, the server warmed, a measured
window, the check, and the result's one JSON line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the graph and the query stream from ``--seed``, builds the
program's tables on the card, starts the server and runs each executable the
window can meet (every template at every padded batch size up to the mix's
``max_batch``).  The window then runs the mix's loop for ``--seconds``.  With
``--trace 1`` the last seconds of the window run under ``torch.profiler`` and
the line carries the cell's per-layer metrics; with ``--trace 0`` its
end-to-end metrics.  After the window the program is freed and the reference
judges a seeded sample of the served answers.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import Dict

import numpy as np
import torch

from .gen import ldbc as G
from .gen import traffic as TR
from .lib import check as CK
from .lib import loop as LP
from .lib import program as P
from .lib import spec as SP
from .lib import trace as TRC

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _seed_sequence(seed: int):
    return np.random.SeedSequence([abs(seed), int(seed < 0)])


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def padded_sizes(max_batch: int) -> list:
    """The padded batch sizes of groups of 1 .. ``max_batch`` queries."""
    out, p = [], 1
    while p < max_batch:
        out.append(p)
        p *= 2
    return out + [p]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, t_start: float = None) -> int:
    """The command line: one run of one cell on the card."""
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = SP.benchmark()
    w = SP.cell(args.workload, bench)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < w["chips"]:
        _log(f"needs {w['chips']} CUDA device(s); found {found}")
        return 2
    line = run_cell(w, bench, args.seed, args.seconds, bool(args.trace),
                    torch.device("cuda", 0), t_start)
    if line is None:
        return 3
    print(json.dumps(line), flush=True)
    return 0


def prepare(w: Dict, seed: int, seconds: float, trace: bool, dev) -> Dict:
    """A cell's set-up: the graph and the query stream from ``seed``, the
    program's tables on ``dev``, the server, every executable warmed."""
    cfg, mix = w["config_spec"], w["mix"]
    TR.check_mix(mix)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    server_cfg = cfg["server"]
    mode = mix.get("mode") or server_cfg["mode"]
    ss_graph, ss_stream, ss_judge, ss_warm = _seed_sequence(seed).spawn(4)
    setup: Dict[str, float] = {}
    t = time.perf_counter()
    g = G.generate(G.params_of(cfg), np.random.default_rng(ss_graph))
    setup["gen_s"] = time.perf_counter() - t
    t = time.perf_counter()
    graph = P.make_graph(g)
    P.build_tables(graph, dev)
    setup["tables_s"] = time.perf_counter() - t
    t = time.perf_counter()
    server = P.make_server(graph, server_cfg, mode, trace=trace, device=dev)
    setup["server_s"] = time.perf_counter() - t

    rng = np.random.default_rng(ss_stream)
    offsets = None
    if mix["loop"] == "open":
        offsets = TR.arrivals(mix, seconds, rng)
        n_stream = len(offsets)
    else:
        n_stream = int(mix["pool"])
    stream = TR.build_stream(mix, g, n_stream, rng)
    instances = [P.to_instance(q) for q in stream]
    cap = int(mix["max_batch"])

    t = time.perf_counter()
    warm_rng = np.random.default_rng(ss_warm)
    pool = TR.QB.pools(g)
    for size in padded_sizes(cap):
        for name in TR.templates(mix, g):
            for _ in range(size):
                server.submit(P.to_instance(TR.QB.build(name, warm_rng, pool)))
        for r in server.flush(warm=True):
            if r.status != "done":
                raise RuntimeError(f"warm-up query failed: {r.template}: {r.error}")
    _sync(dev)
    setup["warm_s"] = time.perf_counter() - t
    return dict(g=g, graph=graph, server=server, stream=stream,
                instances=instances, offsets=offsets, cap=cap, mode=mode,
                n_buckets=server_cfg["n_buckets"], setup=setup,
                judge_rng=np.random.default_rng(ss_judge))


def run_cell(w: Dict, bench: Dict, seed: int, seconds: float, trace: bool,
             dev, t_start: float):
    """One run of the cell ``w`` (``spec.cell``) on ``dev``; the result's
    line, or None when JAX or the JAX package got loaded (looked for when
    the window closes and again once the line is made)."""
    mix = w["mix"]
    c = prepare(w, seed, seconds, trace, dev)
    server, stream, instances, cap = c["server"], c["stream"], c["instances"], c["cap"]
    g, mode, n_buckets, setup = c["g"], c["mode"], c["n_buckets"], c["setup"]
    offsets = c["offsets"]
    prof = None
    if trace:
        prof = LP.Profiler(min(5.0, seconds / 3), dev)
        from torch.profiler import profile

        with profile(activities=prof.activities()):
            torch.zeros(1, device=dev).add_(1)   # the tracer's own start-up
    launches0 = P.hop_launches()
    judge = LP.Reservoir(int(mix["judge_per_template"]), c["judge_rng"])
    graph = c["graph"]
    del c
    gc.collect()
    _sync(dev)

    # ---------------------------------------------------------------- window
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    if mix["loop"] == "open":
        win = LP.run_open(server, instances, stream, offsets, cap, seconds,
                          judge, prof)
    else:
        win = LP.run_closed(server, instances, stream, int(mix["clients"]), cap,
                            seconds, judge, prof)
    _sync(dev)
    launches = {k: v - launches0[k] for k, v in P.hop_launches().items()}
    bad = forbidden_modules()
    if bad:
        _log(f"modules of JAX or the JAX package are loaded: {bad}")
        return None
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    traced = None
    if prof is not None and prof.span is not None and prof.span[1] is not None:
        traced = TRC.reduce(prof.prof, prof.span[1] - prof.span[0])
        traced["flushes"] = prof.flushes

    # ------------------------------------------------------- free, then judge
    del server, graph, instances
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    correct, checks, ref_s = CK.judge(
        judge.all(), lambda q: P.served_mode(q, mode), g, n_buckets, dev,
        win.n_failed, w["limits"], w["config_spec"]["server"]["keep_outputs"])

    run = dict(window=win, setup=setup, setup_s=setup_s, trace=traced,
               launches=launches, mix=mix, mode=mode)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in SP.metrics_for(w["name"], kind, bench):
        value = SP.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    device = dict(platform="gpu" if dev.type == "cuda" else dev.type,
                  kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
                  count=1, memory_peak_bytes=memory_peak)
    line = dict(correct=bool(correct), attempted=win.n_attempted,
                failed=win.n_failed, metrics=metrics, device=device)
    if trace and traced is not None and traced["busy_s"] is not None:
        device.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        line["breakdown"] = dict(
            device_ops=[[n[:200], s] for n, s, _ in traced["kernels"][:10]],
            idle_gaps=traced["idle_gaps"][:10])
    lat = win.latencies_ms()
    _log(f"setup {json.dumps(setup)} setup_s {setup_s:.3f}; window {win.elapsed_s:.3f} s, "
         f"{win.n_done} answered of {win.n_attempted}, {len(win.flushes)} flushes; "
         f"latency p50 {np.percentile(lat, 50) if lat.size else float('nan'):.3f} "
         f"p95 {np.percentile(lat, 95) if lat.size else float('nan'):.3f} ms; "
         f"reference {ref_s:.3f} s; hop launches {launches}")
    line["launches"] = launches
    line["checks"] = checks
    for k, c in checks.items():
        _log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    # again after the reference and every metric reader, which load files
    # that later cells add
    bad = forbidden_modules()
    if bad:
        _log(f"modules of JAX or the JAX package are loaded: {bad}")
        return None
    return line
