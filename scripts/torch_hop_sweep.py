"""Time B1's and B3's narrow kernels at every launch shape, on the main path's
own calls, on an NVIDIA H100.

    python3 scripts/torch_hop_sweep.py [--out PATH] [--rounds N]

Runs ``chip_smoke.py``'s main phase (the 100,000-person LDBC graph and its
Q1-Q8 and MIN/MAX jobs) to capture the largest call of each variant of
``fused_hop_cols`` (B1) and ``scatter_cols`` (B3), then launches each of them
at every (vec, G) the narrow kernel takes: vec columns a lane (4 where the
rows allow float4s, and 1), G edge slots a destination (a power of two with
G * C / vec <= 32), plus the wrapper's own choice ("auto").  Each shape is
held equal to the plain version and timed three ways: ``time_ms`` (the
median of 10 calls each started on an idle card), ``b2b_ms`` (10 calls back
to back) and ``device_ms`` (traced kernel time).  The shapes run in the
order A..Z, Z..A and the two turns are averaged, so drift on the card does
not favour one end of the list.

Also, for B1 at C = 1, ``--rounds`` alternating single-call medians of the
kernel and ``torch.sparse.mm`` on the same inputs (the spread of that
comparison), and the wrapper's host time per call (``perf_counter`` over
200 calls that the card has not yet caught up with).  The full record goes
to ``--out``; a summary line per shape goes to stdout.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402  (puts src/ on the path)
import torch  # noqa: E402

WARP = 32


def shapes(C: int, natural_vec: int) -> list:
    """(vec, G) pairs of the narrow kernel at C columns."""
    out = []
    for vec in sorted({natural_vec, 1}, reverse=True):
        lanes = C // vec
        if C % vec or lanes > WARP or WARP % lanes:
            continue
        G = 1
        while G * lanes <= WARP:
            out.append((vec, G))
            G *= 2
    return out


def forced(ops, vec, G):
    """Patch the wrapper's launch choices to (vec, G); returns a restore."""
    saved = (ops.cols_vector_width, ops.vector_width, ops.lane_group)
    if vec is not None:
        ops.cols_vector_width = lambda C, ext, *rows: vec
        ops.vector_width = lambda C, *rows: vec
        ops.lane_group = lambda E, V, lanes: G

    def restore():
        ops.cols_vector_width, ops.vector_width, ops.lane_group = saved
    return restore


def host_us(fn, n: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return dt


def sparse_library(HK, state, src, w, ptr):
    """``torch.sparse.mm`` over the hop's CSR, as ``chip_smoke.py`` builds it."""
    Qn, N, _ = state.shape
    E, V = src.numel(), ptr.numel() - 1
    keep = src < N
    rows = HK.segment_ids(ptr, E)[keep]
    crow = torch.zeros(V + 1, dtype=torch.long, device=src.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=V), 0)
    A = torch.sparse_csr_tensor(crow, src[keep].long(), w[0, keep, 0].contiguous(), size=(V, N))
    X = state[:, :, 0].t().contiguous()
    return lambda: torch.sparse.mm(A, X)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "torch_hop_sweep.json"))
    ap.add_argument("--rounds", type=int, default=5)
    args = ap.parse_args(argv)
    smi = CS.phase_device()
    from repro_torch.kernels import build
    from repro_torch.kernels import hop_scatter as HK
    from repro_torch.kernels.hop_scatter import ops

    build.load()
    rec = CS.Recorder(HK)
    _, graph, jobs = CS.phase_main(rec)
    rec.capture(lambda j: CS.run_job(graph, jobs[j]))
    report = dict(card=smi, calls=[])
    for key in sorted(rec.inputs, key=str):
        name, a, kw = rec.inputs[key]
        if name == "fused_hop_interval":
            continue
        if name == "fused_hop_cols":
            state, src, w, ptr = a
            C, ext = state.shape[-1], kw.get("mch") is not None
            natural = HK.cols_vector_width(C, ext, (state, HK.query_stride(state, "state")),
                                           (w, HK.query_stride(w, "w")))
            kern = lambda: HK.fused_hop_cols(*a, **kw)
            want = HK.fused_hop_cols_plain(*a, **kw)
        else:
            contrib, ptr = a
            C, ext = contrib[0, 0].numel(), False
            natural = HK.vector_width(C, (contrib, HK.query_stride(contrib, "contrib")))
            kern = lambda: (HK.scatter_cols(*a), None)
            want = (HK.scatter_cols_plain(*a), None)
        if C // natural > WARP:
            continue                                   # the wide path: no lane group
        E, V = (a[1].numel() if name == "fused_hop_cols" else a[0].shape[1]), ptr.numel() - 1
        call = dict(kernel=name, C=C, extremum=ext, E=E, V=V, Q=a[0].shape[0],
                    auto=dict(vec=natural, G=HK.lane_group(E, V, C // natural)), shapes={})
        order = [(None, None)] + shapes(C, natural)
        for seq in (order, order[::-1]):
            for vec, G in seq:
                restore = forced(ops, vec, G)
                try:
                    got = kern()
                    torch.cuda.synchronize()
                    same = all(torch.equal(g, h) for g, h in zip(got, want) if g is not None)
                    t = dict(ms=CS.time_ms(kern), b2b_ms=CS.b2b_ms(kern),
                             device_ms=CS.device_ms(kern), equal=same)
                    if vec is None:
                        t["host_us"] = host_us(kern)
                finally:
                    restore()
                label = "auto" if vec is None else f"vec={vec},G={G}"
                call["shapes"].setdefault(label, []).append(t)
                if not same:
                    raise AssertionError(f"{name} C={C} {label}: differs from the plain version")
        for label, ts in call["shapes"].items():
            mean = {k: sum(t[k] for t in ts) / len(ts) for k in ("ms", "b2b_ms", "device_ms")}
            call["shapes"][label] = dict(turns=ts, **mean)
            print(f"sweep: {name}[C={C}{',extremum' if ext else ''}] E={E} V={V} {label:12s} "
                  + " ".join(f"{k}={v:.4f}" for k, v in mean.items())
                  + " turns " + " / ".join(f"{t['device_ms']:.4f}" for t in ts), flush=True)
        if name == "fused_hop_cols" and C == 1 and not ext:
            lib = sparse_library(HK, *a)
            pairs = [dict(kernel_ms=CS.time_ms(kern), sparse_mm_ms=CS.time_ms(lib))
                     for _ in range(args.rounds)]
            call["vs_sparse_mm"] = dict(
                rounds=pairs, sparse_mm_b2b_ms=CS.b2b_ms(lib),
                sparse_mm_device_ms=CS.device_ms(lib), sparse_mm_host_us=host_us(lib))
            print("sweep: B1 C=1 single-call kernel / sparse.mm: "
                  + ", ".join(f"{p['kernel_ms']:.4f}/{p['sparse_mm_ms']:.4f}" for p in pairs)
                  + f"; sparse.mm b2b {call['vs_sparse_mm']['sparse_mm_b2b_ms']:.4f} device "
                  f"{call['vs_sparse_mm']['sparse_mm_device_ms']:.4f} host_us "
                  f"{call['vs_sparse_mm']['sparse_mm_host_us']:.1f}; kernel host_us "
                  f"{call['shapes']['auto']['turns'][0]['host_us']:.1f}", flush=True)
        report["calls"].append(call)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
