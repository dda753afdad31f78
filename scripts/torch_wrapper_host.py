"""Host time of the B5 and B7 wrappers, for one or more checkouts of the port,
on one card.

    python3 scripts/torch_wrapper_host.py --trees <parent checkout> . [--out PATH] [--pairs N]

Each tree runs in a process of its own (this script with ``--child``, the
tree's ``src`` first on the path, so that each imports and builds its own
``repro_torch``), in turns A B B A for two trees, and every tree is timed by
the timers of this checkout's ``chip_smoke.py``.  On inputs made on the card
from a seed at the main path's shapes:

  b5_c1, b5_c3   ``bucket_scatter`` at a GNN request's union graph: 168,960
                 edges into 169,984 segments (uniform sorted segment ids, a
                 reused ``build_layout``), C = 1 and 3, float32
  b7_decode      ``decode_attention`` at gemma3-4b's global decode: q [8, 8,
                 1, 256], caches [8, 4, 2080, 256] bf16, cache_len 2079
  b7_prefill     ``flash_attention`` at its global prefill: [8, 8, 2048, 256]
                 against [8, 4, 2048, 256] bf16, causal

and per call: ``host_us`` (``host_us``: the wrapper's Python, checks and
launches), ``ms`` (``time_ms``: one call on an idle card, host time to the
launch included) and ``b2b_ms`` (``b2b_ms``).  ``index_add_`` (into zeros,
as the plain version does) is timed beside B5 the same way, and B5 and
``index_add_`` once more in ``--pairs`` alternating single calls
(``time_ms_turns``): ``turns_ms`` of each.  Prints one
JSON line per turn and writes them all to ``--out`` (default
``build/torch_wrapper_host.json``).  Needs the card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(pairs: int) -> dict:
    """The timings of the ``repro_torch`` first on the path."""
    import repro_torch
    from repro_torch.kernels import bucket_scatter as BS
    from repro_torch.kernels import flash_attention as FA

    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS     # its timers; repro_torch stays the tree's, imported above
    import torch

    def row(fn):
        return dict(host_us=CS.host_us(fn), ms=CS.time_ms(fn), b2b_ms=CS.b2b_ms(fn))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    out = dict(package=repro_torch.__file__)
    E, V = 168_960, 169_984
    seg = torch.randint(0, V, (E,), generator=gen, device=dev).sort().values.to(torch.int32)
    lay = BS.build_layout(seg, V)
    seg_long = seg.long()
    for C in (1, 3):
        c = torch.randn(E, C, generator=gen, device=dev)
        kern = lambda c=c: BS.bucket_scatter(c, seg, V, lay)
        lib = lambda c=c, C=C: torch.zeros((V, C), device=dev).index_add_(0, seg_long, c)
        out[f"b5_c{C}"] = row(kern)
        out[f"index_add_c{C}"] = row(lib)
        t, tl = CS.time_ms_turns(kern, lib, iters=pairs)
        out[f"b5_c{C}"]["turns_ms"] = t
        out[f"index_add_c{C}"]["turns_ms"] = tl
    bf = torch.bfloat16
    q1 = torch.randn(8, 8, 1, 256, generator=gen, device=dev).to(bf)
    kc = torch.randn(8, 4, 2080, 256, generator=gen, device=dev).to(bf)
    vc = torch.randn(8, 4, 2080, 256, generator=gen, device=dev).to(bf)
    out["b7_decode"] = row(lambda: FA.decode_attention(q1, kc, vc, 2079))
    del kc, vc
    q = torch.randn(8, 2048, 8, 256, generator=gen, device=dev).to(bf).transpose(1, 2)
    k = torch.randn(8, 2048, 4, 256, generator=gen, device=dev).to(bf).transpose(1, 2)
    v = torch.randn(8, 2048, 4, 256, generator=gen, device=dev).to(bf).transpose(1, 2)
    out["b7_prefill"] = row(lambda: FA.flash_attention(q, k, v, causal=True))
    out["device"] = torch.cuda.get_device_name(0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", help="checkouts to time, in order")
    ap.add_argument("--out", default=str(ROOT / "build" / "torch_wrapper_host.json"))
    ap.add_argument("--pairs", type=int, default=200,
                    help="alternating single calls of B5 and index_add_")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.pairs)))
        return 0
    if not args.trees:
        ap.error("--trees is required")
    trees = [Path(t).resolve() for t in args.trees]
    order = trees + trees[::-1] if len(trees) == 2 else trees
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    turns = []
    for tree in order:
        env = dict(os.environ, PYTHONPATH=str(tree / "src"))
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                              "--pairs", str(args.pairs)],
                             cwd=tree, env=env, capture_output=True, text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stderr)
            raise SystemExit(f"torch_wrapper_host: {tree} failed")
        rec = dict(tree=str(tree), **json.loads(res.stdout.strip().splitlines()[-1]))
        if not rec["package"].startswith(str(tree)):
            raise SystemExit(f"torch_wrapper_host: {tree} imported {rec['package']}")
        turns.append(rec)
        print(json.dumps(rec), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(nvidia_smi=smi, turns=turns), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
