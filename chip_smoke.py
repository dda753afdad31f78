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
               variant, captured by re-running the job that made it), timed
               beside its bound and the PyTorch library call that computes
               the same function, where one exists.  ``ms`` (and plain_ms,
               library_ms) is the median of 10 CUDA-event timings, each of
               one call started on an idle card (``time_ms``: the host's
               time to the launch included), on every kernel line.  Every
               line also gives, for the kernel and the library call (not the
               plain version since the olmoe phase came), ``*b2b_ms``,
               CUDA-event time per call over
               10 calls launched back to back (``b2b_ms``), ``*device_ms``,
               the traced device time of a call (``device_ms``), and
               ``*device_mean_ms``, the same trace read so that dropped
               device events do not lower it (``device_mean_ms``); and
               ``turns_ms`` / ``library_turns_ms``, the kernel's and the
               library call's single calls in 20 alternating pairs
               (``time_ms_turns``).  B4, which no engine path reaches, is held
               (torch.equal) on a main-path ETR delivery's CSR and on the
               graph's global arrival CSR (``[dense,...]``), each with a
               seed-0 gate that keeps half the edges; it fails unless the
               trace counts two kernel launches a call.  Each B1-B3 line also names
               its call's shape: Q, V, E, C or B, whether the weights are
               shared across queries, the largest arrival degree, and the
               lane group G the wrapper launched with (``lane_group`` of the
               lanes an edge takes; B2: the lanes of one destination and
               query, a warp, or a block at B >= 32).
  6a. part.    the partitioned executor (core/engine_partitioned.py) on the
               main graph at W = 4 and 8 (parts_per_type = max(4, W // 2)):
               set-up (partition and table seconds, v_max, e_max, h_max,
               edge cut, size imbalance, exchange volumes, the pad slots the
               kernels' flattened CSR leaves out); every main-path job
               through ``execute_batch_out(impl='cuda')``, the median of
               PART_REPEATS CUDA-event timings (1 at both W since the olmoe
               phase came; 3 at W = 4 and 1 at W = 8 before it, 5 at both
               until the train phase came) beside the main phase's ms, peak
               beside
               resident memory; answers held to the main path's impl='cuda'
               (and at W = 4 to partitioned impl='torch'), bit-equal below
               2^24, rtol 1e-6 above (counted); every timed call must
               launch B1 (B2 in interval mode) once per plain hop and B3
               once per ETR hop, and each of the three must launch over the
               phase.  At W = 4 (at both until the train phase came)
               ``measure_supersteps`` on Q4 and agg-min-2hop in static mode
               (per-hop makespan, balance, channel volumes), and one traced
               run of each profiled job (phase 5's).
               Then, at each W, B1-B3 lines on the largest partitioned
               call of each variant (the flattened workers' CSR), timed as
               in phase 6.
  6b. serve    the query server on the main graph (``serving/``,
               ``launch/query.py``), on the kernels (impl='cuda'): the
               bucket drain ``--serve`` runs (``GraniteServer.
               run_workload_scheduled`` with the flight recorder and the
               metrics registry) of the Q1-Q8 workload (8 instances each,
               seed 1) and the MIN variants of its ETR-free template, a
               static-mode drain with one traced flush, and the open-loop
               replay at 50 queries/s (``replay_workload``), and bucket and
               static drains on the partitioned engine (``n_workers=4``),
               every query's answer held to the auto (sliced/dense) drain's
               (bit-equal below 2^24).  B1 and B3's counters, set to 0
               before the drains, must have moved after, on both engines.
               Per drain, a steady flush (every plan and executable cached)
               gives each group's template, engine, split, impl, batch, the
               planner's predicted ms and its CUDA-event ms; the flush's wall
               ms beside the sum of its dispatch ms (the difference is the
               runtime's host time), served latency p50/p95/p99, queries/s,
               peak beside resident memory and the caches.  Every served
               query must be done, and every group's answer equal to
               ``execute_batch_out`` at its split on impl='torch' (bit-equal
               below 2^24, rtol 1e-6 at or above, counted).  Then ``python -m
               repro_torch.launch.query --persons 1000 --dynamic --queries 2
               --serve --verify`` must exit 0 and print ``verification vs
               oracle: OK``, and so must the same command with ``--engine
               partitioned``; the two run side by side.
  6c. live     live graphs on the main graph (``graphdata/ingest.py``,
               ``serving/epochs.py``, the scheduler's ``pin_epoch`` and its
               base+delta dispatch): ``log_from_graph`` holds out a tenth of
               the edges (seed SEED), an ``EpochManager`` (compact_every 8,
               max_delta_frac 0.5) seals epoch 0 and ingests the held edges
               back in LIVE_EPOCHS epochs, all delta-pure, and a last
               ``advance(compact=True)`` compacts.  At each epoch the serve
               phase's workload is drained in bucket and static mode (Q2 and
               Q2-min also in interval mode at epoch 1) on one pinned
               scheduler: a first flush, a steady flush (``timed_flush``)
               whose B1/B2/B3 launches must equal one per hop of each
               dispatch, and a check flush whose counts must equal the
               steady flush's, holding every group to impl='torch' on the
               epoch's merged graph at the delta epochs (LIVE_TORCH_EPOCHS;
               epochs 0 and the compaction's too until the train phase came;
               the compaction's answers are held to the serve phase's
               instead).  It fails unless
               the ETR-free groups, and only they, run on the delta path at
               the delta epochs, their executables hit the cache after the
               first, no cache entry is invalidated before the compaction and
               some are at it, the delta groups equal a scheduler built
               fresh on the merged graph (epoch 1), a drain after an ingest
               and before the advance equals the one before the ingest, the
               partitioned engine (W = LIVE_WORKERS, static) equals the auto
               drain at epochs 0 and 1, epoch 1's partition tables come
               through the partition hint, and every answer after the
               compaction equals the serve phase's on the original graph.
               The flight recorder and a telemetry buffer ride epoch 0's
               first bucket drain: the telemetry replayed from the trace
               (``obs/audit.py``) must equal the live buffer's, and
               ``scripts/torch_trace_report.py --audit`` must render the
               trace.  Beside the host's set-up (``log_from_graph`` and epoch
               0), ``python -m repro_torch.launch.query --persons 1000 --live
               --wal build/live.wal --holdout 64 --epochs LIVE_EPOCHS`` runs
               fresh and again on the same WAL, which must recover
               LIVE_EPOCHS + 1 sealed epochs and pin the first run's last
               fingerprint; both end before the first timed drain.
               Lines: ``live: set-up``, ``audit:``, ``live: epoch k`` (events,
               materialize and seal s, fingerprints, delta edges and
               capacity, flush wall ms and p50/p99, delta/merged dispatches,
               cache, peak/resident GiB, B1/B2/B3 launches), the partitioned
               drains and the CLI.
  7. lm        gemma3-4b at full width (34 layers, 3.88 B parameters in bf16,
               random weights from SEED, made on the card): first its SMOKE
               variant on the card against the port on the CPU; then the
               serve path, 8 prompts of 2048 tokens through ``prefill`` and 31
               greedy ``decode_step``s (32 tokens a sequence), with the
               attention counters (B7) set to 0 just before and read just
               after: they must read 34 x 32, the prefill's 34 through the
               tensor-core kernel (route 'tc') and the 34 x 31 of decode
               through the split-K kernel ('decode').  One traced prefill
               and decode step.  impl='torch' is held against the run with
               teacher forcing (it gets the run's tokens): logits within
               twice the plain bf16 run's own distance from the model in
               float32, and the same greedy token wherever the top-2 gap
               exceeds that.  The same model in float32 runs through the
               float32 routes (the prefill through the CUDA-core kernel,
               'simt'; decode through the split-K kernel) and is held,
               teacher-forced, against impl='torch' in float32 within 1e-3
               of each step's max |logit| (summation order is the only
               difference there).  Then B7 against its plain version on the
               calls of layer 0 (local) and layer 5 (global) of the prefill
               and of the last decode step, in bf16 and cast to float32,
               timed as in phase 6 (B5-B8 lines: single call, back to back
               and device for kernel, plain version and library call, and
               the host's time of a wrapper call); each line is named by
               the route it takes, the decode lines give their splits and
               blocks (the global one must fill the card's SMs).  The
               library call is SDPA with the call's mask, and where one call
               without a mask tensor computes the same function (is_causal
               on the global prefill; the visible keys sliced out in decode)
               that form too: each is timed, and the faster in a single call
               is the line's library call.  The global prefill also gives
               the host's time to encode its three tensor maps.
               Then the int8 KV cache on the same traffic: ``prefill``, its
               float cache turned into the int8 cache by
               ``transformer.quantize_cache``, and 31 ``decode_step``s with
               ``kv_cache_quant`` fed the bf16 run's tokens, B7 counted: 34 x
               31 launches of the int8 decode route ('decode_int8').
               impl='torch' from a copy of the same cache is held against it,
               teacher-forced, within the bf16 run's per-step bounds; decode
               ms a token beside the bf16 run's, peak GiB, the cache's bytes
               against bf16's, greedy agreement and post-softmax distance
               from the bf16 run are findings.  Then the int8 route against
               ``attention_int8_plain`` on layer 0's (local) and layer 5's
               (global) last-step calls, timed as above; the library call is
               SDPA over a bf16 copy of the visible rows dequantized
               beforehand.
  7a. olmoe   OLMoE-1B-7B at full width (16 layers, 64 experts top-8,
               6.82 B parameters in bf16, random weights from SEED, made on
               the card): first its SMOKE variant on the card against the
               port on the CPU, and ``transformer.top_k``'s tie order (equal
               gates: the lower expert first) on the card; then the serve
               path as in phase 7 (8 prompts of 2048 tokens, 31 greedy
               ``decode_step``s; the MoE layers' capacity is 320 a row in
               the prefill, 1 in decode), B7 counted: 16 x 32 launches, the
               prefill's 16 through 'tc' and the 496 of decode through
               'decode'; one traced prefill and decode step.  Then four runs
               teacher-forced on the served tokens, their routing recorded
               layer by layer (``RouteCapture``): impl='cuda' and 'torch' in
               bf16, and both again in float32 (the bf16 weights cast up).
               float32: logits within 1e-3 of each step's max |logit|, and
               every token whose expert set differs between the two runs
               explained by a root flip (a gate gap under ROUTE_TIE in the
               'torch' run) or by an earlier one in its row (``route_flips``;
               such rows are left out of the logit bound and counted).
               bf16: the flips are counted; the logits are held within twice
               the plain bf16 run's own distance from float32 until a token
               routes differently, and reported after.  Then B7 against its
               plain version on layer 0's prefill and last decode step call,
               timed as in phase 7 (``flash_attention_*[olmoe,...]``).
  8. dlrm      DLRM-RM2 at full width (26 tables of 1,000,000 x 64 float32,
               random from SEED): SMOKE on the card against the CPU; then
               ``serve_score`` at batch 512 and 262,144 and
               ``retrieval_score`` of one query against 1,000,000 candidates
               (top 128), with the EmbeddingBag counter (B8) set to 0 just
               before and read just after; one traced run of each;
               impl='torch' held against them; B8 must launch once a
               forward (all 26 tables in one launch), 3 in all;
               then B8 against its plain version on the bulk batch's first
               table, and its table-batched launch over all 26 tables on
               the bulk batch (equal to the plain version and to the 26
               single-table calls, whose summed host time and ms stand
               beside it), timed as in phase 6.
  9. gnn       GNN inference on the minibatch_lg deployment (configs/common.py
               GNN_SHAPES): a synthetic graph of 232,965 nodes and 114,615,892
               edges made on the card from SEED, its CSR and a 232,965 x 602
               float32 feature table resident there; for each of PNA, EGNN,
               MeshGraphNet and SchNet at CONFIG width (random weights from
               SEED), 8 requests of 1,024 seeds: sample_union_graph with
               fanout (15, 10), feature gather, the model's *_apply, the
               predictions at the seeds.  The segment-sum counter (B5) is set
               to 0 just before the requests and read just after: it must
               equal the count worked out from models/gnn.py.  Median request
               latency by CUDA events, split into sample, gather and forward;
               peak beside resident memory; one traced request.
               impl='torch' is held against impl='cuda' on the same sampled
               batches within 1e-4 of each output's max |value|.  Then B5
               against its plain version on captured operands of the
               requests, timed as in phase 6.
  9a. registry ``load_arch(a).smoke()`` for every id of ``configs.ARCH_IDS``
               on the card: each ok with a finite loss; granite-ldbc's engine
               counts equal to its oracle's; an LM SMOKE whose d_head B7
               takes must launch B7 (those of d_head 8 or 12 attend with the
               plain version: no kernel is built that narrow).

  10. train    MiniCPM-2B training (``training/``; the first of
               ``launch/train.py``'s synthetic zipf batches at every step;
               AdamW with the configuration's WSD schedule, 100 warm-up
               steps to lr 3e-4): first its SMOKE variant, the
               loss and every gradient leaf on the card against the port on
               the CPU (atol 2e-5); then CONFIG at full width (40 layers,
               2.72 B parameters in bf16, float32 moments, random weights
               from SEED, remat on), batch 4 x 1,024 tokens: one warm-up
               step, 4 timed steps and one step with 2 microbatches on the
               same batch, each timed by CUDA events with its tokens/s,
               loss, grad norm, lr, peak and resident memory, and one
               traced step (device busy and idle share, top kernels); it
               fails unless every loss and grad norm is finite and the last
               loss is below the first.  Then two layers at full width: one step
               in bf16 against the same step in float32 on the same values
               (loss within 1e-2 relative, grad norm 5e-2); that bf16 state
               (parameters and moments) through ``save_async`` and
               ``restore`` under build/ (every leaf torch.equal, write and
               read seconds), and a ``FaultTolerantRunner`` of 4 steps,
               checkpointing every 2, with a failure injected after step 3,
               which must replay step 3 from the step-2 checkpoint and end
               torch.equal to the uninterrupted run.  No kernel runs here: the training
               path is plain PyTorch, as the reference's reaches no Pallas
               kernel.

  11. dryrun   the dry run (``launch/dryrun.py --all --mesh both --jobs 4``:
               every architecture's shape cells traced on the ``meta``
               device, 82 records and 6 skipped) in a child process on the host,
               started just before the train phase and joined after it; it
               fails unless the summary reads ok=82 skipped=6 errors=0.
               Then the whole-step rooflines: the gemma3-4b prefill, a
               decode step over the bf16 and the int8 cache, the OLMoE
               prefill, the MiniCPM-2B train step, DLRM's bulk serve and the
               agg-min static main-path job, each the same call at the same
               shapes on ``meta`` counted by ``roofline.analysis.
               count_program`` (at mesh 1 x 1): FLOPs by dtype, bytes, the
               bound at the H100's peaks and what bounds it, the ms this
               script measured and the share (bound / measured), with the
               card's name and power limit.  B7's global prefill call
               counted on ``meta`` must equal its kernel line's bytes,
               operations and bound.  No step is timed again.

Phase 6 also holds TimeWarp (B6), which no path of either package reaches,
equal to its plain version through its entry point, on every vertex's
lifespan of the main graph, its 16 bucket edges and the per-vertex bucket
state of a main-path aggregate query, in float32 and cast to bfloat16.

Exactness: counts are integers in float32, so a kernel equals its plain
version bit for bit while magnitudes stay below 2^24; entries at or above
2^24 (where a float32 sum depends on its order) are held to rtol 1e-6 and
counted.  B7 is held to one bf16 rounding of its output (atol 1e-3, rtol
2^-7) in bf16 and to atol = rtol = 2e-5 in float32, the LMs as stated in
phases 7 and 7a, DLRM to rtol 1e-5, B5 to atol = rtol = 1e-4 (the reference's
sweep), B6 exactly (each stated where it is checked).  The last lines are the kernels'
JSON line, the card's name and power limit, and ``{"ok": true, "device":
{...}}``.  Details go to
``--report`` (default ``build/chip_smoke.json``).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import shutil
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the H100's peaks and the kernels' work formulas: one copy, the dry run's
from repro_torch.roofline.analysis import (BF16_FLOP_PER_S, F32_FLOP_PER_S,  # noqa: E402
                                           attention_int8_work, attention_work, bound,
                                           embedding_bags_work)

EXACT = float(2 ** 24)
PERSONS = 100_000             # full size; a cut changes this and is listed in PERF.md
SEED = 1
N_BATCH = 8                   # queries per static / bucket batch
LM_BATCH, LM_PROMPT, LM_TOKENS = 8, 2048, 32   # 32 greedy tokens: prefill + 31 steps
LM_CAPTURE = {0: "prefill,local", 5: "prefill,global"}    # layer -> B7 variant
DLRM_CANDIDATES, DLRM_TOP_K = 1_000_000, 128
GNN_SHAPE, GNN_REQUESTS = "minibatch_lg", 8
GNN_ARCHS = ("pna", "egnn", "meshgraphnet", "schnet")
GNN_TOL = 1e-4                # of max |output|: summation order is the only difference
GNN_B5_LINES = {"pna": (75,), "egnn": (3, 1), "meshgraphnet": (128,)}   # arch -> C timed
WARP_BUCKETS = 16
SOURCE = {
    **dict.fromkeys(("fused_hop_cols", "fused_hop_interval", "scatter_cols",
                     "scatter_extremum"), "src/repro_torch/csrc/hop_scatter.cu"),
    "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
    "flash_attention_tc": "src/repro_torch/csrc/flash_attention_sm90.cu",
    "flash_attention_decode": "src/repro_torch/csrc/flash_decode.cu",
    "flash_attention_decode_int8": "src/repro_torch/csrc/flash_decode_int8.cu",
    "embedding_bag": "src/repro_torch/csrc/embedding_bag.cu",
    "bucket_scatter": "src/repro_torch/csrc/bucket_scatter.cu",
    "interval_warp": "src/repro_torch/csrc/interval_warp.cu",
}
REPLACES = {
    "fused_hop_cols": "src/repro/kernels/hop_scatter/hop_scatter.py:198",
    "fused_hop_interval": "src/repro/kernels/hop_scatter/hop_scatter.py:243",
    "scatter_cols": "src/repro/kernels/hop_scatter/hop_scatter.py:293",
    "scatter_extremum": "src/repro/kernels/hop_scatter/hop_scatter.py:314",
    **dict.fromkeys(("flash_attention", "flash_attention_tc", "flash_attention_decode",
                     "flash_attention_decode_int8"),
                    "src/repro/kernels/flash_attention/flash_attention.py:72"),
    "embedding_bag": "src/repro/kernels/embedding_bag/embedding_bag.py:57",
    "bucket_scatter": "src/repro/kernels/bucket_scatter/bucket_scatter.py:37",
    "interval_warp": "src/repro/kernels/interval_warp/interval_warp.py:27",
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
    """Median of ``iters`` CUDA-event timings of ``fn`` after ``warmup`` calls,
    each started on an idle card: a call's latency, the host's time to its
    first launch included."""
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


def time_ms_turns(*fns, iters: int = 10, warmup: int = 2) -> list:
    """``time_ms`` of each of ``fns`` (None skipped), timed in turns: every
    round times one call of each, in order on even rounds and in reverse on
    odd ones, so that drift in the host's or the card's state (single calls
    of a few tens of microseconds are mostly host time) weighs on all alike.
    For calls of like weight (a kernel and its library call): one much
    heavier call leaves whatever follows it slower, and would split each
    median between a cold and a warm half.  The medians, in order."""
    live = [f for f in fns if f is not None]
    for f in live:
        for _ in range(warmup):
            f()
    torch.cuda.synchronize()
    times = [[] for _ in live]
    for r in range(iters):
        for i in (range(len(live)) if r % 2 == 0 else reversed(range(len(live)))):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            live[i]()
            b.record()
            b.synchronize()
            times[i].append(a.elapsed_time(b))
    meds = iter(float(np.median(t)) for t in times)
    return [None if f is None else next(meds) for f in fns]


def b2b_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """CUDA-event time per call of ``fn`` over ``iters`` calls launched back
    to back after ``warmup`` calls: the stream's time a call, in which the
    host's launch counts only where it is slower than the device."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def host_us(fn, iters: int = 20, warmup: int = 2) -> float:
    """Median host microseconds of one call of ``fn``, timed without waiting
    for the device (its work queues behind the calls before it): the
    wrapper's Python, its checks and its launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return float(np.median(times))


def close(got: torch.Tensor, want: torch.Tensor, atol: float, rtol: float, what: str) -> float:
    """Raise unless |got - want| <= atol + rtol |want| everywhere; returns
    the largest |got - want|."""
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    g, w = got.double(), want.double()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: non-finite values")
    diff = (g - w).abs()
    bad = diff > atol + rtol * w.abs()
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        raise AssertionError(f"{what}: {int(bad.sum())} entries outside atol {atol} rtol {rtol} "
                             f"(first: got {g.flatten()[i].item()} want {w.flatten()[i].item()})")
    return float(diff.max()) if diff.numel() else 0.0


def identical(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """Raise unless equal: the same values (torch.equal) off NaN, NaN in the
    same places and the same signs of zero."""
    ng, nw = torch.isnan(got), torch.isnan(want)
    if not (got.shape == want.shape and torch.equal(ng, nw) and torch.equal(got[~ng], want[~nw])
            and torch.equal(torch.signbit(got[~ng]), torch.signbit(want[~nw]))):
        raise AssertionError(f"{what}: kernel and plain version differ")


def tree_map(fn, tree):
    """``fn`` on every tensor of a parameter tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def leaves(tree) -> list:
    """Every tensor of a parameter tree of dicts and lists."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in leaves(v)]
    return [tree]


def free_memory() -> None:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


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
    """Compile every source of csrc/ at once (one nvcc each), then load."""
    from repro_torch.kernels import build

    names = sorted(build.SIGNATURES)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build.compile_source, names)))
    for name in names:
        build.load(name)
    dt = time.perf_counter() - t0
    REPORT["build"] = dict(total_s=dt, libraries={
        n: dict(library=p.name, nvcc_s=s) for n, (p, s, _) in built.items()})
    log("build: " + ", ".join(f"{p.name} nvcc {s:.1f}s" for p, s, _ in built.values())
        + f"; all built and loaded in {dt:.1f}s")


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


def main_graph():
    """The main path's LDBC graph (PERSONS, SEED) and its generate seconds."""
    from repro_torch.graphdata.ldbc import LdbcParams, generate_ldbc

    t0 = time.perf_counter()
    g = generate_ldbc(LdbcParams(n_persons=PERSONS, dynamic=True, degree_dist="zipf",
                                 align=16, seed=SEED))
    return g, time.perf_counter() - t0


def main_jobs(g) -> list:
    """The main path's jobs (name, mode, split, batch): Q1-Q8 in each mode
    at two splits, then the MIN/MAX shapes."""
    from repro_torch.core import engine as E
    from repro_torch.graphdata.queries import TEMPLATES, make_workload

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
    return jobs


def phase_main(recorder: Recorder):
    """Returns (report dict, graph, the jobs run: (name, mode, split, batch))."""
    from repro_torch.core import engine as E
    from repro_torch.core import engine_sliced as ES
    from repro_torch.kernels import hop_scatter as HK

    g, t_gen = main_graph()
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
    deg = np.diff(g.traversal["arr_ptr"])   # the dense hop's arrival runs
    info["arrival_degree"] = dict(mean=float(deg.mean()), median=float(np.median(deg)),
                                  p99=float(np.percentile(deg, 99)), max=int(deg.max()))
    log("main: arrival degree " + ", ".join(f"{k} {v:g}"
                                             for k, v in info["arrival_degree"].items()))

    jobs = main_jobs(g)

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
_TRACER_READY = False


def traced(fn, top: int = 6) -> dict:
    """One traced run of ``fn`` (torch.profiler): wall and summed kernel
    time, the idle share (1 - busy / wall, not clamped) and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    global _TRACER_READY
    if not _TRACER_READY:             # the first session pays the tracer's start-up
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
        _TRACER_READY = True
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: the aten ops that launched them carry the same time
    rows = [(ev.self_device_time_total / 1e3, ev.key, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
                kernel_launches=sum(r[2] for r in rows),
                top=[dict(kernel=k[:90], ms=ms, calls=c) for ms, k, c in rows[:top]])


def log_trace(tag: str, rec: dict) -> None:
    log(f"{tag} wall_ms={rec['wall_ms']:.3f} device_busy_ms={rec['device_busy_ms']:.3f} "
        f"idle_share={rec['idle_share']:.3f} kernels={rec['kernel_launches']}")
    for t in rec["top"]:
        log(f"profile:    {t['ms']:10.3f} ms  x{t['calls']:<4d} {t['kernel']}")


def phase_profile(graph, jobs, top: int = 6) -> list:
    """Where a query's device time goes: one traced run of each PROFILED
    template in each mode (its first plan of the main path)."""
    out = []
    seen = set()
    for job in jobs:
        name, mode, split, batch = job
        if name not in PROFILED or (name, mode) in seen:
            continue
        seen.add((name, mode))
        run_job(graph, job)
        rec = dict(template=name, mode=["static", "bucket", "interval"][mode],
                   split=split, batch=len(batch), **traced(lambda: run_job(graph, job), top))
        out.append(rec)
        log_trace(f"profile: {name} {rec['mode']} split={split} Q={len(batch)}", rec)
    return out


def _unique_rows(src: torch.Tensor, n_rows: int, needed: torch.Tensor) -> int:
    """Distinct source rows below ``n_rows`` among the edges ``needed`` marks:
    a hop with a weight of 0 needs no state row (B1 and B2 read none), so a
    bound that counted every edge's row would not be one."""
    u = torch.unique(src[needed])
    return int((u < n_rows).sum())


def device_ms(fn, iters: int = 10) -> float | None:
    """Device time of one call of ``fn``: the summed time of the kernels it
    launches (torch.profiler), over ``iters`` calls, per call.  None if the
    trace kept no device event (a sum of nothing is not a reading)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA and ev.count]
    if not evs:
        log("device_ms: the trace kept no device event")
        return None
    return sum(ev.self_device_time_total for ev in evs) / 1e3 / iters


def device_mean_ms(fn, iters: int = 10, per_call: dict | None = None) -> float | None:
    """Device time of one call of ``fn`` read so that dropped device events
    do not lower it: for each kernel it launches, the mean time of its traced
    launches times its launches a call (traced launches / iters, rounded, at
    least 1), from the profiler's active cycle after a warm-up cycle of
    ``iters`` calls.  Late in a long process a trace keeps fewer device events
    than there were launches, and ``device_ms``'s sum then reads low.  None
    if no device event was traced.  Where ``per_call`` is given, its
    ``"launches"`` gets the kernel launches a call read from the same trace
    (the sum of those per-kernel counts; 0 if none was traced)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
    evs = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA and ev.count]
    a_call = [max(1, round(ev.count / iters)) for ev in evs]
    if per_call is not None:
        per_call["launches"] = sum(a_call)
    if not evs:
        log("device_mean_ms: the trace kept no device event")
        return None
    return sum(ev.self_device_time_total / ev.count * n for ev, n in zip(evs, a_call)) / 1e3


TIMERS = (("ms", time_ms), ("b2b_ms", b2b_ms), ("device_ms", device_ms),
          ("device_mean_ms", device_mean_ms))
TURNS = 20


def timings(kern, plain, libraries: dict, per_call: dict | None = None) -> dict:
    """A kernel line's times: for the kernel and each library call
    (``libraries``, {label: call}: single PyTorch calls that compute the
    same function; may be empty) ``ms`` (``time_ms``), ``b2b_ms``,
    ``device_ms`` and ``device_mean_ms``; for the plain version, timed
    between them, ``plain_ms`` only (its other timers went to keep the script
    inside its time limit when the olmoe phase came).  With
    several library calls each is kept under ``library_<label>_*`` and the
    line's ``library_*`` is the one fastest in a single call; ``library_call``
    names the call taken where it has a label other than "call".  Then ``turns_ms`` and ``library_turns_ms``: the
    kernel's and that library call's single calls timed in ``TURNS``
    alternating pairs (``time_ms_turns``).  ``per_call``, where given, gets
    the kernel's launches a call from its ``device_mean_ms`` trace."""
    t = {}
    for who, fn in (("", kern), ("plain_", plain),
                    *((f"library_{label}_", f) for label, f in libraries.items())):
        for how, timer in TIMERS[:1] if who == "plain_" else TIMERS:
            kw = dict(per_call=per_call) if who == "" and timer is device_mean_ms else {}
            t[who + how] = timer(fn, **kw)
    best = min(libraries, key=lambda label: t[f"library_{label}_ms"]) if libraries else None
    for how, _ in TIMERS:
        key = f"library_{best}_{how}"
        t["library_" + how] = (t.pop(key) if len(libraries) == 1 else t[key]) if best else None
    if best not in (None, "call"):
        t["library_call"] = best
    t["turns_ms"], t["library_turns_ms"] = time_ms_turns(
        kern, libraries[best] if best else None, iters=TURNS)
    return t


def fmt_times(t: dict) -> str:
    return " ".join(f"{k}={v if v is None or isinstance(v, str) else round(v, 4)}"
                    for k, v in t.items())


def hop_entry(launches: dict, name, variant, kern, plain, library, nbytes, flops,
              shape=None, launches_a_call: int | None = None) -> dict:
    """One B1-B4 line: the kernel held to its plain version, timed by
    ``timings`` (``library``: one call or None), beside its bound.  Where
    ``launches_a_call`` is given, the kernel launches a call that its
    ``device_mean_ms`` trace counted (traced again, up to three times, while
    the profiler keeps no device event) are kept as
    ``kernel_launches_a_call`` and must equal it."""
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
    per_call = {} if launches_a_call is not None else None
    times = timings(kern, plain, {} if library is None else {"call": library}, per_call)
    if per_call is not None:
        for _ in range(3):        # a trace that kept no device event is no reading
            if per_call["launches"]:
                break
            times["device_mean_ms"] = device_mean_ms(kern, per_call=per_call)
        if per_call["launches"] != launches_a_call:
            raise AssertionError(f"kernel {name}[{variant}]: the trace counted "
                                 f"{per_call['launches']} kernel launches a call, not "
                                 f"{launches_a_call}")
        shape = dict(shape or {}, kernel_launches_a_call=per_call["launches"])
    b_ms, b_by = bound(nbytes, flops)
    e = dict(name=f"{name}[{variant}]", route="cuda", source=SOURCE[name],
             replaces=REPLACES[name], launches=launches[name],
             max_abs_err=err["max_abs_err"], **times, bound_ms=b_ms, bound_by=b_by,
             n_ge_2_24=err["n_ge_2_24"], bytes=nbytes, flops=flops, shape=shape)
    log(f"kernels: {e['name']:34s} {fmt_times(times)}"
        f" bound_ms={b_ms:.4f} ({b_by}) max_abs_err={err['max_abs_err']} "
        f"n>=2^24={err['n_ge_2_24']} launches={launches[name]}"
        + "".join(f" {k}={v}" for k, v in (shape or {}).items()))
    torch.cuda.empty_cache()
    return e


def hop_kernel_lines(inputs: dict, launches: dict, tag: str = "",
                     extra: dict = None) -> list:
    """B1-B3 lines on captured calls (``Recorder.inputs``), each held to its
    plain version and timed.  ``tag`` prefixes each variant and ``extra``
    joins each line's shape (the partitioned executor's calls: its workers
    and the share of pad slots that the flattened CSR leaves out)."""
    from repro_torch.kernels import hop_scatter as HK

    entries = []
    entry = lambda *a, **kw: entries.append(hop_entry(launches, *a, **kw))
    f32 = 4

    def csr_shape(Qn, ptr, E, w):
        """The call's query count, CSR size, largest arrival degree and
        whether its weights are shared across queries (query stride 0)."""
        V = ptr.numel() - 1
        deg = int((ptr[1:] - ptr[:-1]).max()) if V else 0
        return dict(Q=Qn, V=V, E=E, w_shared=Qn > 1 and w.stride(0) == 0, max_deg=deg)

    extra = extra or {}
    for key in sorted(inputs, key=str):
        name, a, kw = inputs[key]
        mch = kw.get("mch")
        kern_fn = lambda name=name, a=a, kw=kw: getattr(HK, name)(*a, **kw)
        plain_fn = lambda name=name, a=a, kw=kw: getattr(HK, name + "_plain")(*a, **kw)
        if name == "fused_hop_cols":
            state, src, w, ptr = a
            Qn, N, C = state.shape
            E, V = src.numel(), ptr.numel() - 1
            U = _unique_rows(src, N, (w != 0).any(dim=2).any(dim=0))
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
            elif mch is None:
                # per-column weights: one sparse matrix a column (and query,
                # where the weights are per query), so one batched product,
                # torch.bmm of a [qw·C, V, N] sparse COO batch, computes the hop
                keep = src < N
                rows = HK.segment_ids(ptr, E)[keep]
                cols = src[keep].long()
                nb, nk = qw * C, rows.numel()
                idx = torch.stack([torch.arange(nb, device=src.device).repeat_interleave(nk),
                                   rows.repeat(nb), cols.repeat(nb)])
                vals = w[:qw, keep, :].permute(0, 2, 1).reshape(-1)
                A = torch.sparse_coo_tensor(idx, vals, (nb, V, N)).coalesce()
                del idx, vals, rows, cols, keep
                if qw == 1:                       # [C, N, Q]: the queries as columns
                    X = state.permute(2, 1, 0).contiguous()
                    back = lambda y: y.permute(2, 1, 0)
                else:                             # [Q·C, N, 1]
                    X = state.permute(0, 2, 1).reshape(nb, N, 1).contiguous()
                    back = lambda y, Qn=Qn, C=C, V=V: y.reshape(Qn, C, V).permute(0, 2, 1)
                library = lambda A=A, X=X: torch.bmm(A, X)
                compare(back(library()), HK.fused_hop_cols(*a, **kw)[0],
                        "library bmm vs fused_hop_cols")
            variant = tag + f"C={C}" + (",extremum" if mch is not None else "")
            vec = HK.cols_vector_width(C, mch is not None, (state, HK.query_stride(state, "state")),
                                       (w, HK.query_stride(w, "w")))
            entry(name, variant, kern_fn, plain_fn, library, nbytes, 2.0 * Qn * E * C,
                  dict(csr_shape(Qn, ptr, E, w), C=C, G=HK.lane_group(E, V, C // vec),
                       **extra))
        elif name == "fused_hop_interval":
            state, src, w, sb, eb, ptr = a
            Qn, N, B, Bp1 = state.shape
            NC = B * Bp1
            E, V = src.numel(), ptr.numel() - 1
            U = _unique_rows(src, N, (w != 0).any(dim=0))
            qw = 1 if (Qn == 1 or w.stride(0) == 0) else Qn
            active = int(((w != 0) & (src < N)[None]).sum())
            nbytes = f32 * (V + 1 + E + 3 * qw * E + Qn * U * NC + Qn * V * NC)
            if mch is not None:
                nbytes += f32 * (Qn * U + Qn * V)
            variant = tag + f"B={B}" + (",extremum" if mch is not None else "")
            entry(name, variant, kern_fn, plain_fn, None, nbytes, 4.0 * active * NC,
                  dict(csr_shape(Qn, ptr, E, w), B=B,
                       lanes=HK.WARP if B + 1 <= HK.WARP else "block", **extra))
        else:
            contrib, ptr = a
            Qn, E = contrib.shape[:2]
            C = contrib[0, 0].numel()
            V = ptr.numel() - 1
            seg = HK.segment_ids(ptr, E)
            out0 = contrib.new_zeros((Qn, V) + tuple(contrib.shape[2:]))
            library = lambda: out0.clone().index_add_(1, seg, contrib)
            nbytes = f32 * (V + 1 + Qn * E * C + Qn * V * C)
            vec = HK.vector_width(C, (contrib, HK.query_stride(contrib, "contrib")))
            entry(name, tag + f"C={C}", lambda f=kern_fn: (f(), None),
                  lambda f=plain_fn: (f(), None), library, nbytes, 1.0 * Qn * E * C,
                  dict(csr_shape(Qn, ptr, E, contrib), C=C, G=HK.lane_group(E, V, C // vec),
                       **extra))
    return entries


def b4_operands(Qn: int, ptr, arr_ptr) -> dict:
    """B4's operands, which no engine path gives it, on two CSRs: ``sliced``,
    ``ptr`` of the largest main-path ETR delivery (static, C = 1; Q = ``Qn``);
    ``dense``, the graph's global arrival CSR ``arr_ptr`` (the dense agg-min
    hop's).  On each, made on the card from seed 0: m_e [Qn, E] integers 1 ..
    499 and an alive gate that marks half the edges.  (The delivery's own
    counts would give an all-dead gate there, which leaves the selection
    untested.)"""
    out = {}
    for tag, p in (("sliced", ptr), ("dense", arr_ptr)):
        E = int(p[-1])
        gen = torch.Generator(device=p.device).manual_seed(0)
        m_e = torch.randint(1, 500, (Qn, E), generator=gen, device=p.device).float()
        alive = (torch.rand((Qn, E), generator=gen, device=p.device) < 0.5).float()
        out[tag] = (m_e, alive, p)
    return out


def b4_entries(operands: dict, launches: dict) -> list:
    """B4 lines, min and max on each of ``b4_operands``: the kernel
    ``torch.equal`` to its plain version, timed by ``hop_entry`` beside
    ``scatter_reduce_``, and its two kernel launches a call (the seed kernel
    and the tiles) counted from its trace.  Named ``scatter_extremum[min]`` /
    ``[max]`` on the sliced operands and ``[dense,min]`` / ``[dense,max]`` on
    the dense ones."""
    from repro_torch.kernels import hop_scatter as HK

    entries = []
    for tag, (m_e, alive, ptr) in operands.items():
        Qn, E = m_e.shape
        V = ptr.numel() - 1
        deg = ptr[1:] - ptr[:-1]
        seg = HK.segment_ids(ptr, E).expand(Qn, E)
        vec = HK.vector_width(HK.VEC, (m_e, HK.query_stride(m_e, "m_e")),
                              (alive, HK.query_stride(alive, "alive")))
        shape = dict(Q=Qn, V=V, E=E, max_deg=int(deg.max()), empty_runs=int((deg == 0).sum()),
                     alive_share=float(alive.mean()), vec=vec, tiles=HK.extremum_tiles(E))
        for op_is_min in (True, False):
            neutral = float("inf") if op_is_min else float("-inf")
            kern = lambda m=m_e, a=alive, p=ptr, op=op_is_min, n=neutral: (
                HK.scatter_extremum(m, a, p, n, op), None)
            plain = lambda m=m_e, a=alive, p=ptr, op=op_is_min, n=neutral: (
                HK.scatter_extremum_plain(m, a, p, n, op), None)
            variant = ("" if tag == "sliced" else tag + ",") + ("min" if op_is_min else "max")
            identical(kern()[0], plain()[0], f"kernel scatter_extremum[{variant}]")
            gated = torch.where(alive > 0, m_e, torch.full_like(m_e, neutral))
            out0 = torch.full((Qn, V), neutral, device=m_e.device)
            red = "amin" if op_is_min else "amax"
            library = lambda out0=out0, gated=gated, seg=seg, red=red: out0.clone().scatter_reduce_(
                1, seg, gated, red, include_self=True)
            entries.append(hop_entry(launches, "scatter_extremum", variant, kern, plain, library,
                                     4.0 * (V + 1 + 2 * Qn * E + Qn * V), 1.0 * Qn * E,
                                     dict(shape, torch_equal=True), launches_a_call=2))
            del gated, out0, library
        del seg
    return entries


def phase_kernels(recorder: Recorder, launches: dict, graph) -> list:
    entries = hop_kernel_lines(recorder.inputs, launches)
    # B4 on the CSR of the largest main-path ETR delivery (static, C = 1)
    # and on the graph's global arrival CSR
    contrib, ptr = recorder.inputs[("scatter_cols", 1, False)][1]
    entries += b4_entries(b4_operands(contrib.shape[0], ptr,
                                      graph.device_arrays("cuda")["arr_ptr"]), launches)
    return entries


def warp_entries(graph, jobs) -> list:
    """B6 through its entry point (no path of either package reaches it) on
    the main graph's operands: every vertex's lifespan, the graph's bucket
    edges and the per-vertex bucket state of a main-path query (the first
    query of the first bucket-mode job with an aggregate, whose output keeps
    that state), in float32 and cast to bfloat16 (16-byte chunks of 4 and
    of 8 values).  Each held equal to its plain version."""
    from repro_torch.core import engine as E
    from repro_torch.core import query as Q
    from repro_torch.kernels import interval_warp as IW

    dev = torch.device("cuda")
    job = next(j for j in jobs if j[1] == E.MODE_BUCKET and j[3][0].agg_op != Q.AGG_NONE)
    out = run_job(graph, job)
    counts = out.per_vertex[0].contiguous()
    del out
    V = graph.n_vertices
    ivl = torch.from_numpy(graph.v_life).to(dev)
    bedges = E.bucket_edges_for(graph, WARP_BUCKETS, dev).to(torch.int32)
    if tuple(counts.shape) != (V, WARP_BUCKETS):
        raise AssertionError(f"kernels: bucket state {tuple(counts.shape)} != {(V, WARP_BUCKETS)}")
    # the overlap mask, built once: the library call is the product alone,
    # a lower bound for any PyTorch form (none computes the mask in one call)
    mask = (ivl[:, 0:1] < bedges[1:][None, :]) & (bedges[:-1][None, :] < ivl[:, 1:2])
    entries = []
    for dtype, tag in ((torch.float32, ""), (torch.bfloat16, ",bf16")):
        c = counts.to(dtype)
        maskd = mask.to(dtype)
        IW.reset_launches()           # its entry point, called once
        got = IW.interval_warp(c, ivl, bedges)
        torch.cuda.synchronize()
        launches = IW.LAUNCHES["interval_warp"]
        identical(got, IW.interval_warp_plain(c, ivl, bedges), f"kernel interval_warp{tag}")
        kept = int((got != 0).sum())
        del got
        n = c.numel()
        e = model_entry("interval_warp", f"B={WARP_BUCKETS},V={V}{tag}",
                        lambda c=c: IW.interval_warp(c, ivl, bedges),
                        lambda c=c: IW.interval_warp_plain(c, ivl, bedges),
                        {"torch.mul(counts, mask), the mask precomputed":
                         lambda c=c, m=maskd: torch.mul(c, m)},
                        2.0 * n * c.element_size() + 4.0 * (2 * V + WARP_BUCKETS + 1), 3.0 * n,
                        F32_FLOP_PER_S, 0.0, 0.0, launches)
        e.update(template=job[0], nonzero_in=int((c != 0).sum()), nonzero_out=kept)
        log(f"kernels: interval_warp{tag} on {job[0]}'s bucket state: {e['nonzero_in']} "
            f"non-zero counts in, {kept} out; equal to the plain version (NaN and signs of "
            f"zero included)")
        entries.append(e)
        del maskd
    return entries


# =========================================================================
# the partitioned executor on the main graph
# =========================================================================
PART_WORKERS = (4, 8)
PART_REPEATS = 1              # timed calls a job (median; 3 at W = 4 until the olmoe phase came)
PART_PROFILED = ("Q4", "agg-min-2hop")
HOP_KERNELS = ("fused_hop_cols", "fused_hop_interval", "scatter_cols")


def expected_launches(qry, split: int, mode: int) -> dict:
    """Launches of one kernel-lowered partitioned call: one per hop of each
    segment (the left one runs e_preds[:split], the right one the reversed
    query's first n - 1 - split hops, whose ETR ops shift by one), B3 on an
    ETR hop, else B1 (B2 in interval mode)."""
    plain = "fused_hop_interval" if mode == 2 else "fused_hop_cols"
    out = dict.fromkeys(HOP_KERNELS, 0)
    n = qry.n_vertices
    for ep in qry.e_preds[:split] + qry.reversed().e_preds[:n - 1 - split]:
        out["scatter_cols" if ep.etr_op != -1 else plain] += 1
    return out


def partition_setup(graph, W: int) -> dict:
    """Partition, build the tables, upload them; their sizes and seconds."""
    from repro_torch.core import engine_partitioned as EP

    t0 = time.perf_counter()
    part, arrays = EP.partition_for(graph, W)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, pdev = EP.device_tables(graph, W, device="cuda")
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    lay = pdev["layout"]
    st = arrays.stats
    info = dict(W=W, parts_per_type=st["parts_per_type"],
                partition_s=arrays.setup_s["partition"], tables_s=arrays.setup_s["tables"],
                host_s=host_s, upload_s=upload_s, v_max=arrays.v_max, e_max=arrays.e_max,
                h_max=arrays.h_max, s_max=arrays.s_max, edge_cut=st["edge_cut"],
                size_imbalance=st["size_imbalance"], edge_imbalance=st["edge_imbalance"],
                state_exchange=arrays.exchange_volume(),
                etr_exchange=arrays.etr_exchange_volume(), c_max=st["p2p_lane_width"],
                etr_c_max=st["p2p_etr_lane_width"], pad_slots=lay.n_pad,
                pad_share=lay.n_pad / (lay.n_pad + lay.n_real))
    log(f"partitioned: W={W} partition {info['partition_s']:.1f}s tables "
        f"{info['tables_s']:.1f}s upload {upload_s:.1f}s; v_max {arrays.v_max} e_max "
        f"{arrays.e_max} h_max {arrays.h_max} s_max {arrays.s_max}; edge cut "
        f"{st['edge_cut']:.4f} size imbalance {st['size_imbalance']:.4f}; exchange "
        f"state {info['state_exchange']} etr {info['etr_exchange']} (lanes {info['c_max']} / "
        f"{info['etr_c_max']}); pad slots {lay.n_pad} ({info['pad_share']:.4f}) left out")
    return info


def part_job(graph, job, W: int, impl: str = "cuda"):
    from repro_torch.core import engine_partitioned as EP

    _, mode, split, batch = job
    return EP.execute_batch_out(graph, batch, split=split, mode=mode, n_buckets=16,
                                n_workers=W, impl=impl, device="cuda")


def phase_partitioned(graph, jobs, main_rows) -> tuple:
    """The partitioned executor (``core/engine_partitioned.py``) at W = 4
    and 8 on the main graph: every main-path job through
    ``execute_batch_out(impl='cuda')``, latency (median of ``PART_REPEATS``
    CUDA-event timings) beside the main phase's, peak and resident memory,
    answers held to the main path's impl='cuda' (and at W = 4 to the
    partitioned impl='torch'), B1-B3 launched exactly once per kernel-lowered
    hop; then, at W = 4, ``measure_supersteps``, and the B1-B3 kernel lines
    of each W.
    Returns (report, kernel lines)."""
    from repro_torch.core import engine_partitioned as EP
    from repro_torch.kernels import hop_scatter as HK

    t_phase = time.perf_counter()
    main_ms = {(r["template"], r["mode"], r["split"]): r["cuda_ms"] for r in main_rows}
    info = dict(workers={})
    lines = []
    for W in PART_WORKERS:
        setup = partition_setup(graph, W)
        rows = []
        launches = dict.fromkeys(HK.LAUNCHES, 0)
        rec = Recorder(HK)
        for j, job in enumerate(jobs):
            t, mode, split, batch = job
            mname = ["static", "bucket", "interval"][mode]
            want_l = expected_launches(batch[0], split, mode)

            def counted(fn):
                before = dict(HK.LAUNCHES)
                r = fn()
                for k in launches:
                    launches[k] += HK.LAUNCHES[k] - before[k]
                return {k: HK.LAUNCHES[k] - before[k] for k in HK.LAUNCHES}

            rec.job = j
            with rec:
                counted(lambda: part_job(graph, job, W))            # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            times, per_call = [], []
            for _ in range(PART_REPEATS):
                out = None
                ev0, ev1 = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
                box = {}

                def timed():
                    ev0.record()
                    box["out"] = part_job(graph, job, W)
                    ev1.record()
                per_call.append(counted(timed))
                torch.cuda.synchronize()
                times.append(ev0.elapsed_time(ev1))
                out = box.pop("out")
            peak = torch.cuda.max_memory_allocated()
            for pc in per_call:
                if {k: pc[k] for k in HOP_KERNELS} != want_l:
                    raise AssertionError(f"partitioned W={W} {t} {mname} split {split}: "
                                         f"launches {pc} != one per hop {want_l}")
            errs = {}
            ref = run_job(graph, job)                 # the main path, impl='cuda'
            refs = [("main", ref)]
            if W == PART_WORKERS[0]:
                refs.append(("torch", part_job(graph, job, W, impl="torch")))
            for tag, r in refs:
                for field in ("total", "per_vertex", "minmax"):
                    a, b = getattr(out, field), getattr(r, field)
                    if a is None and b is None:
                        continue
                    if a is None or b is None:
                        raise AssertionError(f"partitioned {t}: {field} missing on one side")
                    e = compare(a, b, f"partitioned W={W} {t} {mname} split {split} "
                                      f"{field} vs {tag}")
                    errs[f"{tag}_{field}"] = e
            del ref, refs, out
            row = dict(template=t, mode=mname, split=split, batch=len(batch),
                       ms=float(np.median(times)), times_ms=times,
                       main_ms=main_ms.get((t, mname, split)), peak_bytes=peak,
                       resident_bytes=base, launches_per_call=want_l, errors=errs)
            rows.append(row)
            log(f"partitioned: W={W} {t:13s} {mname:8s} split={split} Q={len(batch)} "
                f"ms={row['ms']:.3f} main_ms={row['main_ms']} peak_GiB="
                f"{peak / 2**30:.3f} resident_GiB={base / 2**30:.3f} launches/call="
                f"{want_l} n>=2^24={sum(e['n_ge_2_24'] for e in errs.values())}")
        missing = [k for k in HOP_KERNELS if launches[k] == 0]
        if missing:
            raise AssertionError(f"partitioned W={W}: never launched {missing}")
        log(f"partitioned: W={W} launches over the path: {launches}")
        prof = {}
        for name in PART_PROFILED if W == PART_WORKERS[0] else ():
            job = next(jb for jb in jobs if jb[0] == name and jb[1] == 0)
            p = EP.measure_supersteps(graph, job[3][0], n_workers=W, mode=0, repeats=3,
                                      device="cuda")
            prof[name] = dict(makespan_ms=(p.makespan_s * 1e3).tolist(),
                              per_worker_ms=(p.times_s * 1e3).tolist(),
                              balance_eff=p.balance_eff, channels=p.channel_totals(),
                              total=p.total)
            log(f"partitioned: W={W} measure_supersteps {name} static: makespan_ms "
                f"{[round(x, 4) for x in prof[name]['makespan_ms']]} balance_eff "
                f"{p.balance_eff:.4f} channels {p.channel_totals()}")
        traces = []
        if W == PART_WORKERS[0]:    # where the time goes, on the main path's profiled jobs
            for job in jobs:
                t, mode, split, batch = job
                if t in PROFILED and split == (0 if batch[0].agg_op != -1
                                               else batch[0].n_vertices - 1):
                    tr = dict(template=t, mode=["static", "bucket", "interval"][mode],
                              split=split, batch=len(batch),
                              **traced(lambda: part_job(graph, job, W)))
                    traces.append(tr)
                    log_trace(f"profile: partitioned W={W} {t} {tr['mode']} split={split} "
                              f"Q={len(batch)}", tr)
        info["workers"][W] = dict(setup=setup, rows=rows, launches=launches,
                                  supersteps=prof, traces=traces)
        rec.capture(lambda j: part_job(graph, jobs[j], W))
        lines += hop_kernel_lines(rec.inputs, launches, tag=f"W={W},",
                                  extra=dict(W=W, pad_slots=setup["pad_slots"],
                                             pad_share=setup["pad_share"]))
        rec.inputs.clear()
        del rec
        graph.__dict__.pop("_partition_dev_cache", None)
        free_memory()
    info["wall_s"] = time.perf_counter() - t_phase
    log(f"partitioned: phase {info['wall_s']:.1f}s")
    return info, lines


# =========================================================================
# the query server: serving/ and launch/query.py on the main graph
# =========================================================================
SERVE_RATE_QPS = 50.0         # the CLI's default --rate
SERVE_CLI = ["--persons", "1000", "--dynamic", "--queries", "2", "--serve", "--verify"]
SERVE_WORKERS = 4             # the partitioned drains' workers (the CLI's default)


def _pct(xs, q) -> float:
    return float(np.percentile(xs, q)) if len(xs) else 0.0


def check_served(res, what: str) -> None:
    bad = [(i, r.template, r.status, r.error) for i, r in enumerate(res)
           if r.status != "done" or r.error]
    if bad:
        raise AssertionError(f"serve {what}: {len(bad)} queries not done, first {bad[0]}")


def timed_flush(sched, wl, what: str) -> dict:
    """One steady-state flush (every plan and executable cached, so no
    untimed first call): wall ms beside the sum of the dispatches' ms (the
    difference is the runtime's own host time), per-query served latency,
    queries/s, peak beside resident memory, and one line per group."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = sched.run(wl, warm=True)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    check_served(res, what)
    disp = sched.last_dispatches
    if any(not d.exec_cached for d in disp):
        raise AssertionError(f"serve {what}: a steady flush rebuilt an executable")
    groups = []
    for d in disp:
        qs = [wl[i].qry for i in d.indices]
        planner = sched._planner_for(d.engine)
        pred = planner.estimate_batch(qs, d.split, d.impl).t_ms
        pred += d.n_pad * planner.estimate(qs[0], d.split, d.impl).t_ms
        grp = dict(template=wl[d.indices[0]].template, engine=d.engine, split=d.split,
                   impl=d.impl, batch=d.n_real, n_pad=d.n_pad, predicted_ms=pred,
                   dispatch_ms=d.service_s * 1e3, event_ms=d.event_ms)
        groups.append(grp)
        log(f"serve: {what:6s} {grp['template']:7s} {d.engine:6s} split={d.split} "
            f"impl={d.impl} batch={d.n_real} predicted_ms={pred:.3f} "
            f"event_ms={d.event_ms:.3f} dispatch_ms={grp['dispatch_ms']:.3f}")
    lat = [r.latency_ms for r in res]
    out = dict(n_queries=len(res), n_groups=len(disp), wall_ms=wall_ms,
               dispatch_sum_ms=sum(g["dispatch_ms"] for g in groups),
               event_sum_ms=sum(g["event_ms"] for g in groups),
               latency_ms_p50=_pct(lat, 50), latency_ms_p95=_pct(lat, 95),
               latency_ms_p99=_pct(lat, 99), qps=len(res) / (wall_ms / 1e3),
               peak_bytes=peak, resident_bytes=resident, groups=groups,
               counts=[r.count for r in res])
    out["host_ms"] = out["wall_ms"] - out["dispatch_sum_ms"]
    log(f"serve: {what} flush of {len(res)} queries in {len(disp)} groups: wall_ms="
        f"{wall_ms:.3f} dispatch_sum_ms={out['dispatch_sum_ms']:.3f} (CUDA events "
        f"{out['event_sum_ms']:.3f}) host_ms={out['host_ms']:.3f} qps={out['qps']:.1f} "
        f"latency_ms p50={out['latency_ms_p50']:.3f} p95={out['latency_ms_p95']:.3f} "
        f"p99={out['latency_ms_p99']:.3f} peak_GiB={peak / 2**30:.3f} "
        f"resident_GiB={resident / 2**30:.3f}")
    return out


def check_groups(graph, sched, wl, counts, what: str, keep: list | None = None,
                 ref_chunk: int | None = None, reference: bool = True) -> dict:
    """Serve ``wl`` once more with the outputs kept, and hold every group's
    answer against ``execute_batch_out`` at the group's split on the plain
    lowering, on the card (bit-equal below 2^24, rtol 1e-6 at or above,
    counted); the counts must equal the timed flush's.  ``keep`` receives
    the served results; ``ref_chunk`` runs the plain lowering on that many
    of a group's queries at a time (its per-edge state is Q times the
    graph's).  ``reference=False`` leaves out the plain lowering (the
    flush and its counts are still checked)."""
    from repro_torch.core import engine as E

    sched.keep_outputs = True
    res = sched.run(wl, warm=True)
    sched.keep_outputs = False
    check_served(res, what)
    if keep is not None:
        keep.extend(res)
    if [r.count for r in res] != counts:
        raise AssertionError(f"serve {what}: counts moved between two flushes")
    errs = dict(max_abs_err=0.0, n_ge_2_24=0, n_groups=0)
    if not reference:
        return errs
    for d in sched.last_dispatches:
        step = ref_chunk or len(d.indices)
        for lo in range(0, len(d.indices), step):
            idx = d.indices[lo:lo + step]
            qs = [wl[i].qry for i in idx]
            ref = E.execute_batch_out(graph, qs, split=d.split, mode=sched._mode_for(qs[0]),
                                      n_buckets=sched.n_buckets, sliced=d.engine == "sliced",
                                      impl="torch", device="cuda")
            for f in ("total", "per_vertex", "minmax"):
                want = getattr(ref, f)
                got = [getattr(res[i], f) for i in idx]
                if want is None and all(g is None for g in got):
                    continue
                if want is None or any(g is None for g in got):
                    raise AssertionError(f"serve {what} {qs[0]}: {f} missing on one side")
                got = torch.from_numpy(np.stack(got)).cuda()
                e = compare(got, want, f"serve {what} {wl[idx[0]].template} {f}")
                errs["max_abs_err"] = max(errs["max_abs_err"], e["max_abs_err"])
                errs["n_ge_2_24"] += e["n_ge_2_24"]
                del got
            del ref
        errs["n_groups"] += 1
    free_memory()
    log(f"serve: {what}: {errs['n_groups']} groups equal impl='torch' at their splits "
        f"(max_abs_err {errs['max_abs_err']}, {errs['n_ge_2_24']} entries >= 2^24)")
    return errs


def check_drains(sched, ref_sched, wl, what: str) -> dict:
    """Serve ``wl`` on both schedulers with the outputs kept and hold every
    query's total, per-vertex state and extremum of ``sched`` to
    ``ref_sched``'s (bit-equal below 2^24, rtol 1e-6 at or above, counted)."""
    errs = dict(max_abs_err=0.0, n_ge_2_24=0, n_queries=0)
    outs = []
    for sc in (sched, ref_sched):
        sc.keep_outputs = True
        res = sc.run(wl, warm=True)
        sc.keep_outputs = False
        check_served(res, what)
        outs.append(res)
    for i, (a, b) in enumerate(zip(*outs)):
        for f in ("total", "per_vertex", "minmax"):
            x, y = getattr(a, f), getattr(b, f)
            if x is None and y is None:
                continue
            if x is None or y is None:
                raise AssertionError(f"serve {what} query {i}: {f} missing on one side")
            e = compare(torch.from_numpy(np.asarray(x)), torch.from_numpy(np.asarray(y)),
                        f"serve {what} {wl[i].template} {f}")
            errs["max_abs_err"] = max(errs["max_abs_err"], e["max_abs_err"])
            errs["n_ge_2_24"] += e["n_ge_2_24"]
        errs["n_queries"] += 1
    del outs
    free_memory()
    log(f"serve: {what}: {errs['n_queries']} queries equal the {ref_sched.engine} drain's "
        f"(max_abs_err {errs['max_abs_err']}, {errs['n_ge_2_24']} entries >= 2^24)")
    return errs


def serve_workload(graph) -> list:
    """The serve phase's workload: Q1-Q8 (N_BATCH instances each, seed
    SEED) and the MIN variants of the ETR-free template."""
    from repro_torch.graphdata.queries import make_workload, to_minmax

    wl = make_workload(graph, n_per_template=N_BATCH, seed=SEED)
    return wl + [to_minmax(i, graph) for i in wl
                 if all(e.etr_op == -1 for e in i.qry.e_preds)]


def phase_serve(graph, served: dict) -> dict:
    """The query server at full size on the main graph: the bucket drain
    ``--serve`` runs (``GraniteServer.run_workload_scheduled``, flight
    recorder and metrics attached), a static drain (``BatchScheduler`` in
    static mode) with one traced flush, and the open-loop replay of
    ``--replay``, all on the kernels (``impl='cuda'``); then the CLI itself
    on a small graph.  ``served`` receives the bucket and static drains'
    answers (the live phase holds its last epoch to them)."""
    from repro_torch.core import engine as E
    from repro_torch.kernels import hop_scatter as HK
    from repro_torch.launch.query import GraniteServer
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.serving import BatchScheduler, replay_workload

    t_phase = time.perf_counter()
    wl = serve_workload(graph)
    info = dict(n_queries=len(wl), templates=sorted({i.template for i in wl}))
    HK.reset_launches()           # counts are 0 just before the drains

    # ---- bucket drain: what --serve runs on a dynamic graph
    tracer, metrics = Tracer(capacity=1 << 20), MetricsRegistry()
    t0 = time.perf_counter()
    server = GraniteServer(graph)
    res = server.run_workload_scheduled(wl, engine="auto", warm=True, tracer=tracer,
                                        metrics=metrics)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    check_served(res, "bucket")
    sched = server.scheduler
    if sched.impl != "cuda" or sched.mode != E.MODE_BUCKET:
        raise AssertionError(f"serve: --serve ran impl={sched.impl} mode={sched.mode}")
    bucket = timed_flush(sched, wl, "bucket")
    bucket.update(cold_ms=cold_ms, caches=sched.cache_report(),
                  spans=tracer.n_completed,
                  dispatch_ms_hist=metrics.snapshot()["granite_dispatch_ms"])
    log(f"serve: bucket first flush (stats, plans, first calls) {cold_ms:.1f} ms; caches "
        f"{bucket['caches']}; {tracer.n_completed} spans recorded")
    bucket["launches"] = dict(HK.LAUNCHES)
    bucket["check"] = check_groups(graph, sched, wl, bucket["counts"], "bucket",
                                   keep=served.setdefault("bucket", []))
    del server, sched, tracer, res
    free_memory()

    # ---- static drain: the host share of short dispatches
    mark = dict(HK.LAUNCHES)
    sst = BatchScheduler(graph, mode=E.MODE_STATIC, engine="auto")
    check_served(sst.run(wl, warm=True), "static")
    static = timed_flush(sst, wl, "static")
    static["caches"] = sst.cache_report()
    log(f"serve: static caches {static['caches']}")
    static["trace"] = traced(lambda: check_served(sst.run(wl), "static traced"))
    log_trace("profile: serve static flush", static["trace"])
    static["launches"] = {k: HK.LAUNCHES[k] - mark[k] for k in HK.LAUNCHES}
    static["check"] = check_groups(graph, sst, wl, static["counts"], "static",
                                   keep=served.setdefault("static", []))
    del sst
    free_memory()

    # ---- the partitioned engine: bucket and static drains, held to the
    # sliced/dense drain of the same mode query by query
    partitioned = {}
    for mname, mode in (("bucket", E.MODE_BUCKET), ("static", E.MODE_STATIC)):
        mark = dict(HK.LAUNCHES)
        ps = BatchScheduler(graph, engine="partitioned", n_workers=SERVE_WORKERS, mode=mode)
        check_served(ps.run(wl, warm=True), f"partitioned {mname}")
        d = timed_flush(ps, wl, f"p-{mname}")
        d["caches"] = ps.cache_report()
        d["launches"] = {k: HK.LAUNCHES[k] - mark[k] for k in HK.LAUNCHES}
        d["check"] = check_drains(ps, BatchScheduler(graph, engine="auto", mode=mode), wl,
                                  f"partitioned {mname}")
        d.pop("counts")
        partitioned[mname] = d
        del ps
        graph.__dict__.pop("_partition_dev_cache", None)
        free_memory()

    # ---- open-loop replay at the CLI's default rate
    mark = dict(HK.LAUNCHES)
    rsched = BatchScheduler(graph)
    rep = replay_workload(rsched, wl, rate_qps=SERVE_RATE_QPS, seed=SEED, warm=True)
    torch.cuda.synchronize()
    replay = rep.as_dict()
    if rep.n_completed != len(wl) or rep.failures:
        raise AssertionError(f"serve replay: {rep.n_completed}/{len(wl)} done, "
                             f"failures {rep.failures[:1]}")
    replay["launches"] = {k: HK.LAUNCHES[k] - mark[k] for k in HK.LAUNCHES}
    log("serve: replay " + json.dumps(replay))
    del rsched
    free_memory()

    launches = dict(HK.LAUNCHES)  # read just after the drains
    missing = [k for k in ("fused_hop_cols", "scatter_cols") if launches[k] == 0
               or any(partitioned[m]["launches"][k] == 0 for m in partitioned)]
    if missing:
        raise AssertionError(f"serve: the drains never launched {missing}")
    log(f"serve: launches over the drains and their check flushes: {launches} (bucket "
        f"{bucket['launches']}, static {static['launches']}, replay {replay['launches']})")

    # ---- the CLI a user starts, on a small graph, on each engine choice; the
    # two runs are independent and run side by side
    clis = []
    argvs = (SERVE_CLI, SERVE_CLI + ["--engine", "partitioned"])
    with ThreadPoolExecutor(len(argvs)) as pool:
        runs = list(pool.map(run_cli, argvs))
    for argv, (cli, cli_s) in zip(argvs, runs):
        if cli.returncode != 0 or "verification vs oracle: OK" not in cli.stdout:
            raise AssertionError(f"serve: the CLI failed (rc {cli.returncode}): "
                                 f"{cli.stdout[-800:]} {cli.stderr[-1500:]}")
        log(f"serve: python -m repro_torch.launch.query {' '.join(argv)}: rc 0, "
            f"verification vs oracle: OK ({cli_s:.1f}s)")
        clis.append(dict(argv=argv, rc=cli.returncode, seconds=cli_s))
    for d in (bucket, static):
        d.pop("counts")
    info.update(bucket=bucket, static=static, partitioned=partitioned, replay=replay,
                launches=launches, cli=clis, wall_s=time.perf_counter() - t_phase)
    log(f"serve: phase {info['wall_s']:.1f}s")
    return info


# =========================================================================
# live graphs: the event log, epochs and base+delta serving on the main graph
# =========================================================================
LIVE_EPOCHS = 2               # the CLI's --epochs (3 until the train phase came)
LIVE_TORCH_EPOCHS = (1, LIVE_EPOCHS)   # epochs held to impl='torch': every delta epoch
LIVE_WORKERS = 4              # the partition-hint drains' workers
LIVE_WAL = ROOT / "build" / "live.wal"
LIVE_CLI = ["--persons", "1000", "--live", "--wal", str(LIVE_WAL), "--holdout", "64",
            "--epochs", str(LIVE_EPOCHS)]
LIVE_TRACE = ROOT / "build" / "live_trace.jsonl"
PLAN_WITHIN = 0.10            # the audit's plan-accuracy tolerance
ERROR_KEYS = ("n", "mean_abs_rel_err", "p90_abs_rel_err", "tail_mean_abs_rel_err")


def served_answers(sched, wl, what: str) -> list:
    """Serve ``wl`` with the outputs kept: per query (total, per_vertex,
    minmax) on the host."""
    sched.keep_outputs = True
    res = sched.run(wl, warm=True)
    sched.keep_outputs = False
    check_served(res, what)
    return [(r.total, r.per_vertex, r.minmax) for r in res]


def hold_answers(got: list, want: list, wl, what: str) -> dict:
    """Hold two lists of answers query by query (``compare``: bit-equal
    below 2^24, rtol 1e-6 at or above, counted).  An answer is a served
    result or a (total, per_vertex, minmax) tuple."""
    def fields(a):
        return a if isinstance(a, tuple) else (a.total, a.per_vertex, a.minmax)

    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} answers against {len(want)}")
    errs = dict(max_abs_err=0.0, n_ge_2_24=0, n_queries=len(got))
    for i, (a, b) in enumerate(zip(got, want)):
        for f, x, y in zip(("total", "per_vertex", "minmax"), fields(a), fields(b)):
            if x is None and y is None:
                continue
            if x is None or y is None:
                raise AssertionError(f"{what} query {i}: {f} missing on one side")
            e = compare(torch.from_numpy(np.asarray(x)), torch.from_numpy(np.asarray(y)),
                        f"{what} {wl[i].template} {f}")
            errs["max_abs_err"] = max(errs["max_abs_err"], e["max_abs_err"])
            errs["n_ge_2_24"] += e["n_ge_2_24"]
    return errs


def predicted_launches(sched, wl) -> dict:
    """Hop-kernel launches the last flush's dispatches predict: one per hop
    of each segment, B3 on an ETR hop, else B1 (B2 in interval mode); the
    delta's delivery launches none."""
    out = dict.fromkeys(HOP_KERNELS, 0)
    for d in sched.last_dispatches:
        q = wl[d.indices[0]].qry
        for k, v in expected_launches(q, d.split, sched._mode_for(q)).items():
            out[k] += v
    return out


def launches_since(mark: dict) -> dict:
    from repro_torch.kernels import hop_scatter as HK

    return {k: HK.LAUNCHES[k] - mark[k] for k in HOP_KERNELS}


def live_drain(sched, wl, graph, mode: int, what: str, ref_chunk: int | None = None,
               reference: bool = True) -> tuple:
    """One mode's drains at a pinned epoch: a first flush (new executables
    are built and run once untimed), a steady flush timed by
    ``timed_flush`` whose kernel launches must equal the dispatches'
    prediction, and the check flush (``check_groups``: every group equal to
    impl='torch' on the epoch's merged graph).  Returns (report, the check
    flush's results; without ``reference`` the check flush's counts only);
    the report's ``delta`` holds (the group is ETR-free, it ran on the delta
    path) per steady dispatch, ``first`` (delta, the executable was cached)
    per first dispatch."""
    from repro_torch.kernels import hop_scatter as HK

    sched.mode = mode
    check_served(sched.run(wl, warm=True), what)
    first = [(bool(d.delta), bool(d.exec_cached)) for d in sched.last_dispatches]
    mark = dict(HK.LAUNCHES)
    out = timed_flush(sched, wl, what)
    out["launches"] = launches_since(mark)
    pred = predicted_launches(sched, wl)
    if out["launches"] != pred:
        raise AssertionError(f"{what}: launches {out['launches']} != predicted {pred}")
    out["delta"] = [(all(e.etr_op == -1 for e in wl[d.indices[0]].qry.e_preds),
                     bool(d.delta)) for d in sched.last_dispatches]
    out["first"] = first
    res = []
    out["check"] = check_groups(graph, sched, wl, out.pop("counts"), what, keep=res,
                                ref_chunk=ref_chunk, reference=reference)
    return out, res


def delta_cost(sched, wl, mode: int) -> dict:
    """The delta path's own cost: each delta group of the last flush timed
    (``time_ms``: median of CUDA-event single calls) on the base+delta
    executable and on the base graph's dense executable without the delta,
    at the group's split.  The timing calls' launches are not counted."""
    from repro_torch.core import engine as E
    from repro_torch.core import query as Q
    from repro_torch.kernels import hop_scatter as HK

    counts = dict(HK.LAUNCHES)
    out = {}
    for d in sched.last_dispatches:
        if not d.delta:
            continue
        qs = [wl[i].qry for i in d.indices]
        params = np.stack([Q.query_params(q) for q in qs])
        base = E.batch_executable(sched.graph, qs[0], d.split, mode, sched.n_buckets,
                                  sliced=False, impl="cuda")
        delta = E.batch_executable_delta(sched.graph, qs[0], d.split, mode,
                                         sched.n_buckets, impl="cuda")
        dv = sched._delta
        out[wl[d.indices[0]].template] = dict(
            delta_ms=time_ms(lambda: delta(params, dv), iters=5),
            base_ms=time_ms(lambda: base(params), iters=5))
    HK.LAUNCHES.update(counts)
    free_memory()
    return out


def live_audit(tracer, tb) -> dict:
    """The cost-model audit of one traced drain: the telemetry replayed from
    the trace must equal the live buffer's float for float; plan accuracy,
    coefficient drift, the trace written to LIVE_TRACE and rendered by
    ``scripts/torch_trace_report.py --audit``, which must exit 0."""
    from repro_torch.obs import audit

    live = tb.error_stats()
    replay = audit.replay_telemetry(tracer).error_stats()
    if any(replay[k] != live[k] for k in ERROR_KEYS) or live["n"] == 0:
        raise AssertionError(f"live audit: replayed telemetry {replay} != live {live}")
    plan = audit.plan_accuracy(tracer, within=PLAN_WITHIN)
    drift = audit.coefficient_drift(tracer)
    n_disp = len(audit.dispatch_records(tracer))
    LIVE_TRACE.parent.mkdir(parents=True, exist_ok=True)
    n_spans = tracer.export_jsonl(str(LIVE_TRACE))
    t0 = time.perf_counter()
    rep = subprocess.run([sys.executable, str(ROOT / "scripts" / "torch_trace_report.py"),
                          str(LIVE_TRACE), "--limit", "1", "--audit"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    if rep.returncode != 0 or "cost-model audit" not in rep.stdout:
        raise AssertionError(f"live audit: torch_trace_report.py failed (rc "
                             f"{rep.returncode}): {rep.stderr[-1500:]}")
    moved = {k: v["rel"] for k, v in drift.items() if v["abs_delta"] > 0}
    out = dict(error=live, plan=plan, drift_rel=moved, n_dispatch_records=n_disp,
               n_spans=n_spans, report_s=time.perf_counter() - t0)
    log(f"audit: plan_accuracy frac_within={plan['frac_within']} (within "
        f"{PLAN_WITHIN:.0%}, {plan['n_decisions']} decisions, {plan['n_queries']} queries, "
        f"mean_ratio={plan['mean_ratio']}, worst_ratio={plan['worst_ratio']}); coefficient "
        f"drift (rel) {json.dumps(moved)}; {n_disp} dispatch records; replayed telemetry "
        f"equals the live buffer (n={live['n']}, mean_abs_rel_err={live['mean_abs_rel_err']}, "
        f"p90={live['p90_abs_rel_err']}); trace of {n_spans} spans rendered by "
        f"torch_trace_report.py --audit: rc 0")
    return out


def run_cli(argv: list) -> tuple:
    """``python -m repro_torch.launch.query`` with ``argv`` from the repo's
    root: (the finished process, its seconds)."""
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "repro_torch.launch.query"] + argv,
                         cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    return cli, time.perf_counter() - t0


def live_cli() -> dict:
    """``python -m repro_torch.launch.query --live --wal`` fresh, then again
    on the same WAL: the second run must recover every sealed epoch and pin
    the first run's last fingerprint."""
    LIVE_WAL.parent.mkdir(parents=True, exist_ok=True)
    LIVE_WAL.unlink(missing_ok=True)
    runs = []
    for _ in range(2):
        cli, cli_s = run_cli(LIVE_CLI)
        if cli.returncode != 0:
            raise AssertionError(f"live: the CLI failed (rc {cli.returncode}): "
                                 f"{cli.stdout[-800:]} {cli.stderr[-1500:]}")
        runs.append(dict(seconds=cli_s, stdout=cli.stdout))
    fps = [ln.split("fp=")[1].split()[0] for ln in runs[0]["stdout"].splitlines()
           if "fp=" in ln]
    rec = [ln for ln in runs[1]["stdout"].splitlines() if ln.startswith("recovered ")]
    want = f"recovered {LIVE_EPOCHS + 1} sealed epoch(s)"
    if len(fps) != LIVE_EPOCHS + 1 or not rec or not rec[0].startswith(want) \
            or f"pinned fp {fps[-1]}" not in rec[0]:
        raise AssertionError(f"live: the CLI's recovery did not pin {fps[-1:]}: "
                             f"{runs[1]['stdout'][-800:]}")
    log(f"live: python -m repro_torch.launch.query {' '.join(LIVE_CLI)}: rc 0 "
        f"({runs[0]['seconds']:.1f}s), last pinned fp {fps[-1]}; again on the same WAL: "
        f"rc 0 ({runs[1]['seconds']:.1f}s), '{rec[0]}'")
    return dict(argv=LIVE_CLI, seconds=[r["seconds"] for r in runs], fingerprints=fps,
                recovered=rec[0])


def phase_live(graph, served: dict) -> dict:
    """Live graphs at full size on the main graph: ``log_from_graph`` holds
    a tenth of the edges out of epoch 0, an ``EpochManager`` seals epoch 0
    and ingests the held edges back in LIVE_EPOCHS epochs, and a last
    ``advance(compact=True)`` seals the empty suffix and compacts.  At every
    epoch one scheduler, pinned by the manager, drains the serve phase's
    workload in bucket and static mode (Q2/Q2-min also in interval mode at
    epoch 1), on the kernels; a partitioned scheduler drains it in static
    mode at epochs 0 and 1 (the second through the partition hint); the
    flight recorder and a telemetry buffer ride epoch 0's first bucket drain
    for the cost-model audit.  Beside the host's set-up of epoch 0, the CLI
    serves ``--live --wal`` and recovers from its WAL."""
    from repro_torch.core import engine as E
    from repro_torch.core import engine_partitioned as EP
    from repro_torch.graphdata.ingest import log_from_graph
    from repro_torch.kernels import hop_scatter as HK
    from repro_torch.obs import NULL_TRACER, MetricsRegistry, Tracer
    from repro_torch.serving import BatchScheduler, EpochManager, TelemetryBuffer

    t_phase = time.perf_counter()
    if graph.eprops:
        raise AssertionError("live: the graph has edge properties, which log_from_graph "
                             "drops from held edges")
    wl = serve_workload(graph)
    wl_delta = [i for i in wl if all(e.etr_op == -1 for e in i.qry.e_preds)]
    mark0 = dict(HK.LAUNCHES)

    # ---- set-up: the event log and epoch 0, on the host, while the CLI
    # (its own small graph and WAL) runs beside it
    with ThreadPoolExecutor(1) as pool:
        cli = pool.submit(live_cli)
        t0 = time.perf_counter()
        elog, held = log_from_graph(graph, holdout_edges=graph.n_edges // 10, seed=SEED)
        log_s = time.perf_counter() - t0
        if len(held) != graph.n_edges // 10:
            raise AssertionError(f"live: {len(held)} held edges")
        mx, mtr = MetricsRegistry(), Tracer(capacity=1 << 16)
        mgr = EpochManager(elog, metrics=mx, tracer=mtr)
        t0 = time.perf_counter()
        ep = mgr.seal()
        seal_s = time.perf_counter() - t0
        cli = cli.result()        # before the first timed drain
    info = dict(setup=dict(events=len(elog), held_edges=len(held), log_from_graph_s=log_s,
                           epoch0_s=seal_s, n_vertices=ep.graph.n_vertices,
                           n_edges=ep.graph.n_edges), epochs=[])
    log(f"live: set-up log_from_graph {log_s:.1f}s ({len(elog)} events, {len(held)} edges "
        f"held out), epoch 0 {seal_s:.1f}s ({ep.graph.n_vertices} vertices, "
        f"{ep.graph.n_edges} edges)")
    cache = mx.counter("granite_cache_total", "serving cache events",
                       labelnames=("cache", "event"))

    def invalidations() -> float:
        return sum(cache.value(cache=c, event="invalidation")
                   for c in ("executable", "plan"))

    sched = BatchScheduler(ep.graph, metrics=mx)
    mgr.attach(sched)
    psched = BatchScheduler(ep.graph, engine="partitioned", n_workers=LIVE_WORKERS,
                            mode=E.MODE_STATIC)
    psched.pin_epoch(ep)
    chunks = np.array_split(np.arange(len(held)), LIVE_EPOCHS)
    partitioned = []
    ingest_s = 0.0
    ex = sched.exec_cache.stats.as_dict()
    while True:
        t_ep = time.perf_counter()
        mark = dict(HK.LAUNCHES)
        final = ep.id == LIVE_EPOCHS + 1
        live_epoch = 1 <= ep.id <= LIVE_EPOCHS
        if live_epoch and ep.compacted:
            raise AssertionError(f"live e{ep.id}: compacted before the last epoch")
        row = dict(id=ep.id, events=ep.n_events, ingest_s=ingest_s, seal_s=seal_s,
                   materialize_s=[r["t_end"] - r["t_start"] for r in mtr.records()
                                  if r["name"] == "materialize"][-1],
                   fingerprint=ep.fingerprint, base_fingerprint=ep.base_fingerprint,
                   compacted=ep.compacted, delta_edges=ep.n_delta_edges,
                   capacity=ep.delta.capacity if ep.delta is not None else 0)
        if live_epoch and ep.delta is None:
            raise AssertionError(f"live e{ep.id}: the window is not delta-pure")
        if ep.id == 0:            # the audit rides epoch 0's first bucket drain
            tracer, tb = Tracer(capacity=1 << 20), TelemetryBuffer(refit=False)
            sched.tracer, sched.telemetry, sched.mode = tracer, tb, E.MODE_BUCKET
            check_served(sched.run(wl, warm=True), "live audit drain")
            sched.tracer, sched.telemetry = NULL_TRACER, None
            info["audit"] = live_audit(tracer, tb)
            del tracer, tb
        res = {}
        for m, mode in (("bucket", E.MODE_BUCKET), ("static", E.MODE_STATIC)):
            row[m], res[m] = live_drain(sched, wl, ep.graph, mode, f"live e{ep.id} {m}",
                                        reference=ep.id in LIVE_TORCH_EPOCHS)
            # ETR-free groups, and only they, run on the delta path of a
            # live epoch; the delta executables are cache hits after the
            # window's first epoch
            pairs = row[m]["delta"]
            if any(dl != (free and live_epoch) for free, dl in pairs):
                raise AssertionError(f"live e{ep.id} {m}: delta dispatches {pairs}")
            if live_epoch and not any(dl for _, dl in pairs):
                raise AssertionError(f"live e{ep.id} {m}: no delta dispatch")
            if ep.id >= 2 and live_epoch and not all(
                    hit for dl, hit in row[m]["first"] if dl):
                raise AssertionError(f"live e{ep.id} {m}: a delta executable missed "
                                     f"the cache: {row[m]['first']}")
            row[m]["n_delta"] = sum(dl for _, dl in pairs)
            row[m]["n_merged"] = len(pairs) - row[m]["n_delta"]
            if ep.id == LIVE_EPOCHS:   # the delta path's own cost, at the window's end
                row[m]["delta_cost"] = delta_cost(sched, wl, mode)
        if ep.id == 1:
            # Q2/Q2-min in interval mode, and each delta group against a
            # scheduler built fresh on the merged graph, which has no delta
            # (the plain lowering's dense interval state [Q, 2E, 16, 17] is
            # held one query at a time, as the main phase runs interval jobs)
            row["interval"], _ = live_drain(sched, wl_delta, ep.graph, E.MODE_INTERVAL,
                                            f"live e{ep.id} interval", ref_chunk=1)
            if row["interval"]["launches"]["fused_hop_interval"] == 0:
                raise AssertionError("live interval: B2 never launched")
            row["fresh"] = {}
            fresh = BatchScheduler(ep.graph)
            for m, mode in (("bucket", E.MODE_BUCKET), ("static", E.MODE_STATIC)):
                sched.mode = fresh.mode = mode
                row["fresh"][m] = check_drains(sched, fresh, wl_delta,
                                               f"live e{ep.id} {m} delta vs fresh merged")
            del fresh
        if ep.id in (0, 1):
            # the partitioned engine, its epoch-1 tables through the hint
            psched.pin_epoch(ep)
            t0 = time.perf_counter()
            p_res = served_answers(psched, wl, f"live e{ep.id} partitioned")
            p_s = time.perf_counter() - t0
            _, arrays = EP.partition_for(ep.graph, LIVE_WORKERS)
            p = dict(epoch=ep.id, drain_s=p_s, **arrays.setup_s,
                     check=hold_answers(p_res, res["static"], wl,
                                        f"live e{ep.id} partitioned vs auto"))
            partitioned.append(p)
            log(f"live: e{ep.id} partitioned static drain (W={LIVE_WORKERS}) equals the auto "
                f"drain ({p['check']['n_ge_2_24']} entries >= 2^24); tables via "
                f"{p['path']}: partition {p['partition']:.3f}s, tables {p['tables']:.3f}s; "
                f"first drain {p_s:.1f}s")
            if ep.id == 1 and p["path"] != "hint":
                raise AssertionError("live: epoch 1's partition tables did not come "
                                     "through the hint")
            ep.graph.__dict__.pop("_partition_dev_cache", None)
            del p_res
            if ep.id == 1:
                e0_graph = mgr.mat.base_graph
                e0_graph.__dict__.pop("_partition_dev_cache", None)
                del psched
        if final:
            row["vs_serve"] = {m: hold_answers(res[m], served[m], wl,
                                               f"live final {m} vs serve phase")
                               for m in ("bucket", "static")}
        now = sched.exec_cache.stats.as_dict()
        row["cache"] = dict(now, since={k: v - ex[k] for k, v in now.items()},
                            invalidations_total=invalidations())
        ex = now
        row["launches"] = launches_since(mark)
        row["wall_s"] = time.perf_counter() - t_ep
        b, st = row["bucket"], row["static"]
        log(f"live: epoch {ep.id}: {ep.n_events} events, materialize "
            f"{row['materialize_s']:.2f}s, seal {seal_s:.2f}s (ingest {ingest_s:.2f}s); "
            f"fp {ep.fingerprint} base {ep.base_fingerprint}; delta {ep.n_delta_edges} "
            f"edges, capacity {row['capacity']}; bucket wall_ms={b['wall_ms']:.3f} "
            f"p50={b['latency_ms_p50']:.3f} p99={b['latency_ms_p99']:.3f}, static "
            f"wall_ms={st['wall_ms']:.3f} p50={st['latency_ms_p50']:.3f} "
            f"p99={st['latency_ms_p99']:.3f}; dispatches delta/merged bucket "
            f"{b['n_delta']}/{b['n_merged']} static {st['n_delta']}/{st['n_merged']}; "
            f"executable cache since the last epoch's drains hit/miss/invalidation "
            f"{row['cache']['since']['hits']}/{row['cache']['since']['misses']}/"
            f"{row['cache']['since']['invalidations']} (registry invalidations "
            f"{row['cache']['invalidations_total']:.0f}); peak_GiB={b['peak_bytes'] / 2**30:.3f} "
            f"resident_GiB={b['resident_bytes'] / 2**30:.3f}; launches B1 "
            f"{row['launches']['fused_hop_cols']} B2 {row['launches']['fused_hop_interval']} "
            f"B3 {row['launches']['scatter_cols']}; delta groups ms (delta path / base "
            f"dense without the delta) bucket {json.dumps(b.get('delta_cost', {}))} static "
            f"{json.dumps(st.get('delta_cost', {}))}; drains and checks {row['wall_s']:.1f}s")
        info["epochs"].append(row)
        free_memory()
        if final:
            break
        # ---- ingest the next chunk; the pinned epoch must not see it
        t0 = time.perf_counter()
        if ep.id < LIVE_EPOCHS:
            ids = chunks[ep.id]
            mgr.ingest(held[int(ids[0]): int(ids[-1]) + 1])
        ingest_s = time.perf_counter() - t0
        sched.mode = E.MODE_STATIC
        snap = hold_answers(served_answers(sched, wl, f"live e{ep.id} snapshot"),
                            res["static"], wl, f"live e{ep.id} snapshot isolation")
        row["snapshot"] = snap
        del res
        t0 = time.perf_counter()
        ep = mgr.advance(sched, compact=True if ep.id == LIVE_EPOCHS else None)
        seal_s = time.perf_counter() - t0
        if not ep.compacted and invalidations():
            raise AssertionError(f"live e{ep.id}: {invalidations()} cache invalidations")
        if ep.id == LIVE_EPOCHS + 1 and not (ep.compacted and invalidations() > 0):
            raise AssertionError(f"live: the compacting advance invalidated "
                                 f"{invalidations()} entries")
    info["partitioned"] = partitioned
    info["cli"] = cli
    info["launches"] = launches_since(mark0)
    missing = [k for k, v in info["launches"].items() if v == 0]
    if missing:
        raise AssertionError(f"live: the drains never launched {missing}")
    del sched, mgr, elog, held
    free_memory()
    info["wall_s"] = time.perf_counter() - t_phase
    log(f"live: launches over the phase {info['launches']}; phase {info['wall_s']:.1f}s")
    return info


# =========================================================================
# model serving: gemma3-4b (B7) and DLRM-RM2 (B8)
# =========================================================================
def model_entry(name: str, variant: str, kern, plain, library, nbytes: float,
                flops: float, flop_rate: float, atol: float, rtol: float,
                launches: int, library_tol: float | None = None) -> dict:
    """One kernel line: the kernel against its plain version on the same
    inputs (atol, rtol), then the kernel, the plain version and the library
    call timed by ``timings`` beside the bound, and the host's time of a call
    of the kernel's wrapper and of the library call (``host_us``).
    ``library`` is one PyTorch call that computes the same function, None,
    or {label: call} of several such calls (the line's ``library_*`` is then
    the fastest).  A library call is a yardstick, checked only to compute
    the same function: atol = rtol = ``library_tol`` (default: the kernel's
    own)."""
    libraries = library if isinstance(library, dict) else \
        {} if library is None else {"call": library}
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = close(got.float(), want.float(), atol, rtol, f"kernel {name}[{variant}]")
    lt = (atol, rtol) if library_tol is None else (library_tol, library_tol)
    for label, fn in libraries.items():
        close(fn().float(), want.float(), *lt, f"library {label} for {name}[{variant}]")
    del got, want
    times = timings(kern, plain, libraries)
    times["host_us"] = host_us(kern)
    best = times.get("library_call", next(iter(libraries), None))
    times["library_host_us"] = host_us(libraries[best]) if libraries else None
    b_ms, b_by = bound(nbytes, flops, flop_rate)
    e = dict(name=f"{name}[{variant}]", route="cuda", source=SOURCE[name],
             replaces=REPLACES[name], launches=launches, max_abs_err=err, **times,
             bound_ms=b_ms, bound_by=b_by, bytes=nbytes, flops=flops, atol=atol, rtol=rtol)
    log(f"kernels: {e['name']:34s} {fmt_times(times)}"
        f" bound_ms={b_ms:.4f} ({b_by}) max_abs_err={err} launches={launches}")
    free_memory()
    return e


class AttentionCapture:
    """Keeps the operands of chosen calls of the attention wrapper: call i
    of a prefill or decode step is layer i's.  Patches the module attribute
    the transformer calls through, and restores it on exit."""

    def __init__(self, layers):
        from repro_torch.kernels.flash_attention import ops as FA

        self.FA, self.layers, self.calls, self.args = FA, set(layers), 0, {}

    def __enter__(self):
        self.orig = self.FA.flash_attention

        def wrapped(q, k, v, **kw):
            if self.calls in self.layers:    # the options, less the impl (always 'cuda')
                # and scales where there are none (a float cache)
                self.args[self.calls] = (q, k, v, {o: x for o, x in kw.items() if o != "impl"
                                                   and not (o == "scales" and x is None)})
            self.calls += 1
            return self.orig(q, k, v, **kw)

        self.FA.flash_attention = wrapped
        return self

    def __exit__(self, *exc):
        self.FA.flash_attention = self.orig

    def check(self, n_layers: int, what: str) -> dict:
        """The kept operands by layer; raises unless every layer's call went
        through the patched attribute."""
        if self.calls != n_layers or set(self.args) != self.layers:
            raise AssertionError(f"lm: capture of the {what} saw {self.calls} attention calls "
                                 f"(want {n_layers}) and layers {sorted(self.args)}")
        return self.args


def attention_library(q, k, v, kw) -> dict:
    """``F.scaled_dot_product_attention`` (GQA) as a yardstick, which the port
    never calls: {"sdpa_mask": SDPA with the call's mask as a tensor}, and,
    where one call without a mask tensor computes the same function,
    "sdpa_nomask": ``is_causal`` where the causal bound is the diagonal (no
    window, Sq = Sk, no offset), or the keys' visible run sliced out where
    every query row sees the same run (one row, as in decode)."""
    import torch.nn.functional as F

    Sq, Sk = q.shape[2], k.shape[2]
    off, window = kw.get("q_offset", 0), kw.get("window")
    qpos = torch.arange(Sq, device=q.device)[:, None] + off
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    forms = {"sdpa_mask": lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, enable_gqa=True)}
    if window is None and Sq == Sk and off == 0:
        forms["sdpa_nomask"] = lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
    elif Sq == 1:
        lo, hi = max(0, off - window + 1) if window is not None else 0, min(Sk, off + 1)
        ks, vs = k[:, :, lo:hi], v[:, :, lo:hi]
        forms["sdpa_nomask"] = lambda: F.scaled_dot_product_attention(
            q, ks, vs, enable_gqa=True)
    return forms


def tc_encode_us(q, k, v, kw, iters: int = 1000) -> float:
    """Host microseconds to encode the three TMA tensor maps (q, k, v) of
    this call of the 'tc' route, by the code its C entry point runs for
    them (``flash_attention_tc_encode_ns``), the mean of ``iters``."""
    from repro_torch.kernels import build

    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    ns = build.load("flash_attention_sm90").flash_attention_tc_encode_ns(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], B, Hq, Hkv, Sq, Sk, D, int(kw.get("causal", True)),
        int(kw.get("q_offset", 0)), iters)
    if ns < 0:
        raise AssertionError("lm: cuTensorMapEncodeTiled refused a map of the global prefill")
    return ns / 1e3


def lm_smoke_check(smoke=None, tag: str = "lm") -> dict:
    """A SMOKE variant (float32; gemma3-4b's unless ``smoke`` is given): the
    port on the card through the kernel against the port on the CPU (plain
    attention), which the CPU tests hold to the JAX package; atol 2e-5
    (matrix products summed in other orders)."""
    from repro_torch.models import transformer as TR

    if smoke is None:
        from repro_torch.configs.gemma3_4b import SMOKE as smoke
    params = TR.init_params(smoke, torch.Generator().manual_seed(SEED), device="cpu")
    on_card = tree_map(torch.Tensor.cuda, params)
    toks = torch.randint(0, smoke.vocab, (2, 20), generator=torch.Generator().manual_seed(SEED))
    err = close(TR.forward(smoke, on_card, toks.cuda()).cpu(), TR.forward(smoke, params, toks),
                2e-5, 0.0, f"{tag} smoke forward")
    lc, cc = TR.prefill(smoke, on_card, toks.cuda(), 24)
    lp, cp = TR.prefill(smoke, params, toks, 24)
    err = max(err, close(lc.cpu(), lp, 2e-5, 0.0, f"{tag} smoke prefill"))
    for n in range(21, 25):
        tok = lp.argmax(-1)
        lc, cc = TR.decode_step(smoke, on_card, cc, tok.cuda(), n)
        lp, cp = TR.decode_step(smoke, params, cp, tok, n)
        err = max(err, close(lc.cpu(), lp, 2e-5, 0.0, f"{tag} smoke decode {n}"))
    log(f"{tag}: SMOKE on the card equals the CPU port: forward, prefill, 4 decode "
        f"steps, max_abs_err {err:.3g} (atol 2e-5)")
    return dict(max_abs_err=err)


def lm_serve(cfg, params, prompts, tag: str) -> dict:
    """The serve path timed at full width: a warm-up prefill and decode step,
    then, with B7's counters set to 0 just before and read just after, the
    prompts' ``prefill`` and LM_TOKENS - 1 greedy ``decode_step``s, each
    phase timed on the host clock up to a synchronise.  Returns the timings,
    peak and resident memory, B7's launches (all and by route), and the run's
    float32 logits [LM_TOKENS, B, V], tokens [LM_TOKENS, B] and cache."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as TR

    dev = prompts.device
    max_len = LM_PROMPT + LM_TOKENS
    logits = torch.empty((LM_TOKENS, LM_BATCH, cfg.vocab), dtype=torch.float32, device=dev)
    tokens = torch.empty((LM_TOKENS, LM_BATCH), dtype=torch.long, device=dev)
    # warm-up at full size: cuBLAS handles, the kernel's first launch, and the
    # allocator's blocks (kept cached, so the timed run pays no cudaMalloc)
    lw, cw = TR.prefill(cfg, params, prompts, max_len)
    TR.decode_step(cfg, params, cw, lw.argmax(-1), LM_PROMPT + 1)
    del lw, cw
    gc.collect()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    FA.reset_launches()           # the count is 0 just before the serve path
    t0 = time.perf_counter()
    out, cache = TR.prefill(cfg, params, prompts, max_len)
    logits[0].copy_(out)
    tokens[0] = out.argmax(-1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for i in range(1, LM_TOKENS):
        out, cache = TR.decode_step(cfg, params, cache, tokens[i - 1], LM_PROMPT + i)
        logits[i].copy_(out)
        tokens[i] = out.argmax(-1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = FA.LAUNCHES["flash_attention"]   # read just after
    serve_routes = {r: FA.LAUNCHES["flash_attention_" + r] for r in FA.ROUTES}
    peak = torch.cuda.max_memory_allocated()
    info = dict(prefill_ms=(t1 - t0) * 1e3, decode_ms_per_token=(t2 - t1) * 1e3 / (LM_TOKENS - 1),
                resident_bytes=resident, peak_bytes=peak, launches=launches,
                prefill_tokens_per_s=LM_BATCH * LM_PROMPT / (t1 - t0),
                decode_tokens_per_s=LM_BATCH * (LM_TOKENS - 1) / (t2 - t1))
    n_params = sum(t.numel() for t in leaves(params))
    log(f"{tag}: {cfg.name} {n_params / 1e9:.3f} B params bf16, {LM_BATCH} x {LM_PROMPT}-token "
        f"prompts, {LM_TOKENS} greedy tokens: prefill {info['prefill_ms']:.1f} ms, decode "
        f"{info['decode_ms_per_token']:.2f} ms/token, peak_GiB={peak / 2**30:.3f} "
        f"resident_GiB={resident / 2**30:.3f}, B7 launches {launches}")
    want = cfg.n_layers * LM_TOKENS
    if launches != want:
        raise AssertionError(f"{tag}: B7 launched {launches} times on the serve path, want {want}")
    # the prefill's layers through the tensor-core kernel, the decode steps'
    # through the split-K kernel, none through the CUDA-core kernel
    want_routes = dict(tc=cfg.n_layers, decode=cfg.n_layers * (LM_TOKENS - 1), simt=0)
    if serve_routes != want_routes:
        raise AssertionError(f"{tag}: B7 routes on the serve path {serve_routes}, "
                             f"want {want_routes}")
    info["launches_by_route"] = serve_routes
    log(f"{tag}: B7 launches by route on the serve path: {serve_routes}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{tag}: non-finite logits")
    return dict(info=info, logits=logits, tokens=tokens, cache=cache)


def phase_lm() -> tuple:
    """Returns (report dict, kernel lines of B7)."""
    from repro_torch.configs.gemma3_4b import CONFIG
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as TR

    info = dict(smoke=lm_smoke_check())
    cfg, dev = CONFIG, torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = TR.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in [params["embed"], params["ln_f"],
                                        *params["layers"].values()])
    if n_params != cfg.param_count():
        raise AssertionError(f"lm: {n_params} parameters, config says {cfg.param_count()}")
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=gen, device=dev)
    max_len = LM_PROMPT + LM_TOKENS
    info.update(config=cfg.name, params=n_params, batch=LM_BATCH, prompt=LM_PROMPT,
                new_tokens=LM_TOKENS, max_len=max_len, init_s=time.perf_counter() - t0)
    run = lm_serve(cfg, params, prompts, "lm")
    info.update(run["info"])
    logits, tokens, cache = run["logits"], run["tokens"], run["cache"]
    serve_routes = info["launches_by_route"]
    del run

    info["profile"] = dict(
        prefill=traced(lambda: TR.prefill(cfg, params, prompts, max_len)),
        decode_step=traced(lambda: TR.decode_step(cfg, params, cache, tokens[LM_TOKENS - 2],
                                                  LM_PROMPT + LM_TOKENS - 1)))
    for k, rec in info["profile"].items():
        log_trace(f"profile: lm {k}", rec)

    # impl='torch' (bf16) and the same model in float32 (impl='torch', the
    # bf16 weights cast up), both with teacher forcing: they get this run's
    # tokens.  The kernels differ from the plain version only in the
    # attention's summation order, which in bf16 moves the logits as much as
    # rounding itself does; the bound per step is twice the plain bf16 run's
    # own distance from float32 arithmetic (measured, and stated in PERF.md).
    #
    # The same float32 model also runs with impl='cuda' (the kernel's float32
    # instantiation), teacher-forced, against impl='torch' in float32: there
    # summation order is the only difference, so the bound is 1e-3 of the
    # step's max |logit|, and the greedy tokens must agree wherever the
    # float32 top-1/top-2 gap exceeds it.
    plain = dataclasses.replace(cfg, impl="torch")
    f32 = dataclasses.replace(cfg, impl="torch", dtype=torch.float32)
    f32_cuda = dataclasses.replace(cfg, impl="cuda", dtype=torch.float32)
    params32 = tree_map(torch.Tensor.float, params)
    steps, near_ties, near_ties32 = [], 0, 0
    ref_cache = f32_cache = c32_cache = None
    launches32 = FA.LAUNCHES["flash_attention"]
    routes32 = {r: FA.LAUNCHES["flash_attention_" + r] for r in FA.ROUTES}
    for i in range(LM_TOKENS):
        if i == 0:
            ref, ref_cache = TR.prefill(plain, params, prompts, max_len)
            r32, f32_cache = TR.prefill(f32, params32, prompts, max_len)
            c32, c32_cache = TR.prefill(f32_cuda, params32, prompts, max_len)
        else:
            n = LM_PROMPT + i
            ref, ref_cache = TR.decode_step(plain, params, ref_cache, tokens[i - 1], n)
            r32, f32_cache = TR.decode_step(f32, params32, f32_cache, tokens[i - 1], n)
            c32, c32_cache = TR.decode_step(f32_cuda, params32, c32_cache, tokens[i - 1], n)
        top = float(ref.abs().max())
        own = float((ref - r32).abs().max())         # the plain run's bf16 error
        err = float((logits[i] - ref).abs().max())
        top32 = float(r32.abs().max())
        err32 = float((c32 - r32).abs().max())
        st = dict(step=i, err=err, bound=2 * own, plain_vs_f32=own, max_logit=top,
                  cuda_vs_f32=float((logits[i] - r32).abs().max()),
                  f32_err=err32, f32_bound=1e-3 * top32)
        steps.append(st)
        if not bool(torch.isfinite(c32).all()) or err32 > 1e-3 * top32:
            raise AssertionError(f"lm: step {i}: float32 impl cuda vs torch max |logit diff| "
                                 f"{err32} > 1e-3 x {top32}")
        gap32 = r32.topk(2, dim=-1).values
        decided32 = (gap32[:, 0] - gap32[:, 1]) > 1e-3 * top32
        if bool((decided32 & (c32.argmax(-1) != r32.argmax(-1))).any()):
            raise AssertionError(f"lm: step {i}: a float32 greedy token differs where the "
                                 f"top-1/top-2 gap exceeds {1e-3 * top32}")
        near_ties32 += int((~decided32).sum())
        if not 0 < own < 0.1 * top:
            raise AssertionError(f"lm: step {i}: plain bf16 vs float32 {own} is no rounding error")
        if err > 2 * own:
            raise AssertionError(f"lm: step {i}: max |logit diff| {err} > 2 x {own}")
        top2 = ref.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > 2 * own
        if bool((decided & (tokens[i] != ref.argmax(-1))).any()):
            raise AssertionError(f"lm: step {i}: a greedy token differs where the plain "
                                 f"run's top-1/top-2 gap exceeds {2 * own}")
        near_ties += int((~decided).sum())
    launches32 = FA.LAUNCHES["flash_attention"] - launches32
    routes32 = {r: FA.LAUNCHES["flash_attention_" + r] - routes32[r] for r in FA.ROUTES}
    del ref_cache, f32_cache, c32_cache, ref, r32, c32, params32
    if launches32 != cfg.n_layers * LM_TOKENS:
        raise AssertionError(f"lm: the float32 run launched B7 {launches32} times, "
                             f"want {cfg.n_layers * LM_TOKENS}")
    # float32: the prefill through the CUDA-core kernel's float32
    # instantiation, decode through the split-K kernel's
    want32 = dict(tc=0, decode=cfg.n_layers * (LM_TOKENS - 1), simt=cfg.n_layers)
    if routes32 != want32:
        raise AssertionError(f"lm: B7 routes of the float32 run {routes32}, want {want32}")
    info["f32_launches_by_route"] = routes32
    worst = max(steps, key=lambda st: st["err"] / st["bound"])
    worst32 = max(steps, key=lambda st: st["f32_err"] / st["f32_bound"])
    info.update(teacher_forced=steps, tokens_within_bound_of_a_tie=near_ties,
                max_abs_logit_err=max(st["err"] for st in steps),
                max_err_over_max_logit=max(st["err"] / st["max_logit"] for st in steps),
                max_err_over_bound=worst["err"] / worst["bound"],
                f32_max_abs_logit_err=max(st["f32_err"] for st in steps),
                f32_max_err_over_max_logit=worst32["f32_err"] / worst32["f32_bound"] * 1e-3,
                f32_tokens_within_bound_of_a_tie=near_ties32, f32_launches=launches32)
    log(f"lm: impl='torch' with teacher forcing: max |logit diff| "
        f"{info['max_abs_logit_err']:.4g} ({info['max_err_over_max_logit']:.4g} of the step's "
        f"max |logit|); worst step {worst['step']}: {worst['err']:.4g} against bound "
        f"{worst['bound']:.4g} (2 x plain bf16 vs float32; cuda vs float32 "
        f"{worst['cuda_vs_f32']:.4g}); every greedy token agrees where the top-1/top-2 gap "
        f"exceeds the bound; {near_ties} of {LM_TOKENS * LM_BATCH} tokens fall within it")
    log(f"lm: float32, impl='cuda' (B7 float32, {launches32} launches) vs impl='torch' with "
        f"teacher forcing: max |logit diff| {info['f32_max_abs_logit_err']:.4g}, at most "
        f"{info['f32_max_err_over_max_logit']:.4g} of the step's max |logit| (bound 1e-3); "
        f"greedy tokens agree where the gap exceeds it; {near_ties32} of "
        f"{LM_TOKENS * LM_BATCH} tokens fall within it; routes {routes32}")
    free_memory()

    # the int8 KV cache on the same traffic, held to impl='torch' at the bf16
    # leg's bounds
    info["int8"], int8_calls = lm_int8_leg(cfg, params, prompts, logits, tokens,
                                           [st["bound"] for st in steps],
                                           info["decode_ms_per_token"])
    free_memory()

    # B7 on the main path's calls: the prefill's layers 0 and 5, the last decode step's
    calls = b7_calls(cfg, params, prompts, cache, tokens, LM_CAPTURE)
    del params
    free_memory()
    entries = b7_entries(calls, serve_routes, routes32)
    del calls, cache
    free_memory()
    entries += int8_entries(int8_calls, info["int8"]["launches_by_route"]["decode_int8"])
    del int8_calls
    free_memory()
    return info, entries


def lm_int8_leg(cfg, params, prompts, ref_logits, ref_tokens, bounds: list,
                bf16_ms: float) -> tuple:
    """gemma3-4b at full width over the int8 KV cache, on the bf16 leg's
    traffic: ``prefill`` (which returns the float cache, as the reference's
    does), the int8 cache built from it (``quantize_cache``), a warm-up step, then
    LM_TOKENS - 1 ``decode_step``s with impl='cuda' fed the bf16 run's greedy
    tokens (``ref_tokens``), B7's counters set to 0 just before and read
    just after: every layer of every step must launch the int8 decode route.
    The check: the same steps with impl='torch' from a copy of the same int8
    cache, logits within ``bounds`` (the bf16 leg's per step: twice the
    plain bf16 run's distance from float32), greedy tokens equal where the
    top-1/top-2 gap exceeds the bound.  Findings, not gates: decode ms a
    token beside the bf16 leg's (``bf16_ms``, earlier in the run), peak and
    resident GiB, the cache's bytes against bf16's, the int8
    run's greedy tokens against the bf16 run's and the largest post-softmax
    distance from the bf16 run's logits (``ref_logits``).  Returns (info, B7's
    operands at the last step's layers 0 and 5)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as TR

    cfgq = dataclasses.replace(cfg, kv_cache_quant=True)
    plainq = dataclasses.replace(cfgq, impl="torch")
    max_len = LM_PROMPT + LM_TOKENS
    t0 = time.perf_counter()
    out0, fcache = TR.prefill(cfgq, params, prompts, max_len)
    cache = TR.quantize_cache(fcache, LM_PROMPT)
    del fcache
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # warm-up: the int8 kernel's first launches (each run writes this row again)
    TR.decode_step(cfgq, params, cache, ref_tokens[0], LM_PROMPT + 1)
    copy = tuple(t.clone() for t in cache)
    gc.collect()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logits = torch.empty((LM_TOKENS, LM_BATCH, cfg.vocab), dtype=torch.float32,
                         device=prompts.device)
    logits[0].copy_(out0)
    FA.reset_launches()           # the count is 0 just before the int8 decode path
    t1 = time.perf_counter()
    for i in range(1, LM_TOKENS):
        out, cache = TR.decode_step(cfgq, params, cache, ref_tokens[i - 1], LM_PROMPT + i)
        logits[i].copy_(out)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    routes = {r: FA.LAUNCHES["flash_attention_" + r] for r in (*FA.ROUTES, "decode_int8")}
    peak = torch.cuda.max_memory_allocated()
    steps = cfg.n_layers * (LM_TOKENS - 1)
    want = dict(tc=0, decode=steps, simt=0, decode_int8=steps)
    if routes != want:
        raise AssertionError(f"lm int8: B7 launches by route {routes}, want {want}")
    # where a step's time goes: one traced step (it writes its row again),
    # and the host's time of one layer's quantization of its k and v rows
    trace = traced(lambda: TR.decode_step(cfgq, params, cache, ref_tokens[LM_TOKENS - 2],
                                          LM_PROMPT + LM_TOKENS - 1))
    log_trace("profile: lm int8 decode_step", trace)
    kv = torch.zeros((2, LM_BATCH, cfg.n_kv_heads, cfg.d_head), dtype=cfg.dtype,
                     device=prompts.device)
    quantize_us = host_us(lambda: TR._quantize_kv(kv))
    nbytes = sum(t.numel() * t.element_size() for t in cache)
    bf16_bytes = 2 * cfg.n_layers * LM_BATCH * cfg.n_kv_heads * max_len * cfg.d_head * 2
    info = dict(build_cache_s=build_s, decode_ms_per_token=(t2 - t1) * 1e3 / (LM_TOKENS - 1),
                decode_tokens_per_s=LM_BATCH * (LM_TOKENS - 1) / (t2 - t1),
                bf16_decode_ms_per_token=bf16_ms,
                resident_bytes=resident, peak_bytes=peak, launches_by_route=routes,
                cache_bytes=nbytes, bf16_cache_bytes=bf16_bytes,
                cache_ratio=nbytes / bf16_bytes, profile=trace, quantize_host_us=quantize_us)
    log(f"lm int8: {cfg.name} over the int8 KV cache, {LM_BATCH} x {LM_PROMPT}-token prompts, "
        f"{LM_TOKENS - 1} decode steps fed the bf16 run's tokens: decode "
        f"{info['decode_ms_per_token']:.2f} ms/token (the bf16 leg's, earlier: "
        f"{bf16_ms:.2f}), peak_GiB={peak / 2**30:.3f} "
        f"resident_GiB={resident / 2**30:.3f}; cache {nbytes / 1e9:.3f} GB against "
        f"{bf16_bytes / 1e9:.3f} GB in bf16 (ratio {info['cache_ratio']:.4f}); B7 launches "
        f"by route {routes}; _quantize_kv of a layer's k and v rows {quantize_us:.1f} us "
        f"on the host")

    # the check: impl='torch' from a copy of the same cache, the same tokens
    steps_err, near_ties = [], 0
    for i in range(1, LM_TOKENS):
        ref, copy = TR.decode_step(plainq, params, copy, ref_tokens[i - 1], LM_PROMPT + i)
        err = float((logits[i] - ref).abs().max())
        steps_err.append(dict(step=i, err=err, bound=bounds[i]))
        if err > bounds[i]:
            raise AssertionError(f"lm int8: step {i}: max |logit diff| {err} against "
                                 f"impl='torch' > the bf16 leg's bound {bounds[i]}")
        top2 = ref.topk(2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]) > bounds[i]
        if bool((decided & (logits[i].argmax(-1) != ref.argmax(-1))).any()):
            raise AssertionError(f"lm int8: step {i}: a greedy token differs from "
                                 f"impl='torch' where the top-1/top-2 gap exceeds {bounds[i]}")
        near_ties += int((~decided).sum())
    del copy, ref
    worst = max(steps_err, key=lambda st: st["err"] / st["bound"])
    agree = int((logits.argmax(-1) == ref_tokens).sum())
    soft = max(float((torch.softmax(logits[i], -1) - torch.softmax(ref_logits[i], -1))
                     .abs().max()) for i in range(LM_TOKENS))
    info.update(teacher_forced=steps_err, max_err_over_bound=worst["err"] / worst["bound"],
                tokens_within_bound_of_a_tie=near_ties, greedy_agree_with_bf16=agree,
                greedy_tokens=LM_TOKENS * LM_BATCH, max_softmax_dist_from_bf16=soft)
    log(f"lm int8: impl='torch' from a copy of the same cache: worst step {worst['step']} "
        f"max |logit diff| {worst['err']:.4g} against the bf16 leg's bound "
        f"{worst['bound']:.4g}; greedy tokens agree where the gap exceeds it ({near_ties} "
        f"within it); against the bf16 cache run: {agree} of {LM_TOKENS * LM_BATCH} greedy "
        f"tokens equal, post-softmax distance at most {soft:.4g}")
    calls = b7_calls(cfgq, params, prompts, cache, ref_tokens,
                     {0: "decode,local,int8", 5: "decode,global,int8"}, prefill=False)
    del cache, logits
    return info, calls


def int8_entries(calls: dict, launches: int) -> list:
    """B7's int8 decode lines: the kernel against ``attention_int8_plain`` on
    the int8 leg's operands, timed by ``model_entry``.  Bound: bytes (q and
    the output in bf16, the visible int8 K/V rows and their bfloat16
    scales) over HBM; operations 4 D per visible query-key pair and one
    dequantizing multiply an element read, at the float32 rate.  Library: SDPA
    over a bf16 copy of the visible rows, dequantized beforehand (no PyTorch
    call both dequantizes and attends); checked at 2e-2 (bf16)."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA

    entries = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for variant, (q, k8, v8, kw) in calls.items():
        rest = {o: x for o, x in kw.items() if o != "scales"}
        sk, sv = kw["scales"]
        B, Hq, Sq, D = q.shape
        Hkv, Sk = k8.shape[1], k8.shape[2]
        lo, hi = FA.visible_rows(Sq, Sk, True, kw.get("window"), kw.get("q_offset", 0))
        rows = hi - lo
        nbytes, flops = attention_int8_work(q, k8, kw)
        kd = FA.dequantize_kv(k8[:, :, lo:hi], sk[:, :, lo:hi]).to(q.dtype)
        vd = FA.dequantize_kv(v8[:, :, lo:hi], sv[:, :, lo:hi]).to(q.dtype)
        e = model_entry(
            "flash_attention_decode_int8", variant,
            lambda: FA.flash_attention(q, k8, v8, **kw),
            lambda: FA.attention_int8_plain(q, k8, v8, sk, sv, **rest),
            {"sdpa_dequantized_bf16": lambda: F.scaled_dot_product_attention(
                q, kd, vd, enable_gqa=True)},
            nbytes, flops, F32_FLOP_PER_S, 1e-3, 2.0 ** -7, launches, library_tol=2e-2)
        splits, chunk = FA.decode_splits(B, Hkv, rows, sms)
        e.update(kernel_route="decode_int8", visible_rows=rows, splits=splits, chunk=chunk,
                 blocks=B * Hkv * splits)
        log(f"kernels: {e['name']} walks {rows} int8 rows in {splits} splits of {chunk}: "
            f"{B * Hkv * splits} blocks on {sms} SMs")
        entries.append(e)
        del kd, vd
    return entries


def b7_calls(cfg, params, prompts, cache, tokens, capture: dict,
             prefill: bool = True) -> dict:
    """B7's operands on the serve path, {variant: (q, k, v, options)}: the
    prefill's calls at the layers ``capture`` names ({layer: 'prefill,...'})
    unless ``prefill`` is false, and the last decode step's at the same
    layers ('decode,...')."""
    from repro_torch.models import transformer as TR

    calls = {}
    if prefill:
        with AttentionCapture(capture) as cap:
            TR.prefill(cfg, params, prompts, LM_PROMPT + LM_TOKENS)
        args = cap.check(cfg.n_layers, "prefill")
        calls = {capture[i]: args[i] for i in capture}
    with AttentionCapture(capture) as cap:           # idempotent: rewrites the last row
        TR.decode_step(cfg, params, cache, tokens[LM_TOKENS - 2], LM_PROMPT + LM_TOKENS - 1)
    args = cap.check(cfg.n_layers, "decode step")
    calls.update({capture[i].replace("prefill", "decode"): args[i] for i in capture})
    return calls


def b7_entries(calls: dict, serve_routes: dict, routes32: dict, model: str = "") -> list:
    """B7's kernel lines: the kernel against its plain version on captured
    calls of a serve path ({variant: (q, k, v, options)}), in bf16 and cast
    to float32, timed by ``model_entry``.  ``serve_routes`` and ``routes32``
    are the launches by route of the bf16 serve run and of the float32 run;
    ``model`` (with a comma) starts each line's variant."""
    from repro_torch.kernels import flash_attention as FA

    entries = []
    # bf16: kernel and plain version both sum in float32 and round the output
    # once, so they may differ by one bf16 rounding: atol 1e-3, rtol 2^-7
    # (the tensor-core kernel also rounds p to bf16 before p @ v, which moves
    # each term by at most 2^-9 of its weight).  float32: the main path's
    # operands cast up, through the float32 routes, at the float32 tolerance
    # 2e-5.  The library (SDPA) rounds p to bf16 before p @ v, so it is
    # checked at 2e-2 (bf16) and 1e-4 (f32).  Each line is named by the route
    # its call takes (FA.attention_route) and counts that route's launches
    # in the run it belongs to: the bf16 serve path, or the float32 run.
    kernel_of = {"tc": "flash_attention_tc", "decode": "flash_attention_decode",
                 "simt": "flash_attention"}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for dtype, tag, tol, lib_tol, rate, counts in (
            (torch.bfloat16, "", (1e-3, 2.0 ** -7), 2e-2, BF16_FLOP_PER_S, serve_routes),
            (torch.float32, ",f32", (2e-5, 2e-5), 1e-4, F32_FLOP_PER_S, routes32)):
        for variant, ops in calls.items():
            q, k, v = (t.to(dtype) for t in ops[:3])
            kw = ops[3]
            nbytes, pairs = attention_work(q, k, kw)
            B, Hq, Sq, D = q.shape
            Hkv = k.shape[1]
            route = FA.attention_route(dtype, D, Sq, Hq // Hkv)
            e = model_entry(
                kernel_of[route], model + variant + tag,
                lambda: FA.flash_attention(q, k, v, **kw),
                lambda: FA.attention_plain(q, k, v, **kw), attention_library(q, k, v, kw),
                nbytes, 4.0 * D * pairs, rate, *tol, counts[route], library_tol=lib_tol)
            e["kernel_route"] = route
            if route == "decode":
                lo, hi = FA.visible_rows(Sq, k.shape[2], True, kw.get("window"),
                                         kw.get("q_offset", 0))
                splits, chunk = FA.decode_splits(B, Hkv, hi - lo, sms)
                e.update(visible_rows=hi - lo, splits=splits, chunk=chunk,
                         blocks=B * Hkv * splits)
                log(f"kernels: {e['name']} walks {hi - lo} rows in {splits} splits of "
                    f"{chunk}: {B * Hkv * splits} blocks on {sms} SMs")
                if variant == "decode,global" and B * Hkv * splits < sms:
                    raise AssertionError(f"lm: the global decode launches {B * Hkv * splits} "
                                         f"blocks, fewer than the card's {sms} SMs")
            if route == "tc" and variant == "prefill,global":
                # the three tensor maps this call's wrapper encodes (q, k, v),
                # by the code the kernel's entry point runs, 1,000 times
                e["tensor_map_encode_us"] = tc_encode_us(q, k, v, kw)
                log(f"kernels: {e['name']} encoding its 3 tensor maps (q, k, v) takes "
                    f"{e['tensor_map_encode_us']:.3f} us on the host (mean of 1,000)")
            entries.append(e)
            del q, k, v
    return entries


# =========================================================================
# mixture of experts: OLMoE-1B-7B (B7)
# =========================================================================
OLMOE_CAPTURE = {0: "prefill,global"}    # layer -> B7 variant (every OLMoE layer is global)
ROUTE_TIE = 1e-6              # float32: a gate gap below this may route either way


class RouteCapture:
    """Records the MoE routing of every call of ``transformer.top_k`` (one
    call a layer) under the label set in ``label``: the chosen experts as a
    sorted set [G, S, K] and the gap between the K-th and (K+1)-th largest
    gate [G, S].  Patches the module attribute ``_moe_groups`` calls
    through, and restores it on exit."""

    def __init__(self):
        from repro_torch.models import transformer as TR

        self.TR, self.label, self.calls = TR, None, {}

    def __enter__(self):
        self.orig = self.TR.top_k

        def wrapped(gates, k):
            w, i = self.orig(gates, k)
            srt = torch.sort(gates, dim=-1, descending=True, stable=True).values
            self.calls.setdefault(self.label, []).append(
                (i.sort(dim=-1).values, srt[..., k - 1] - srt[..., k]))
            return w, i

        self.TR.top_k = wrapped
        return self

    def __exit__(self, *exc):
        self.TR.top_k = self.orig

    def take(self, label: str, n_layers: int) -> list:
        """The records of ``label`` since the last take, one a layer."""
        recs = self.calls.pop(label, [])
        if len(recs) != n_layers:
            raise AssertionError(f"olmoe: {label} routed {len(recs)} layers, want {n_layers}")
        return recs


def route_flips(got: list, want: list, tainted: torch.Tensor, step: int,
                tie: float | None) -> dict:
    """Counts, over a step's layers, the tokens whose expert set differs
    between two runs (``got`` and ``want``: RouteCapture records of one
    step).  With ``tie`` (float32) each difference must be explained: a root
    flip, where ``want``'s K-th/(K+1)-th gate gap is under ``tie``, or a
    token that an earlier root flip has already changed (``tainted`` [G, S]:
    in a row, the positions at and after a root flip from the next layer
    on, and every later decode step; updated in place).  Else it raises."""
    diff_total = root_total = 0
    new_taint = torch.zeros_like(tainted)
    for layer, ((gs, _), (ws, wgap)) in enumerate(zip(got, want)):
        diff = (gs != ws).any(dim=-1)
        tainted |= new_taint
        diff_total += int(diff.sum())
        if tie is None:
            continue
        root = diff & (wgap < tie)
        bad = diff & ~root & ~tainted
        if bool(bad.any()):
            g, t = (int(x) for x in bad.nonzero()[0])
            raise AssertionError(f"olmoe: step {step} layer {layer}: {int(bad.sum())} tokens "
                                 f"routed differently (first: row {g} position {t}, gate gap "
                                 f"{float(wgap[g, t]):.3g} >= {tie})")
        root_total += int(root.sum())
        # a root flip at position t changes that row at t and after, from the next layer on
        new_taint |= root.int().cummax(dim=-1).values.bool()
    tainted |= new_taint
    return dict(differ=diff_total, root=root_total)


def phase_olmoe() -> tuple:
    """Returns (report dict, kernel lines of B7); see the module docstring's
    phase 7a."""
    from repro_torch.configs.olmoe_1b_7b import CONFIG, SMOKE
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import transformer as TR

    t_phase = time.perf_counter()
    info = dict(smoke=lm_smoke_check(SMOKE, "olmoe"))
    # the tie rule on the card: equal gates choose the lower experts first
    ties = (torch.arange(4 * 64, device="cuda").view(4, 64) % 3 == 0).float() / 4
    got, want = TR.top_k(ties, 8)[1].cpu(), TR.top_k(ties.cpu(), 8)[1]
    if not torch.equal(got, want) or got[0].tolist() != [0, 3, 6, 9, 12, 15, 18, 21]:
        raise AssertionError(f"olmoe: top_k on the card breaks ties as {got[0].tolist()}")
    cfg, dev = CONFIG, torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = TR.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"olmoe: {n_params} parameters, config says {cfg.param_count()}")
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=gen, device=dev)
    max_len = LM_PROMPT + LM_TOKENS
    m = cfg.moe
    info.update(config=cfg.name, params=n_params, active_params=cfg.active_param_count(),
                experts=m.n_experts, top_k=m.top_k, capacity_prefill=m.capacity(LM_PROMPT),
                capacity_decode=m.capacity(1), batch=LM_BATCH, prompt=LM_PROMPT,
                new_tokens=LM_TOKENS, max_len=max_len, init_s=time.perf_counter() - t0)
    run = lm_serve(cfg, params, prompts, "olmoe")
    info.update(run["info"])
    tokens, cache = run["tokens"], run["cache"]
    serve_routes = info["launches_by_route"]
    del run
    log(f"olmoe: {n_params:,} parameters = CONFIG.param_count() ({info['active_params']:,} "
        f"active a token), capacity {info['capacity_prefill']} a row in the prefill and "
        f"{info['capacity_decode']} in decode; prefill {info['prefill_tokens_per_s']:.0f} "
        f"tokens/s, decode {info['decode_tokens_per_s']:.1f} tokens/s")
    info["profile"] = dict(
        prefill=traced(lambda: TR.prefill(cfg, params, prompts, max_len), top=8),
        decode_step=traced(lambda: TR.decode_step(cfg, params, cache, tokens[LM_TOKENS - 2],
                                                  LM_PROMPT + LM_TOKENS - 1), top=8))
    for k, rec in info["profile"].items():
        log_trace(f"profile: olmoe {k}", rec)
    calls = b7_calls(cfg, params, prompts, cache, tokens, OLMOE_CAPTURE)
    del cache
    free_memory()

    # Teacher-forced on the served tokens: impl='cuda' in bf16 again (its
    # routing recorded), impl='torch' in bf16, and the same model in float32
    # (the bf16 weights cast up) through impl='cuda' and impl='torch'.  The
    # MoE layers are the same code under both impls; only the attention's
    # summation order differs, and a near tie of two gates may then route a
    # token another way.  float32: logits within 1e-3 of the step's max
    # |logit| on every row no root flip has reached, and every routing
    # difference explained (``route_flips``).  bf16: within twice the plain
    # bf16 run's own distance from float32 where no token of the step routed
    # differently; where one did, the step is reported and held by the
    # float32 check (bf16 gates tie often; the flips are counted, not bounded).
    runs = dict(cuda=(cfg, params), torch=(dataclasses.replace(cfg, impl="torch"), params))
    params32 = tree_map(torch.Tensor.float, params)
    runs.update(cuda32=(dataclasses.replace(cfg, dtype=torch.float32), params32),
                torch32=(dataclasses.replace(cfg, impl="torch", dtype=torch.float32), params32))
    caches, out = {}, {}
    tainted32 = torch.zeros(LM_BATCH, LM_PROMPT, dtype=torch.bool, device=dev)
    steps, flipped16 = [], 0
    launches = {label: dict.fromkeys(FA.ROUTES, 0) for label in runs}
    with RouteCapture() as rc:
        for i in range(LM_TOKENS):
            for label, (c, p) in runs.items():
                rc.label = label
                before = {r: FA.LAUNCHES["flash_attention_" + r] for r in FA.ROUTES}
                if i == 0:
                    out[label], caches[label] = TR.prefill(c, p, prompts, max_len)
                else:
                    out[label], caches[label] = TR.decode_step(c, p, caches[label],
                                                               tokens[i - 1], LM_PROMPT + i)
                for r in FA.ROUTES:
                    launches[label][r] += FA.LAUNCHES["flash_attention_" + r] - before[r]
            rec = {label: rc.take(label, cfg.n_layers) for label in runs}
            if i == 1:                 # decode: one position a row, tainted if any was
                tainted32 = tainted32.any(dim=-1, keepdim=True)
            f32 = route_flips(rec["cuda32"], rec["torch32"], tainted32, i, ROUTE_TIE)
            b16 = route_flips(rec["cuda"], rec["torch"], tainted32, i, None)
            flipped16 += b16["differ"]
            c16, t16, c32, t32 = (out[k] for k in ("cuda", "torch", "cuda32", "torch32"))
            if not all(bool(torch.isfinite(x).all()) for x in (c16, t16, c32, t32)):
                raise AssertionError(f"olmoe: step {i}: non-finite logits")
            clean = ~tainted32.any(dim=-1)             # rows no root flip has reached
            top32 = float(t32.abs().max())
            err32 = float((c32 - t32).abs().max(dim=-1).values[clean].max()) \
                if bool(clean.any()) else 0.0
            if err32 > 1e-3 * top32:
                raise AssertionError(f"olmoe: step {i}: float32 impl cuda vs torch max |logit "
                                     f"diff| {err32} > 1e-3 x {top32}")
            gap32 = t32.topk(2, dim=-1).values
            decided32 = ((gap32[:, 0] - gap32[:, 1]) > 1e-3 * top32) & clean
            if bool((decided32 & (c32.argmax(-1) != t32.argmax(-1))).any()):
                raise AssertionError(f"olmoe: step {i}: a float32 greedy token differs where "
                                     f"the top-1/top-2 gap exceeds {1e-3 * top32}")
            top = float(t16.abs().max())
            own = float((t16 - t32).abs().max())       # the plain run's bf16 error
            err = float((c16 - t16).abs().max())
            held = err <= 2 * own
            if not held and flipped16 == 0:
                raise AssertionError(f"olmoe: step {i}: bf16 max |logit diff| {err} > 2 x "
                                     f"{own} with every token routed alike so far")
            steps.append(dict(step=i, f32_err=err32, f32_bound=1e-3 * top32, max_logit=top,
                              f32_rows_checked=int(clean.sum()), f32_route_diff=f32["differ"],
                              f32_root_flips=f32["root"], bf16_err=err, bf16_bound=2 * own,
                              bf16_held=held, bf16_route_diff=b16["differ"]))
    # B7 in the teacher-forced runs: bf16 as served; float32 through the
    # CUDA-core prefill and the split-K decode; the plain runs none
    decode = cfg.n_layers * (LM_TOKENS - 1)
    want = dict(cuda=serve_routes, torch=dict.fromkeys(FA.ROUTES, 0),
                cuda32=dict(tc=0, decode=decode, simt=cfg.n_layers),
                torch32=dict.fromkeys(FA.ROUTES, 0))
    if launches != want:
        raise AssertionError(f"olmoe: B7 routes of the teacher-forced runs {launches}, "
                             f"want {want}")
    routes32 = info["f32_launches_by_route"] = launches["cuda32"]
    if steps[-1]["f32_rows_checked"] == 0:
        raise AssertionError("olmoe: root flips reached every row: the float32 logits were "
                             "held on none")
    del caches, out, params32, runs, params
    free_memory()
    info.update(
        teacher_forced=steps,
        f32_max_abs_logit_err=max(st["f32_err"] for st in steps),
        f32_max_err_over_bound=max(st["f32_err"] / st["f32_bound"] for st in steps),
        f32_route_diff=sum(st["f32_route_diff"] for st in steps),
        f32_root_flips=sum(st["f32_root_flips"] for st in steps),
        f32_rows_checked_last=steps[-1]["f32_rows_checked"],
        bf16_route_diff=sum(st["bf16_route_diff"] for st in steps),
        bf16_steps_held=sum(st["bf16_held"] for st in steps),
        bf16_max_err_over_bound=max(st["bf16_err"] / st["bf16_bound"] for st in steps))
    log(f"olmoe: float32, impl='cuda' vs impl='torch' with teacher forcing: max |logit diff| "
        f"{info['f32_max_abs_logit_err']:.4g}, at most {info['f32_max_err_over_bound']:.4g} of "
        f"the bound (1e-3 x the step's max |logit|) on the {info['f32_rows_checked_last']} of "
        f"{LM_BATCH} rows no root flip reached; {info['f32_route_diff']} token-layers routed "
        f"differently, {info['f32_root_flips']} of them root flips (gate gap < {ROUTE_TIE})")
    log(f"olmoe: bf16, impl='cuda' vs impl='torch' with teacher forcing: "
        f"{info['bf16_route_diff']} token-layers routed differently; {info['bf16_steps_held']} "
        f"of {LM_TOKENS} steps within 2 x plain bf16 vs float32 (worst "
        f"{info['bf16_max_err_over_bound']:.4g} of it)")
    entries = b7_entries(calls, serve_routes, routes32, model="olmoe,")
    del calls
    free_memory()
    info["wall_s"] = time.perf_counter() - t_phase
    log(f"olmoe: phase {info['wall_s']:.1f}s")
    return info, entries


def dlrm_smoke_check() -> dict:
    """DLRM-RM2 SMOKE: the port on the card through the kernel against the
    port on the CPU; rtol 1e-5 on the scores."""
    from repro_torch.configs.dlrm_rm2 import SMOKE
    from repro_torch.models import dlrm as DM

    gen = torch.Generator().manual_seed(SEED)
    params = DM.init_params(SMOKE, gen, device="cpu")
    on_card = tree_map(torch.Tensor.cuda, params)
    dense = torch.randn(64, SMOKE.n_dense, generator=gen)
    sparse = torch.randint(-1, 512, (64, SMOKE.n_sparse, 3), generator=gen, dtype=torch.int32)
    sm = dataclasses.replace(SMOKE, multi_hot=3)
    err = close(DM.serve_score(sm, on_card, dense.cuda(), sparse.cuda()).cpu(),
                DM.serve_score(sm, params, dense, sparse), 0.0, 1e-5, "dlrm smoke serve_score")
    log(f"dlrm: SMOKE (3 lookups a field, padding) on the card equals the CPU port, "
        f"max_abs_err {err:.3g} (rtol 1e-5)")
    return dict(max_abs_err=err)


def phase_dlrm() -> tuple:
    """Returns (report dict, kernel lines of B8)."""
    import torch.nn.functional as F

    from repro_torch.configs.dlrm_rm2 import CONFIG, SHAPES
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.models import dlrm as DM

    info = dict(smoke=dlrm_smoke_check())
    cfg, dev = CONFIG, torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = DM.init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    info.update(config=cfg.name, params=cfg.param_count(), init_s=time.perf_counter() - t0,
                table_bytes=sum(t.numel() * t.element_size() for t in params["tables"]))

    def batch(n):
        return (torch.randn(n, cfg.n_dense, generator=gen, device=dev),
                torch.randint(0, cfg.vocabs()[0], (n, cfg.n_sparse, cfg.multi_hot),
                              generator=gen, device=dev, dtype=torch.int32))

    cand = torch.randn(DLRM_CANDIDATES, cfg.embed_dim, generator=gen, device=dev)
    calls = {name: batch(SHAPES[name]["batch"]) for name in ("serve_p99", "serve_bulk")}
    calls["retrieval_cand"] = batch(1)

    def run(name, c=cfg):
        if name == "retrieval_cand":
            return DM.retrieval_score(c, params, *calls[name], cand, top_k=DLRM_TOP_K)
        return DM.serve_score(c, params, *calls[name])

    for name in calls:
        run(name)                 # warm-up; the allocator keeps its blocks
    gc.collect()
    rows = {}
    EB.reset_launches()           # the count is 0 just before the serve path
    outs = {}
    for name in calls:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev0.record()
        outs[name] = run(name)
        ev1.record()
        torch.cuda.synchronize()
        rows[name] = dict(batch=calls[name][0].shape[0], ms=ev0.elapsed_time(ev1),
                          peak_bytes=torch.cuda.max_memory_allocated(), resident_bytes=base)
    launches = EB.LAUNCHES["embedding_bag"]       # read just after
    want = len(calls)             # one launch a forward, for all of its tables
    if launches != want:
        raise AssertionError(f"dlrm: B8 launched {launches} times on the serve path, want {want}")
    for name, row in rows.items():
        row["median_ms_of_10"] = time_ms(lambda: run(name))
        log(f"dlrm: {name:14s} batch={row['batch']:7d} ms={row['ms']:.3f} "
            f"median_ms={row['median_ms_of_10']:.3f} peak_GiB={row['peak_bytes'] / 2**30:.3f} "
            f"resident_GiB={row['resident_bytes'] / 2**30:.3f}")
    info["profile"] = {name: traced(lambda: run(name)) for name in calls}
    for name, rec in info["profile"].items():
        log_trace(f"profile: dlrm {name}", rec)
    # impl='torch' on the same inputs: rtol 1e-5 on scores, the same top-k ids
    plain = dataclasses.replace(cfg, impl="torch")
    errs = {}
    for name, got in outs.items():
        ref = run(name, plain)
        if name == "retrieval_cand":
            if not torch.equal(got.indices, ref.indices):
                raise AssertionError("dlrm: retrieval top-k ids differ between impls")
            got, ref = got.values, ref.values
        errs[name] = close(got, ref, 0.0, 1e-5, f"dlrm {name}")
        rows[name]["max_abs_err_vs_torch"] = errs[name]
    log(f"dlrm: impl='torch' agrees (rtol 1e-5; retrieval ids equal): max_abs_err {errs}; "
        f"B8 launches {launches}")
    info.update(shapes=rows, launches=launches)
    del outs, cand

    # B8 on the bulk batch's first table, as forward calls it
    table = params["tables"][0]
    idx = calls["serve_bulk"][1][:, 0, :].contiguous()
    n_bags = idx.shape[0]
    uniq = int(torch.unique(idx[idx >= 0]).numel())
    nbytes, flops = embedding_bags_work(n_bags, idx.shape[1], cfg.embed_dim, [uniq])
    idx_long = idx.long()
    entry = model_entry("embedding_bag", f"sum,B={n_bags}",
                        lambda: EB.embedding_bag(table, idx, "sum"),
                        lambda: EB.embedding_bag_plain(table, idx, "sum"),
                        lambda: F.embedding_bag(idx_long, table, mode="sum"),
                        nbytes, flops, F32_FLOP_PER_S, 2e-5, 2e-5, launches)
    del idx_long
    entries = [entry, dlrm_batched_entry(EB, params["tables"], calls["serve_bulk"][1], launches)]
    del params, calls
    free_memory()
    return info, entries


def dlrm_batched_entry(EB, tables, idx, launches: int) -> dict:
    """B8 as the DLRM forward calls it: one launch over all tables on the
    bulk batch's indices [B, F, L].  Held equal (torch.equal) to its plain
    version and to the F single-table calls.  Its library call is
    F.embedding_bag over one packed copy of the tables with each feature's
    indices shifted by its table's offset (the copy is made outside the
    timing and freed after).  Beside the line's ``host_us``: the summed
    host time, single-call and back-to-back ms of the F single-table calls
    (``singles_*``) on contiguous index columns made beforehand."""
    import torch.nn.functional as F

    n_bags, n_tab, L = idx.shape
    D = tables[0].shape[1]
    cols = [idx[:, f].contiguous() for f in range(n_tab)]
    got = EB.embedding_bags(tables, idx, "sum")
    singles = lambda: [EB.embedding_bag(t, c, "sum") for t, c in zip(tables, cols)]
    torch.cuda.synchronize()
    if not torch.equal(got, torch.stack(singles(), dim=1)):
        raise AssertionError("kernel embedding_bag: the batched launch differs from "
                             "its single-table calls")
    identical(got, EB.embedding_bags_plain(tables, idx, "sum"), "kernel embedding_bag[tables]")
    del got
    nbytes, flops = embedding_bags_work(n_bags, L, D, [int(torch.unique(c[c >= 0]).numel())
                                                       for c in cols])
    vocabs = [t.shape[0] for t in tables]
    packed = torch.cat(tables)
    offs = torch.tensor([0] + vocabs[:-1], device=idx.device).cumsum(0)
    shifted = (idx.long() + offs[None, :, None]).reshape(n_bags * n_tab, L)
    e = model_entry("embedding_bag", f"tables={n_tab},sum,B={n_bags}",
                    lambda: EB.embedding_bags(tables, idx, "sum"),
                    lambda: EB.embedding_bags_plain(tables, idx, "sum"),
                    lambda: F.embedding_bag(shifted, packed, mode="sum").view(n_bags, n_tab, D),
                    nbytes, flops, F32_FLOP_PER_S, 0.0, 0.0, launches, library_tol=2e-5)
    del packed, shifted
    e.update(tables=n_tab, singles_host_us=host_us(singles), singles_ms=time_ms(singles),
             singles_b2b_ms=b2b_ms(singles))
    log(f"kernels: embedding_bag[tables={n_tab}] equals its plain version and its {n_tab} "
        f"single-table calls; host_us {e['host_us']:.1f} against {e['singles_host_us']:.1f} "
        f"for the {n_tab} calls (ms {e['ms']:.4f} against {e['singles_ms']:.4f})")
    free_memory()
    return e


# =========================================================================
# GNN inference: PNA, EGNN, MeshGraphNet, SchNet over a sampled graph (B5)
# =========================================================================
def gnn_modules():
    from repro_torch.configs import egnn, meshgraphnet, pna, schnet
    from repro_torch.models import gnn as G

    configs = {"pna": pna, "egnn": egnn, "meshgraphnet": meshgraphnet, "schnet": schnet}
    apply = {"pna": G.pna_apply, "egnn": G.egnn_apply, "meshgraphnet": G.mgn_apply,
             "schnet": G.schnet_apply}
    return G, configs, apply


def b5_per_forward(arch: str, cfg) -> int:
    """B5 launches of one forward, from models/gnn.py: PNA's degree, then per
    layer its mean and the std's mean of squares (a sum and a count each);
    EGNN per layer the coordinate mean (sum and count) and the message sum;
    MeshGraphNet one sum per layer; SchNet one per interaction."""
    if arch == "schnet":
        return cfg.n_interactions
    return {"pna": 1 + 4 * cfg.n_layers, "egnn": 3 * cfg.n_layers,
            "meshgraphnet": cfg.n_layers}[arch]


def gnn_graph(info: dict, gen: torch.Generator):
    """The deployment's graph on the card: ``n_nodes`` nodes and ``n_edges``
    directed edges, sources drawn in proportion to lognormal(0, 1) node
    weights (a heavy-tailed degree), destinations uniform; the CSR built by
    ``CSR.from_edge_index`` on the card; a float32 feature table
    ``[n_nodes, d_feat]`` of Normal(0, 1)."""
    from repro_torch.graphdata.sampler import CSR

    dev = gen.device
    N, E = info["n_nodes"], info["n_edges"]
    w = torch.exp(torch.randn(N, generator=gen, device=dev, dtype=torch.float64))
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    u = torch.rand(E, generator=gen, device=dev, dtype=torch.float64)
    src = torch.searchsorted(cdf, u).clamp_max_(N - 1).to(torch.int32)
    del u, w, cdf
    dst = torch.randint(0, N, (E,), generator=gen, device=dev, dtype=torch.int32)
    csr = CSR.from_edge_index(src, dst, N, device=dev)
    del src, dst
    feats = torch.randn(N, info["d_feat"], generator=gen, device=dev)
    return csr, feats


class ScatterCapture:
    """Keeps the operands of the first call of each channel count C of the
    B5 wrapper that the models call through (the package attribute), and
    restores it on exit."""

    def __init__(self):
        from repro_torch.kernels import bucket_scatter as BS

        self.BS, self.args = BS, {}

    def __enter__(self):
        self.orig = self.BS.bucket_scatter

        def wrapped(contrib, seg_ids, n, layout=None, impl="cuda"):
            self.args.setdefault(contrib.shape[1], (contrib, seg_ids, n, layout))
            return self.orig(contrib, seg_ids, n, layout, impl)

        self.BS.bucket_scatter = wrapped
        return self

    def __exit__(self, *exc):
        self.BS.bucket_scatter = self.orig


def gnn_agreement(G, apply, cfg, params, feats, batches, preds) -> float:
    """impl='torch' against impl='cuda' on the timed requests' sampled
    batches: every output of the forward, and the timed run's predictions at
    the seeds, within GNN_TOL of each output's max |value|; returns the
    largest error over that max."""
    plain = dataclasses.replace(cfg, impl="torch")
    worst = 0.0
    for (gids, src, dst), pred in zip(batches, preds):
        x = feats[gids.long()]
        g = G.GraphBatch(node_feat=x, edge_src=src, edge_dst=dst, coords=x[:, :3])
        got, ref = apply(cfg, params, g), apply(plain, params, g)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for a, b in zip((pred,) + got, (ref[0][:pred.shape[0]],) + ref):
            scale = max(float(b.abs().max()), 1e-30)
            err = close(a, b, GNN_TOL * scale, 0.0, f"gnn {cfg.name} impl cuda vs torch")
            worst = max(worst, err / scale)
    return worst


def b5_entry(arch: str, C: int, contrib, seg, n: int, layout, launches: int) -> dict:
    """B5 against its plain version on operands of a request (float32,
    tolerance 1e-4 as in the reference's sweep), timed beside
    ``index_add_``."""
    from repro_torch.kernels import bucket_scatter as BS

    E, seg_long = contrib.shape[0], seg.long()
    return model_entry(
        "bucket_scatter", f"{arch},C={C}",
        lambda: BS.bucket_scatter(contrib, seg, n, layout),
        lambda: BS.bucket_scatter_plain(contrib, seg, n),
        lambda: torch.zeros((n, C), device=contrib.device).index_add_(0, seg_long, contrib),
        4.0 * (E * C + n * C) + 8.0 * (n + 1), 1.0 * E * C, F32_FLOP_PER_S,
        1e-4, 1e-4, launches)


def phase_gnn() -> tuple:
    """Returns (report dict, kernel lines of B5)."""
    from repro_torch.configs.common import GNN_SHAPES
    from repro_torch.graphdata.sampler import sample_union_graph
    from repro_torch.kernels import bucket_scatter as BS

    G, configs, apply = gnn_modules()
    info = dict(GNN_SHAPES[GNN_SHAPE])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    csr, feats = gnn_graph(info, gen)
    torch.cuda.synchronize()
    N, F, S, fanout = info["n_nodes"], info["d_feat"], info["batch_nodes"], info["fanout"]
    free_memory()
    graph_bytes = sum(t.numel() * t.element_size() for t in (csr.indptr, csr.indices, feats))
    deg = (csr.indptr[1:] - csr.indptr[:-1]).long()
    info.update(seed=SEED, generate_s=time.perf_counter() - t0, graph_bytes=graph_bytes,
                max_degree=int(deg.max()), degree_0_nodes=int((deg == 0).sum()),
                n_edges_built=int(csr.indices.numel()), requests=GNN_REQUESTS)
    if info["n_edges_built"] != info["n_edges"]:
        raise AssertionError("gnn: the CSR does not hold every edge")
    log(f"gnn: {GNN_SHAPE} graph on the card: {N} nodes, {info['n_edges']} edges (max degree "
        f"{info['max_degree']}, {info['degree_0_nodes']} of degree 0), features {N} x {F} "
        f"float32; {graph_bytes / 2**30:.3f} GiB resident; made in {info['generate_s']:.1f}s")
    del deg

    def request(arch, cfg, params, seeds, marks=None):
        """One request: sample → gather → forward (the ``GraphBatch`` with
        its CSR pointer, then ``*_apply``); returns the predictions at the
        seeds and the sampled ids.  ``marks``: 4 CUDA events."""
        def mark(i):
            if marks:
                marks[i].record()

        mark(0)
        gids, src, dst = sample_union_graph(csr, seeds, fanout, gen)
        mark(1)
        x = feats[gids.long()]
        mark(2)
        g = G.GraphBatch(node_feat=x, edge_src=src, edge_dst=dst, coords=x[:, :3])
        out = apply[arch](cfg, params, g)
        pred = (out[0] if isinstance(out, tuple) else out)[:S]
        mark(3)
        return pred, (gids, src, dst)

    archs, entries = {}, []
    total_b5 = 0
    want_b5 = sum(b5_per_forward(a, configs[a].CONFIG) for a in GNN_ARCHS) * GNN_REQUESTS
    for arch in GNN_ARCHS:
        cfg = configs[arch].CONFIG
        params = G.INIT[arch](cfg, gen, F, device=dev)
        n_params = sum(t.numel() for t in leaves(params))
        seeds = [torch.randperm(N, generator=gen, device=dev)[:S].to(torch.int32)
                 for _ in range(GNN_REQUESTS + 1)]
        request(arch, cfg, params, seeds[0])       # warm-up; the allocator keeps its blocks
        gc.collect()
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        rows, batches, preds, peak = [], [], [], 0
        BS.reset_launches()           # the count is 0 just before the requests
        for i in range(1, GNN_REQUESTS + 1):
            torch.cuda.reset_peak_memory_stats()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            pred, batch = request(arch, cfg, params, seeds[i], ev)
            torch.cuda.synchronize()
            peak = max(peak, torch.cuda.max_memory_allocated())
            rows.append(dict(sample_ms=ev[0].elapsed_time(ev[1]),
                             gather_ms=ev[1].elapsed_time(ev[2]),
                             forward_ms=ev[2].elapsed_time(ev[3]),
                             request_ms=ev[0].elapsed_time(ev[3])))
            batches.append(batch)
            preds.append(pred)
        launches = BS.LAUNCHES["bucket_scatter"]    # read just after
        want = b5_per_forward(arch, cfg) * GNN_REQUESTS
        if launches != want:
            raise AssertionError(f"gnn {arch}: B5 launched {launches} times, want {want}")
        total_b5 += launches
        med = {k: float(np.median([r[k] for r in rows])) for k in rows[0]}
        n_sub, e_sub = int(batches[0][0].numel()), int(batches[0][1].numel())
        prof = traced(lambda: request(arch, cfg, params, seeds[1]))

        worst = gnn_agreement(G, apply[arch], cfg, params, feats, batches, preds)
        del batches, preds
        archs[arch] = dict(params=n_params, union_nodes=n_sub, union_edges=e_sub,
                           b5_launches=launches, b5_per_request=launches // GNN_REQUESTS,
                           median=med, requests=rows, resident_bytes=resident,
                           peak_bytes=peak, request_peak_bytes=peak - resident,
                           err_over_max_output=worst, profile=prof)
        log(f"gnn: {arch:12s} {n_params} params, {GNN_REQUESTS} requests of {S} seeds "
            f"({n_sub} nodes, {e_sub} edges): median request {med['request_ms']:.3f} ms = "
            f"sample {med['sample_ms']:.3f} + gather {med['gather_ms']:.3f} + forward "
            f"{med['forward_ms']:.3f}; peak_GiB={peak / 2**30:.3f} resident_GiB="
            f"{resident / 2**30:.3f}; B5 launches {launches}; impl torch within "
            f"{worst:.3g} of max |output| (bound {GNN_TOL})")
        log_trace(f"profile: gnn {arch} request", prof)

        # B5 on this model's operands in a request.  Launches: the phase's
        # count, which each model's check above holds to want_b5.
        with ScatterCapture() as cap:
            request(arch, cfg, params, seeds[1])
        entries += [b5_entry(arch, C, *cap.args[C], want_b5) for C in GNN_B5_LINES.get(arch, ())]
        del params, cap
        free_memory()
    info.update(archs=archs, b5_launches=total_b5)
    del csr, feats
    free_memory()
    return info, entries


# =========================================================================
# the architecture registry: every config's smoke on the card
# =========================================================================
def phase_registry() -> dict:
    """``load_arch(a).smoke()`` for every id of ``ARCH_IDS`` on the card
    (the default device): each must be ok, with a finite loss where it has
    one; granite-ldbc's engine counts must equal its oracle's
    (``RefEngine``).  Each smoke's kernel launches are read from the
    counters, set to 0 just before it."""
    import importlib
    import math

    from repro_torch.configs import ARCH_IDS, load_arch
    from repro_torch.kernels import bucket_scatter as BS
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import hop_scatter as HK

    counters = (FA, BS, EB, HK)
    t_phase = time.perf_counter()
    out = {}
    for arch in ARCH_IDS:
        spec = load_arch(arch)
        for mod in counters:
            mod.reset_launches()
        t0 = time.perf_counter()
        res = spec.smoke()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k: v for mod in counters for k, v in mod.LAUNCHES.items() if v}
        if not res.get("ok") or ("loss" in res and not math.isfinite(res["loss"])):
            raise AssertionError(f"registry: {arch} smoke failed: {res}")
        smoke = getattr(importlib.import_module(
            f"repro_torch.configs.{arch.replace('-', '_')}"), "SMOKE", None)
        attention = None
        if spec.family.startswith("lm"):
            attention = "cuda" if smoke.d_head in FA.HEAD_DIMS else \
                f"plain (SMOKE d_head {smoke.d_head} has no kernel)"
            # a SMOKE width B7 was built for must run on it
            if attention == "cuda" and not launches.get("flash_attention"):
                raise AssertionError(f"registry: {arch}'s SMOKE has d_head {smoke.d_head}, "
                                     f"which B7 takes, and never launched it: {launches}")
        out[arch] = dict(family=spec.family, s=dt, launches=launches, attention=attention,
                         **{k: list(v) if isinstance(v, tuple) else v for k, v in res.items()})
        log(f"registry: {arch} ({spec.family}) ok"
            + (f" loss={res['loss']:.6g}" if "loss" in res else "")
            + (f" counts (engine, oracle) {res['counts']}" if "counts" in res else "")
            + (f" attention {attention}" if attention else "")
            + f" launches {launches} in {dt:.2f}s")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"registry: {len(ARCH_IDS)} smokes ok; phase {out['wall_s']:.1f}s")
    return out


# =========================================================================
# training: MiniCPM-2B at full width
# =========================================================================
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
TRAIN_STEPS = 4               # timed, after one warm-up step
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 1e-2, 5e-2   # two layers: bf16 against float32
TRAIN_CKPT = ROOT / "build" / "chip_train_ckpt"     # not launch/train.py's --ckpt-dir
# the failure lands after step 3, off the step-2 checkpoint: step 3 is replayed
TRAIN_RUNNER = dict(batch=1, seq=256, steps=4, ckpt_every=2, fail_at=3)


def train_smoke_check() -> dict:
    """minicpm-2b SMOKE (float32): the loss and every gradient leaf of one
    ``value_and_grad`` on the card against the port on the CPU, which the
    CPU tests hold to the JAX package; atol 2e-5."""
    from repro_torch.configs.minicpm_2b import SMOKE
    from repro_torch.launch.train import synthetic_lm_batches
    from repro_torch.models import transformer as TR
    from repro_torch.training import tree as T
    from repro_torch.training.train_loop import value_and_grad

    params = TR.init_params(SMOKE, torch.Generator().manual_seed(SEED), device="cpu")
    batch = synthetic_lm_batches(SMOKE.vocab, 4, 64, 1, seed=SEED, device="cpu")[0]
    loss_fn = lambda p, b: TR.loss_fn(SMOKE, p, b)
    l_card, g_card = value_and_grad(loss_fn, tree_map(torch.Tensor.cuda, params),
                                    tree_map(torch.Tensor.cuda, batch))
    l_cpu, g_cpu = value_and_grad(loss_fn, params, batch)
    err = close(l_card.cpu(), l_cpu, 2e-5, 0.0, "train smoke loss")
    for (path, a), b in zip(T.leaves_with_paths(g_card), T.leaves(g_cpu)):
        err = max(err, close(a.cpu(), b, 2e-5, 0.0, f"train smoke gradient {path}"))
    log(f"train: SMOKE on the card equals the CPU port: loss and {len(T.leaves(g_cpu))} "
        f"gradient leaves, max_abs_err {err:.3g} (atol 2e-5)")
    return dict(max_abs_err=err)


def timed_step(step, params, state, batch) -> tuple:
    """One train step timed by CUDA events, with the memory resident before
    it and its peak: (params, state, row)."""
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    params, state, m = step(params, state, batch)
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b)
    tokens = batch["tokens"].numel()
    row = dict(ms=ms, tokens_per_s=tokens / ms * 1e3, loss=float(m["loss"]),
               grad_norm=float(m["grad_norm"]), lr=float(m["lr"]),
               peak_bytes=torch.cuda.max_memory_allocated(), resident_bytes=resident)
    return params, state, row


def phase_train() -> dict:
    """MiniCPM-2B training on the card (``training/``, ``launch/train.py``'s
    data and schedule); see the module docstring's phase 10."""
    from repro_torch.configs import minicpm_2b as MC
    from repro_torch.launch.train import synthetic_lm_batches
    from repro_torch.models import transformer as TR
    from repro_torch.training import checkpoint as CK
    from repro_torch.training import tree as T
    from repro_torch.training.fault import FaultTolerantRunner
    from repro_torch.training.optimizer import init_state
    from repro_torch.training.train_loop import make_train_step

    t_phase = time.perf_counter()
    info = dict(smoke=train_smoke_check())
    cfg, dev = MC.CONFIG, torch.device("cuda")
    n_steps = 1 + TRAIN_STEPS
    opt_cfg = MC.get_arch().meta["opt"]       # the published WSD schedule, 100 warm-up steps
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = TR.init_params(cfg, gen, device=dev)
    state = init_state(params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in T.leaves(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"train: {n_params} parameters, config says {cfg.param_count()}")
    state_gib = sum(t.numel() * t.element_size() for t in T.leaves((params, state))) / 2**30
    batch = synthetic_lm_batches(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ, 1, seed=SEED, device=dev)[0]
    info.update(config=cfg.name, params=n_params, state_gib=state_gib, batch=TRAIN_BATCH,
                seq=TRAIN_SEQ, remat=cfg.remat, init_s=time.perf_counter() - t0,
                opt=dataclasses.asdict(opt_cfg), steps=[])
    log(f"train: minicpm-2b {n_params / 1e9:.3f} B params bf16 at full width, remat "
        f"{cfg.remat}; params and moments {state_gib:.2f} GiB; batch {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens (synthetic_lm_batches' first, every step); AdamW, WSD "
        f"warm-up {opt_cfg.warmup_steps} steps to lr {opt_cfg.lr}; init {info['init_s']:.1f}s")
    loss_fn = lambda p, b: TR.loss_fn(cfg, p, b)
    step1 = make_train_step(loss_fn, opt_cfg)                 # in place (donated)
    step2 = make_train_step(loss_fn, opt_cfg, microbatches=2)
    for i in range(n_steps + 1):
        mb = 2 if i == n_steps else 1       # the last: two microbatches
        params, state, row = timed_step(step1 if mb == 1 else step2, params, state, batch)
        row.update(step=i + 1, microbatches=mb, first_call=i == 0)
        info["steps"].append(row)
        log(f"train: minicpm-2b step {i + 1}{' (first call)' if i == 0 else ''} microbatches "
            f"{mb}: {row['ms']:.1f} ms, {row['tokens_per_s']:.0f} tokens/s, loss "
            f"{row['loss']:.4f}, grad_norm {row['grad_norm']:.4f}, lr {row['lr']:.3e}, "
            f"peak_GiB={row['peak_bytes'] / 2**30:.3f} "
            f"resident_GiB={row['resident_bytes'] / 2**30:.3f}")
    info["profile"] = traced(lambda: step1(params, state, batch), top=10)
    log_trace("profile: train step minicpm-2b", info["profile"])
    rows = info["steps"]
    if not all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in rows):
        raise AssertionError(f"train: non-finite loss or grad norm: {rows}")
    if not rows[-1]["loss"] < rows[0]["loss"]:
        raise AssertionError(f"train: loss {rows[0]['loss']} -> {rows[-1]['loss']}: not falling")
    del params, state
    free_memory()

    # ---- two layers at full width: bf16 against float32 on the same values
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    cfg32 = dataclasses.replace(cfg2, dtype=torch.float32)
    p_bf = tree_map(lambda t: t.to(torch.bfloat16), TR.init_params(cfg32, gen, device=dev))
    p32 = tree_map(lambda t: t.float(), p_bf)
    bf_step = make_train_step(lambda p, b: TR.loss_fn(cfg2, p, b), opt_cfg)
    p_bf, s_bf, r_bf = timed_step(bf_step, p_bf, init_state(p_bf), batch)
    p32, s32, r32 = timed_step(make_train_step(lambda p, b: TR.loss_fn(cfg32, p, b), opt_cfg),
                               p32, init_state(p32), batch)
    del p32, s32
    loss_rel = abs(r_bf["loss"] - r32["loss"]) / abs(r32["loss"])
    gn_rel = abs(r_bf["grad_norm"] - r32["grad_norm"]) / abs(r32["grad_norm"])
    n2 = sum(t.numel() for t in T.leaves(p_bf))
    info["two_layers"] = dict(params=n2, bf16=r_bf, float32=r32, loss_rel=loss_rel,
                              grad_norm_rel=gn_rel)
    log(f"train: two layers at full width ({n2 / 1e6:.1f} M params), one step: bf16 loss "
        f"{r_bf['loss']:.5f} grad_norm {r_bf['grad_norm']:.5f} ({r_bf['ms']:.1f} ms), float32 "
        f"loss {r32['loss']:.5f} grad_norm {r32['grad_norm']:.5f} ({r32['ms']:.1f} ms): "
        f"relative {loss_rel:.3g} (bound {TRAIN_LOSS_RTOL}), {gn_rel:.3g} "
        f"(bound {TRAIN_GNORM_RTOL})")
    if not (loss_rel <= TRAIN_LOSS_RTOL and gn_rel <= TRAIN_GNORM_RTOL):
        raise AssertionError("train: the bf16 step is outside its bounds of float32")

    # ---- checkpoint round trip of the two-layer bf16 state, then fault recovery
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    state2 = (p_bf, s_bf)
    ck_gib = sum(t.numel() * t.element_size() for t in T.leaves(state2)) / 2**30
    t0 = time.perf_counter()
    CK.save_async(state2, 1, str(TRAIN_CKPT / "roundtrip"))
    CK.wait_pending()
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, got_step = CK.restore(state2, str(TRAIN_CKPT / "roundtrip"))
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    for (path, a), b in zip(T.leaves_with_paths(got), T.leaves(state2)):
        if got_step != 1 or a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"train: checkpoint leaf {path} changed in the round trip")
    del got
    rc = TRAIN_RUNNER
    rbatches = synthetic_lm_batches(cfg.vocab, rc["batch"], rc["seq"], rc["steps"], seed=SEED,
                                    device=dev)

    calls = [0]

    def step_fn(st, b):
        calls[0] += 1
        p, s, m = bf_step(st[0], st[1], b)
        return (p, s), dict(loss=float(m["loss"]))

    runs = {}
    for name, fail in (("uninterrupted", None),
                       ("one failure", {rc["fail_at"]: RuntimeError("injected failure")})):
        t0 = time.perf_counter()
        calls[0] = 0
        r = FaultTolerantRunner(step_fn, T.tree_map(torch.clone, state2),
                                str(TRAIN_CKPT / name.replace(" ", "_")),
                                ckpt_every=rc["ckpt_every"])
        r.run(rbatches, fail_at=fail)
        runs[name] = (r, time.perf_counter() - t0, calls[0] - r.step)   # replayed steps
    (ra, sa, replay_a), (rb, sb, replay_b) = runs["uninterrupted"], runs["one failure"]
    if rb.recoveries != 1 or ra.recoveries != 0 or not ra.step == rb.step == rc["steps"]:
        raise AssertionError(f"train: runner recoveries {ra.recoveries}/{rb.recoveries}, "
                             f"steps {ra.step}/{rb.step}")
    if replay_a != 0 or replay_b < 1:
        raise AssertionError(f"train: the runner replayed {replay_b} steps after the failure "
                             f"({replay_a} uninterrupted): replay is not exercised")
    for (path, a), b in zip(T.leaves_with_paths(rb.state), T.leaves(ra.state)):
        if not torch.equal(a, b):
            raise AssertionError(f"train: after recovery {path} differs from the "
                                 "uninterrupted run")
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    info["checkpoint"] = dict(gib=ck_gib, write_s=write_s, read_s=read_s,
                              runner=dict(rc, uninterrupted_s=sa, one_failure_s=sb,
                                          replayed_steps=replay_b))
    log(f"train: checkpoint of the two-layer state ({ck_gib:.2f} GiB, "
        f"{len(T.leaves(state2))} leaves): save_async + wait {write_s:.2f}s, restore "
        f"{read_s:.2f}s, every leaf torch.equal; FaultTolerantRunner {rc['steps']} steps "
        f"(batch {rc['batch']} x {rc['seq']}, checkpoint every {rc['ckpt_every']}) with a "
        f"failure injected after step {rc['fail_at']}: 1 recovery, {replay_b} step(s) "
        f"replayed, parameters and moments torch.equal to the uninterrupted run "
        f"({sa:.1f}s / {sb:.1f}s)")
    del state2, p_bf, s_bf, ra, rb, runs
    free_memory()
    info["wall_s"] = time.perf_counter() - t_phase
    log(f"train: phase {info['wall_s']:.1f}s")
    return info


# =========================================================================
# the dry run and whole-step rooflines
# =========================================================================
DRYRUN_MESH = "both"          # single pod and multi-pod, both from one trace a cell
DRYRUN_JOBS = 4               # its worker processes: done well inside the train phase
DRYRUN_OUT = ROOT / "build" / "dryrun"
DRYRUN_WANT = "ok=82 skipped=6 errors=0"
DRYRUN_JOB = ("agg-min", 0)   # the main-path job counted: template, mode (static)


def dryrun_start() -> tuple:
    """``launch/dryrun.py --all --mesh both --jobs DRYRUN_JOBS`` in a child
    process on the host (no card: its tensors are all on ``meta``), writing
    its records under build/dryrun/ and its output to build/dryrun.log.
    Returns (process, log file, start time)."""
    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    DRYRUN_OUT.mkdir(parents=True)
    out = open(ROOT / "build" / "dryrun.log", "w")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                             "--mesh", DRYRUN_MESH, "--jobs", str(DRYRUN_JOBS),
                             "--out", str(DRYRUN_OUT)],
                            stdout=out, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
    return proc, out, time.perf_counter()


def meta_twin(tree):
    """Tensors of a tree of dicts and tuples as ``meta`` tensors of the same
    shapes, strides and dtypes."""
    if isinstance(tree, dict):
        return {k: meta_twin(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(meta_twin(v) for v in tree)
    return torch.empty_strided(tree.shape, tree.stride(), dtype=tree.dtype, device="meta")


def main_job_twin(graph, jobs, rows) -> dict:
    """The main-path job ``DRYRUN_JOB`` as the dense executor runs it, on
    ``meta`` twins of the graph's device arrays, with its timed row."""
    from repro_torch.core import engine as E
    from repro_torch.core import query as Q

    t, mode = DRYRUN_JOB
    j = next(i for i, (name, m, _, _) in enumerate(jobs) if name == t and m == mode)
    _, _, split, batch = jobs[j]
    row = rows[j]
    if row["engine"] != "dense":
        raise AssertionError(f"dryrun: main job {t} ran on the {row['engine']} executor")
    params = np.stack([Q.query_params(q) for q in batch])
    return dict(qry=batch[0], split=split, mode=mode, row=row,
                gdev=meta_twin(E.prepare_gdev(graph, "cuda")),
                params=torch.empty(params.shape, dtype=torch.int32, device="meta"),
                bedges=meta_twin(E.bucket_edges_for(graph, 16, "cuda")))


def whole_steps(job: dict) -> list:
    """(name, shape, the call on meta, measured ms, where the ms comes from)
    for the steps the script times: each the same call at the same shapes
    on ``meta`` tensors, at mesh 1 x 1."""
    from repro_torch.configs import dlrm_rm2, gemma3_4b, minicpm_2b, olmoe_1b_7b
    from repro_torch.core import engine as E
    from repro_torch.models import dlrm as DM
    from repro_torch.models import transformer as TR
    from repro_torch.training.optimizer import init_state
    from repro_torch.training.train_loop import make_train_step

    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    max_len = LM_PROMPT + LM_TOKENS
    prompts = meta((LM_BATCH, LM_PROMPT), torch.long)
    toks = meta((LM_BATCH,), torch.long)
    n = LM_PROMPT + LM_TOKENS // 2           # the middle of the timed decode steps
    g = gemma3_4b.CONFIG
    gp = TR.init_shapes(g)
    cshape = (g.n_layers, LM_BATCH, g.n_kv_heads, max_len, g.d_head)
    cache = (meta(cshape, g.dtype), meta(cshape, g.dtype))
    cache8 = (meta(cshape, torch.int8), meta(cshape, torch.int8),
              meta(cshape[:-1], torch.bfloat16), meta(cshape[:-1], torch.bfloat16))
    g8 = dataclasses.replace(g, kv_cache_quant=True)
    o = olmoe_1b_7b.CONFIG
    op = TR.init_shapes(o)
    m = minicpm_2b.CONFIG
    mp = TR.init_shapes(m)
    ms = init_state(mp)
    mb = dict(tokens=meta((TRAIN_BATCH, TRAIN_SEQ), torch.int32),
              labels=meta((TRAIN_BATCH, TRAIN_SEQ), torch.int32))
    train = make_train_step(lambda p, b: TR.loss_fn(m, p, b), minicpm_2b.get_arch().meta["opt"])
    train_ms = float(np.median([r["ms"] for r in REPORT["train"]["steps"]
                                if r["microbatches"] == 1 and not r["first_call"]]))
    d = dlrm_rm2.CONFIG
    dp = DM.init_shapes(d)
    B = dlrm_rm2.SHAPES["serve_bulk"]["batch"]
    dense, sparse = meta((B, d.n_dense), torch.float32), meta((B, d.n_sparse, d.multi_hot),
                                                               torch.int32)
    row = job["row"]
    return [
        ("gemma3-4b prefill", f"{LM_BATCH} x {LM_PROMPT}",
         lambda: TR.prefill(g, gp, prompts, max_len), REPORT["lm"]["prefill_ms"], "lm prefill"),
        ("gemma3-4b decode step", f"{LM_BATCH} x 1, cache_len {n} of {max_len}",
         lambda: TR.decode_step(g, gp, cache, toks, n), REPORT["lm"]["decode_ms_per_token"],
         "lm decode ms/token"),
        ("gemma3-4b decode step int8", f"{LM_BATCH} x 1, cache_len {n} of {max_len}",
         lambda: TR.decode_step(g8, gp, cache8, toks, n),
         REPORT["lm"]["int8"]["decode_ms_per_token"], "lm int8 decode ms/token"),
        ("olmoe-1b-7b prefill", f"{LM_BATCH} x {LM_PROMPT}",
         lambda: TR.prefill(o, op, prompts, max_len), REPORT["olmoe"]["prefill_ms"],
         "olmoe prefill"),
        ("minicpm-2b train step", f"{TRAIN_BATCH} x {TRAIN_SEQ}, remat {m.remat}",
         lambda: train(mp, ms, mb), train_ms, "train: median of the timed steps"),
        ("dlrm-rm2 serve", f"batch {B}", lambda: DM.serve_score(d, dp, dense, sparse),
         REPORT["dlrm"]["shapes"]["serve_bulk"]["median_ms_of_10"], "dlrm serve_bulk median"),
        (f"main {row['template']} {row['mode']}", f"Q={row['batch']}, split {job['split']}",
         lambda: E.execute_plan(job["gdev"], job["qry"], job["split"], job["mode"], 16,
                                job["params"], job["bedges"], impl="cuda"),
         row["cuda_ms"], "main cuda_ms"),
    ]


def phase_dryrun(dry: tuple, job: dict, kernels: list, smi: str) -> dict:
    """(a) joins the dry run's child (``dryrun_start``): its summary must
    read ``DRYRUN_WANT``; (b) counts each whole step of ``whole_steps`` on
    ``meta`` with ``roofline.analysis.count_program`` and prints its FLOPs
    by dtype, bytes, bound at the H100's peaks (the larger of the compute
    and memory terms) and what bounds it, the measured ms and the share
    (bound / measured); (c) counts B7's global prefill call on ``meta`` and
    holds its bytes, operations and bound to that row of the kernel table."""
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.roofline import analysis as RA

    proc, out, t0 = dry
    rc = proc.wait(timeout=900)
    wall = time.perf_counter() - t0
    out.close()
    text = (ROOT / "build" / "dryrun.log").read_text()
    summary = next((ln for ln in text.splitlines() if ln.startswith("DRYRUN SUMMARY")), None)
    log(f"dryrun: launch/dryrun.py --all --mesh {DRYRUN_MESH} --jobs {DRYRUN_JOBS} in a child "
        f"process: rc {rc}, "
        f"{summary}; wall {wall:.1f}s from its start (before the train phase)")
    if rc != 0 or summary != f"DRYRUN SUMMARY: {DRYRUN_WANT}":
        raise AssertionError(f"dryrun: want '{DRYRUN_WANT}' and rc 0; the log's tail: "
                             f"{text[-2000:]}")
    info = dict(rc=rc, summary=summary, child_wall_s=wall, card=smi, steps=[])
    for name, shape, fn, ms, source in whole_steps(job):
        c = RA.count_program(fn, ())
        t_c, t_m = c.compute_s(), c.memory_s()
        bound_ms, by = (t_c * 1e3, "operations") if t_c >= t_m else (t_m * 1e3, "bytes")
        st = dict(name=name, shape=shape, flops=c.flops, bytes=c.bytes, ops=c.ops,
                  kernels=c.kernels, bound_ms=bound_ms, bound_by=by, compute_ms=t_c * 1e3,
                  memory_ms=t_m * 1e3, measured_ms=ms, measured=source, share=bound_ms / ms,
                  trace_s=c.seconds)
        info["steps"].append(st)
        log(f"roofline: {name} [{shape}]: flops bf16 {c.flops['bf16']:.4e} f32 "
            f"{c.flops['f32']:.4e}, bytes {c.bytes:.4e}; bound {bound_ms:.4f} ms ({by}; "
            f"compute {t_c * 1e3:.4f}, memory {t_m * 1e3:.4f}); measured {ms:.4f} ms "
            f"({source}); share {bound_ms / ms:.4f}; {smi}")
    # B7's global prefill: the dry run's count of one call against its kernel line
    from repro_torch.configs.gemma3_4b import CONFIG as g

    row = next(e for e in kernels if e["name"] == "flash_attention_tc[prefill,global]")
    q = torch.empty((LM_BATCH, g.n_heads, LM_PROMPT, g.d_head), dtype=g.dtype, device="meta")
    kv = torch.empty((LM_BATCH, g.n_kv_heads, LM_PROMPT, g.d_head), dtype=g.dtype,
                     device="meta")
    c = RA.count_program(lambda: FA.flash_attention(q, kv, kv, causal=True, window=None), ())
    b_ms, b_by = bound(c.bytes, c.flops["bf16"], BF16_FLOP_PER_S)
    if (c.bytes, c.flops["bf16"], b_ms, b_by) != (row["bytes"], row["flops"], row["bound_ms"],
                                                  row["bound_by"]):
        raise AssertionError(f"dryrun: the count of B7's global prefill ({c.bytes}, {c.flops}, "
                             f"{b_ms}) differs from its kernel line ({row['bytes']}, "
                             f"{row['flops']}, {row['bound_ms']})")
    info["kernel_row_check"] = dict(name=row["name"], bytes=c.bytes, flops=c.flops["bf16"],
                                    bound_ms=b_ms)
    log(f"dryrun: the count of B7's global prefill equals its kernel line: bytes "
        f"{c.bytes:.6g}, operations {c.flops['bf16']:.6g}, bound {b_ms:.4f} ms ({b_by})")
    return info


def main(argv=None) -> int:
    warnings.filterwarnings("ignore", message="Sparse")
    warnings.filterwarnings("ignore", message="Warning: Profiler clears events")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", default=str(ROOT / "build" / "chip_smoke.json"),
                    help="where the full JSON report is written")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    t_mark = [t_start]

    def lap(name: str) -> None:    # the seconds since the last lap, logged and kept
        now = time.perf_counter()
        REPORT.setdefault("phase_s", {})[name] = now - t_mark[0]
        log(f"wall: {name} {now - t_mark[0]:.1f}s")
        t_mark[0] = now

    smi = phase_device()
    from repro_torch.kernels import hop_scatter as HK

    phase_build()
    phase_oracle()
    lap("device, build, oracle")
    rec = Recorder(HK)
    REPORT["main"], graph, jobs = phase_main(rec)
    lap("main")
    REPORT["profile"] = phase_profile(graph, jobs)
    lap("profile")
    rec.capture(lambda j: run_job(graph, jobs[j]))
    kernels = phase_kernels(rec, REPORT["main"]["launches"], graph)
    kernels += warp_entries(graph, jobs)
    rec.inputs.clear()            # the kernels phase's operands: not the server's memory
    free_memory()
    lap("kernels")
    REPORT["partitioned"], part_kernels = phase_partitioned(graph, jobs,
                                                           REPORT["main"]["rows"])
    kernels += part_kernels
    lap("partitioned")
    served = {}
    REPORT["serve"] = phase_serve(graph, served)
    lap("serve")
    REPORT["live"] = phase_live(graph, served)
    lap("live")
    for e in kernels[:len(kernels) - len(part_kernels)]:   # B1-B3 on the serve paths
        base = e["name"].split("[")[0]
        for phase in ("serve", "live"):
            if base in REPORT[phase]["launches"]:
                e[f"{phase}_launches"] = REPORT[phase]["launches"][base]
    job = main_job_twin(graph, jobs, REPORT["main"]["rows"])
    del rec, graph, jobs, served
    free_memory()
    REPORT["lm"], lm_kernels = phase_lm()
    lap("lm")
    REPORT["olmoe"], olmoe_kernels = phase_olmoe()
    lap("olmoe")
    REPORT["dlrm"], dlrm_kernels = phase_dlrm()
    lap("dlrm")
    REPORT["gnn"], gnn_kernels = phase_gnn()
    lap("gnn")
    REPORT["registry"] = phase_registry()
    lap("registry")
    kernels += lm_kernels + olmoe_kernels + dlrm_kernels + gnn_kernels
    free_memory()
    dry = dryrun_start()           # on the host, beside the device-bound train phase
    try:
        REPORT["train"] = phase_train()
        lap("train")
        REPORT["dryrun"] = phase_dryrun(dry, job, kernels, smi)
        lap("dryrun")
    finally:
        if dry[0].poll() is None:
            dry[0].kill()
            dry[0].wait()
        dry[1].close()
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
