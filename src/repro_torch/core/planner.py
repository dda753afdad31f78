"""Cost-model query planner (Sec. 5 of the paper).

Two pieces:

1. **Cardinality recurrences** (Eq. 1–4): per superstep, estimate active and
   matched vertex/edge counts from the graph statistics (`stats.GraphStats`),
   with the paper's ⊗ aggregation of clause frequencies (Eq. 5–6: min for
   AND, max for OR, degree-weighted averages).

2. **Execution-time model**: the paper fits per-phase linear models
   (I, C, S, CC, IC) from micro-benchmarks.  Granite's supersteps are dense
   tensor programs whose cost is driven by the *type-sliced* vertex/edge
   extents plus the estimated message volume (the distributed exchange term),
   so our linear model is

     T_i = θ0 + θ_v·|V_σi| + θ_e·|Ē_slice(σ_{i+1})| + θ_etr·[etr]·|Ē_slice|
           + θ_m·m̄_i

   fitted by least squares over micro-benchmarks
   (scripts/torch_fit_cost_model.py),
   stored as JSON, reusable across graphs/queries on the same host — exactly
   the paper's methodology with phase extents adapted to the dense engine.

   **Distribution-aware extension**: when the planner is given a
   ``Partitioning`` (graphdata.partitioner), per-superstep compute extents
   are divided over the workers and a per-superstep PER-CHANNEL exchange
   term

     θ_net · m_state_i  +  θ_net_etr · m_etr_i

   is added, where the m's are the STRUCTURAL boundary volumes of that
   superstep on the executor's point-to-point exchange: ``m_state_i`` is the
   partitioner's halo ghost-entry count for plain hops (doubled when the
   MIN/MAX extremum channel rides the same lanes), ``m_etr_i`` the boundary
   rank-summary count for ETR hops (cut edges, whose producers' per-segment
   prefix tables live with the source-segment owner).  These are exactly the
   ragged lane volumes the executor moves (``superstep.p2p_exchange``) and
   the volumes the two θ_net coefficients are fitted against from measured
   partitioned supersteps (engine_partitioned.measure_supersteps, whose
   ``exchange_channels`` report the same three channels), keeping the model,
   the fit and the executor in one unit (paper Sec. 5's communication
   phase).  Every query class (plain counts, COUNT and MIN/MAX aggregates,
   ETR hops) is costed on the distributed path — plan selection has no
   dense-only fallback.

What matters (paper Sec. 5): not absolute accuracy but *discriminating good
plans from bad*.

The port's copy of the reference package's ``core/planner.py`` (numpy only),
with the port's hop-delivery lowerings: ``'torch'`` (plain ops, the
reference's ``'xla'``) and ``'cuda'`` (the hand-written hop kernels, the
reference's ``'pallas'``).  Fitted coefficients live in the port's own
``configs/cost_coeffs.json`` (``scripts/torch_fit_cost_model.py`` writes it
on the card), θ_net and θ_net_etr included (fitted from the port's
``engine_partitioned.measure_supersteps``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import query as Q
from .stats import GraphStats, HEntry

DEFAULT_COEFFS = {
    # fallback, overwritten by scripts/torch_fit_cost_model.py on the card
    "theta0": 0.2,        # ms per superstep (dispatch/barrier)
    "theta_v": 2.0e-5,    # ms per vertex in the typed slice
    "theta_e": 6.0e-5,    # ms per traversal edge in the hop slice
    "theta_etr": 8.0e-5,  # extra ms per edge on ETR hops (sort-prefix path)
    "theta_m": 2.0e-5,    # ms per estimated delivered message
    "theta_init": 2.0e-5, # ms per vertex evaluated at init
    "theta_net": 8.0e-5,  # ms per boundary vertex-state entry (plain/extremum
                          # channels of the point-to-point exchange)
    "theta_net_etr": 8.0e-5,  # ms per boundary ETR rank summary (cut edges)
    # per-impl hop-DELIVERY slope (ms per traversal edge in the hop slice):
    # the measured cost of the gather → mask → segment-reduce step under
    # each lowering (scripts/torch_fit_cost_model fits both from hop-delivery
    # micro-benches).  The estimate applies the DELTA from the torch slope,
    # so impl='torch' plans cost exactly what the historical model says
    # (theta_e already folds the torch delivery in) and the impl sweep
    # discriminates on the fitted difference alone.  Defaults are 0 → tie →
    # torch.
    "theta_scatter_torch": 0.0,
    "theta_scatter_cuda": 0.0,
}

#: the impl axis plan selection sweeps when asked to choose a lowering (the
#: reference's order, so a tie resolves to the plain lowering as there)
HOP_IMPL_CHOICES = ("torch", "cuda")

#: canonical coefficient basis: a PlanEstimate's ``features`` vector is
#: indexed by this tuple, and ``t_ms == features @ coeff_vector(coeffs)``
#: EXACTLY (the scatter-delta trick is encoded as +e/w on the chosen impl's
#: column and -e/w on the torch column, so impl='torch' contributes zero).  This
#: is the contract the serving telemetry's online refit relies on: refitting
#: θ over recorded (features, measured) dispatch rows re-calibrates the very
#: predictions admission control makes.
COEFF_KEYS = ("theta0", "theta_init", "theta_v", "theta_e", "theta_etr",
              "theta_m", "theta_net", "theta_net_etr",
              "theta_scatter_torch", "theta_scatter_cuda")
_CK = {k: i for i, k in enumerate(COEFF_KEYS)}


def coeff_vector(coeffs: dict) -> np.ndarray:
    """The θ vector over the COEFF_KEYS basis (missing keys → defaults)."""
    return np.asarray([float(coeffs.get(k, DEFAULT_COEFFS.get(k, 0.0)))
                       for k in COEFF_KEYS])


_COEFF_PATH = os.path.join(os.path.dirname(__file__), "..", "configs", "cost_coeffs.json")


def load_coeffs(path: Optional[str] = None) -> dict:
    p = path or _COEFF_PATH
    if os.path.exists(p):
        with open(p) as f:
            return {**DEFAULT_COEFFS, **json.load(f)}
    return dict(DEFAULT_COEFFS)


def save_coeffs(coeffs: dict, path: Optional[str] = None) -> None:
    p = path or _COEFF_PATH
    os.makedirs(os.path.dirname(p), exist_ok=True)
    with open(p, "w") as f:
        json.dump(coeffs, f, indent=2)


# ---------------------------------------------------------------- estimates
@dataclasses.dataclass
class StepEstimate:
    a_v: float       # active vertices (Eq. 1)
    f_v: float       # histogram frequency for the vertex predicate
    m_v: float       # matched vertices (Eq. 2)
    a_e: float       # active edges (Eq. 3)
    f_e: float       # edge-predicate frequency
    m_e: float       # matched edges / messages (Eq. 4)
    t_ms: float      # estimated superstep time (per-worker makespan if W > 1)
    v_slice: float   # typed vertex extent processed
    e_slice: float   # typed traversal-edge extent processed
    etr: bool
    m_net: float = 0.0  # estimated cross-partition boundary messages
    #: feature row over the COEFF_KEYS basis (t_ms == features @ θ)
    features: Optional[np.ndarray] = None
    #: per-channel breakdown of m_net — (state, extremum, etr) structural
    #: boundary volumes of THIS hop (engine_partitioned.CHANNELS order; sums
    #: to m_net).  None on terminal (vertex-only) steps, so ``channels is
    #: not None`` identifies the hop steps a trace's superstep/exchange
    #: spans mirror.
    channels: Optional[Tuple[float, float, float]] = None


@dataclasses.dataclass
class PlanEstimate:
    split: int
    t_ms: float
    steps: List[StepEstimate]
    impl: str = "torch"  # hop-delivery lowering the estimate was costed at
    #: summed step features over COEFF_KEYS (t_ms == features @ coeff_vector);
    #: for estimate_batch, the batch-summed features
    features: Optional[np.ndarray] = None
    #: the full sweep choose()/choose_batch() ran to pick this plan: one
    #: dict(split, impl, t_ms, features) per candidate.  The flight
    #: recorder's plan span records these so an offline audit can re-cost
    #: the whole sweep under a trace-refit θ̂ (the paper's "% within X% of
    #: optimal plan" metric).  None when no sweep ran
    #: (direct estimate(), or use_planner=False).
    candidates: Optional[List[dict]] = None


def _clause_freq(stats: GraphStats, clauses: Sequence[Q.Clause], ent_type: int,
                 is_edge: bool) -> Tuple[float, float, float]:
    """⊗-aggregate clause frequencies (Eq. 5–6).  Returns (f, δin, δout)."""
    tot = stats.etype_count(ent_type) if is_edge else stats.type_count(ent_type)
    acc: Optional[HEntry] = None
    acc_conj_f = None
    for c in clauses:
        if c.kind == Q.K_PROP:
            h = stats.h_lookup(c.key, c.value, None, is_edge=is_edge)
            if c.cmp == Q.P_NEQ:
                h = HEntry(max(tot - h.f, 0.0), h.d_in, h.d_out)
        else:
            frac = stats.lifespan_frac(ent_type, tuple(c.interval), is_edge=is_edge)
            h = HEntry(frac * tot, 0.0, 0.0)
        if acc is None:
            acc = h
        else:
            if c.conj == Q.AND:
                f = min(acc.f, h.f)
            else:
                f = max(acc.f, h.f)
            wsum = max(acc.f + h.f, 1e-9)
            acc = HEntry(
                f,
                (acc.d_in * acc.f + h.d_in * h.f) / wsum,
                (acc.d_out * acc.f + h.d_out * h.f) / wsum,
            )
    if acc is None:
        return tot, 0.0, 0.0
    return acc.f, acc.d_in, acc.d_out


def estimate_segment(
    stats: GraphStats,
    v_preds: Sequence[Q.VertexPredicate],
    e_preds: Sequence[Q.EdgePredicate],
    coeffs: dict,
    trav_arrivals_by_type: np.ndarray,
    n_workers: int = 1,
    exchange_volume: float = 0.0,
    etr_exchange_volume: float = 0.0,
    extremum_channel: bool = False,
    impl: str = "torch",
) -> List[StepEstimate]:
    """Per-superstep estimates.  With ``n_workers > 1`` compute extents are
    divided over workers (balanced partitions) and each hop pays the θ_net
    exchange term: ``exchange_volume`` (halo ghost entries; doubled when the
    MIN/MAX ``extremum_channel`` rides along) on plain hops,
    ``etr_exchange_volume`` (boundary rank summaries — cut edges) on ETR
    hops.  ``impl`` selects the hop-delivery lowering being costed: each hop
    pays the fitted θ_scatter slope DELTA vs the torch baseline (zero for
    impl='torch', so the historical model is unchanged)."""
    steps: List[StepEstimate] = []
    prev_m_e = None
    w = max(1, int(n_workers))
    theta = coeff_vector(coeffs)
    for i, vp in enumerate(v_preds):
        V_sigma = stats.type_count(vp.vtype)
        if i == 0:
            a_v = V_sigma                                    # Eq. 1, init
        else:
            a_v = min(prev_m_e, V_sigma)                     # Eq. 1
        f_v, d_in, d_out = _clause_freq(stats, vp.clauses, vp.vtype, is_edge=False)
        if not vp.clauses:
            f_v = V_sigma
        m_v = a_v * (f_v / max(V_sigma, 1e-9))               # Eq. 2
        if i >= len(e_preds):
            steps.append(StepEstimate(a_v, f_v, m_v, 0, 0, 0, 0.0, V_sigma, 0.0,
                                      False, features=np.zeros(len(COEFF_KEYS))))
            break
        ep = e_preds[i]
        deg = stats.degree(vp.vtype, ep.etype, ep.direction)
        if deg == 0.0 and (d_in + d_out) > 0:
            deg = d_in + d_out                               # paper fallback δ
        a_e = m_v * max(deg, 0.0)                            # Eq. 3
        E_sigma = stats.etype_count(ep.etype)
        f_e, _, _ = _clause_freq(stats, ep.clauses, ep.etype, is_edge=True)
        if not ep.clauses:
            f_e = E_sigma
        sel_e = f_e / max(E_sigma, 1e-9)
        if ep.etr_op != -1:
            sel_e *= stats.etr_select.get(ep.etr_op, 0.5)    # beyond-paper term
        m_e = a_e * sel_e                                    # Eq. 4
        # ---- execution-time terms (dense type-sliced engine)
        nxt_type = v_preds[i + 1].vtype if i + 1 < len(v_preds) else -1
        e_slice = (
            float(trav_arrivals_by_type[nxt_type])
            if nxt_type >= 0
            else float(trav_arrivals_by_type.sum())
        )
        # structural boundary volume of this hop: what the executor's
        # point-to-point exchange actually moves (and what the per-channel
        # θ_net coefficients were fitted on) — ETR hops ship only the
        # boundary rank summaries of cut segments (see engine_partitioned)
        if w > 1:
            if ep.etr_op != -1:
                channels = (0.0, 0.0, float(etr_exchange_volume))
            else:
                channels = (float(exchange_volume),
                            float(exchange_volume) if extremum_channel
                            else 0.0, 0.0)
        else:
            channels = (0.0, 0.0, 0.0)
        m_net = sum(channels)
        # the superstep cost as a feature row over the COEFF_KEYS basis —
        # t is the dot product with θ, so the serving telemetry can refit θ
        # against measured dispatch times on exactly these columns
        feat = np.zeros(len(COEFF_KEYS))
        feat[_CK["theta0"]] = 1.0
        feat[_CK["theta_init" if i == 0 else "theta_v"]] = V_sigma / w
        feat[_CK["theta_e"]] = e_slice / w
        if ep.etr_op != -1:
            feat[_CK["theta_etr"]] = e_slice / w
            feat[_CK["theta_net_etr"]] = m_net
        else:
            # fused-hop saving applies to plain hops only: ETR hops
            # materialise per-edge counts by construction and only swap
            # the delivery step, which the fitted full-hop slope would
            # over-credit.  The delta-vs-torch encoding keeps impl='torch'
            # contributing exactly zero (historical model unchanged).
            base = "cuda" if impl == "cuda" else "torch"
            feat[_CK[f"theta_scatter_{base}"]] += e_slice / w
            feat[_CK["theta_scatter_torch"]] -= e_slice / w
            feat[_CK["theta_net"]] = m_net
        feat[_CK["theta_m"]] = max(m_e, 0.0) / w
        t = float(feat @ theta)
        steps.append(StepEstimate(a_v, f_v, m_v, a_e, f_e, m_e, t, V_sigma, e_slice,
                                  ep.etr_op != -1, m_net, features=feat,
                                  channels=channels))
        prev_m_e = max(m_e, 0.0)
    return steps


class Planner:
    def __init__(self, graph, stats: GraphStats, coeffs: Optional[dict] = None,
                 partitioning=None):
        """``partitioning``: an optional graphdata.partitioner.Partitioning
        (or PartitionArrays); when given, plan costs are per-worker makespans
        including the θ_net structural-exchange term from the partitioner's
        halo ghost counts."""
        self.g = graph
        self.stats = stats
        self.coeffs = coeffs or load_coeffs()
        self.n_workers = 1
        self.cut_frac = 0.0
        self.exchange_volume = 0.0
        self.etr_exchange_volume = 0.0
        if partitioning is not None:
            arrays = partitioning
            if not hasattr(arrays, "exchange_volume"):  # a Partitioning
                from ..graphdata.partitioner import build_partition_arrays
                arrays = build_partition_arrays(graph, partitioning)
            self.n_workers = int(arrays.n_workers)
            self.cut_frac = float(arrays.stats.get("edge_cut", 0.0))
            self.exchange_volume = float(arrays.exchange_volume())
            self.etr_exchange_volume = float(arrays.etr_exchange_volume())
        # traversal arrivals per vertex type (edge extent of a typed hop)
        deg = graph.in_degree.astype(np.int64) + graph.out_degree.astype(np.int64)
        self.trav_arrivals_by_type = np.zeros(graph.n_vertex_types, np.int64)
        np.add.at(self.trav_arrivals_by_type, graph.v_type, deg)
        # execution paths the fault layer has marked down (e.g. the
        # partitioned engine after a worker loss); the scheduler drives
        # these and consults engine_available before planning onto a path
        self.unavailable: set = set()

    # ------------------------------------------------- engine availability
    def mark_unavailable(self, engine: str) -> None:
        """Mark an execution path down (serving fault layer: a partitioned
        dispatch lost a worker; units re-plan dense until a probe clears)."""
        self.unavailable.add(engine)

    def mark_available(self, engine: str) -> None:
        self.unavailable.discard(engine)

    def engine_available(self, engine: str) -> bool:
        return engine not in self.unavailable

    def enumerate_plans(self, qry: Q.PathQuery) -> List[int]:
        if qry.agg_op != Q.AGG_NONE:
            return [0]
        return list(range(qry.n_vertices))

    def estimate(self, qry: Q.PathQuery, split: int,
                 impl: str = "torch") -> PlanEstimate:
        n = qry.n_vertices
        steps: List[StepEstimate] = []
        # MIN/MAX aggregates thread the extremum channel through the (right,
        # reversed) segment; its boundary state rides every plain exchange.
        extremum = qry.agg_op in (Q.AGG_MIN, Q.AGG_MAX)
        if split > 0:
            steps += estimate_segment(
                self.stats, qry.v_preds[: split + 1], qry.e_preds[:split],
                self.coeffs, self.trav_arrivals_by_type,
                n_workers=self.n_workers,
                exchange_volume=self.exchange_volume,
                etr_exchange_volume=self.etr_exchange_volume,
                impl=impl,
            )
        if (n - 1) - split > 0:
            rev = qry.reversed()
            m = (n - 1) - split
            steps += estimate_segment(
                self.stats, rev.v_preds[: m + 1], rev.e_preds[:m],
                self.coeffs, self.trav_arrivals_by_type,
                n_workers=self.n_workers,
                exchange_volume=self.exchange_volume,
                etr_exchange_volume=self.etr_exchange_volume,
                extremum_channel=extremum,
                impl=impl,
            )
        t = sum(s.t_ms for s in steps)
        feats = [s.features for s in steps if s.features is not None]
        features = (np.sum(feats, axis=0) if feats
                    else np.zeros(len(COEFF_KEYS)))
        return PlanEstimate(split, t, steps, impl, features)

    def choose(self, qry: Q.PathQuery,
               impls: Sequence[str] = ("torch",)) -> PlanEstimate:
        """Best (split, impl) over the plan space.  The default sweeps only
        the torch lowering (the historical behaviour); pass
        ``impls=HOP_IMPL_CHOICES`` to let the fitted per-impl θ_scatter term
        route hops onto the fused kernel where it wins — ties break toward
        the first entry (torch).  The swept candidates are recorded on the
        returned estimate (``candidates``) for the flight recorder."""
        best = None
        cands: List[dict] = []
        for split in self.enumerate_plans(qry):
            for impl in impls:
                est = self.estimate(qry, split, impl)
                cands.append(dict(split=split, impl=impl, t_ms=est.t_ms,
                                  features=est.features))
                if best is None or est.t_ms < best.t_ms:
                    best = est
        best.candidates = cands
        return best

    # ------------------------------------------------------- batched serving
    def estimate_batch(self, queries: Sequence[Q.PathQuery], split: int,
                       impl: str = "torch") -> PlanEstimate:
        """Cost a whole same-shape batch at one split point.

        Instances share the traced structure but not their parameter values,
        so predicate selectivities (clause-frequency lookups) differ per
        instance — the batch cost is the SUM of per-instance estimates, not
        the first instance's cost scaled.  The returned steps are the first
        instance's (for introspection); ``t_ms`` covers the batch.
        """
        assert queries, "empty batch"
        ests = [self.estimate(q, split, impl) for q in queries]
        return PlanEstimate(split, sum(e.t_ms for e in ests), ests[0].steps,
                            impl, np.sum([e.features for e in ests], axis=0))

    def choose_batch(self, queries: Sequence[Q.PathQuery],
                     impls: Sequence[str] = ("torch",)) -> PlanEstimate:
        """One (split, impl) for a same-shape batch, minimising whole-batch
        cost.

        This is the planner the batch scheduler uses: a batched group runs
        every instance at ONE split, so the right objective is the batch sum
        — picking the first instance's best split can lose when selectivities
        differ across instances (the old run_workload_batched bug).  The
        ``impls`` sweep mirrors ``choose()``: a group is dispatched on one
        hop-delivery lowering, so the impl is chosen batch-wide too."""
        assert queries, "empty batch"
        shape0 = queries[0].shape_key()
        for q in queries[1:]:
            if q.shape_key() != shape0:
                raise ValueError("batch planning needs same-shape queries")
        best = None
        cands: List[dict] = []
        for split in self.enumerate_plans(queries[0]):
            for impl in impls:
                est = self.estimate_batch(queries, split, impl)
                cands.append(dict(split=split, impl=impl, t_ms=est.t_ms,
                                  features=est.features))
                if best is None or est.t_ms < best.t_ms:
                    best = est
        best.candidates = cands
        return best


# -------------------------------------------------------------- fitting util
def fit_linear(features: np.ndarray, times_ms: np.ndarray) -> np.ndarray:
    """Least-squares fit; features [n, k] → coefficients [k]."""
    sol, *_ = np.linalg.lstsq(features, times_ms, rcond=None)
    return sol
