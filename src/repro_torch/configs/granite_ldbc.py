"""Granite, the query engine itself, as an architecture: distributed
temporal path queries at the paper's largest graph, 100k:F (Table 4: about
52 M vertices and 218 M edges, each padded to a multiple of 512).

Cells run the *paper's own technique*, ``core.engine.execute_plan``'s
supersteps under ``impl='torch'`` (the reference's ``impl='xla'``), at
that scale: traversal and ETR arrays edge-sharded over every mesh axis,
vertex offsets replicated (``_gdev_sds``, ``_gdev_shardings``, ``_cell``).
Here too are the two query shapes the cells run (``SHAPES``), their
analytic operation count and the smoke check: the engine against the
brute-force oracle on a 50-person LDBC graph.

``GRANITE_DRYRUN_SCALE=small``, read at import as the reference does, cuts
the scale to 100,000 vertices and 400,000 edges.
"""
import os
from functools import partial

import numpy as np
import torch

from ..core import engine as E
from ..core import intervals as iv
from ..core import query as Q
from . import common
from .common import P


# padding vertices and edges carry empty lifespans and never match
_pad512 = common.pad512


# 100k:F-S scale (paper Table 4); GRANITE_DRYRUN_SCALE=small for CI traces
if os.environ.get("GRANITE_DRYRUN_SCALE") == "small":
    V_FULL, E_FULL = _pad512(100_000), _pad512(400_000)
else:
    V_FULL = _pad512(52_000_000)
    E_FULL = _pad512(218_000_000)
N_VTYPES = 4
T_LIFE = 1096

_K_TAG, _K_COUNTRY = 0, 1


def _query_3hop_etr() -> Q.PathQuery:
    """Q1-shaped: Post(tag) ← Forum → Post(tag, ETR ≺) ← Person(country)."""
    return Q.PathQuery(
        v_preds=(
            Q.VertexPredicate(1, (Q.prop_clause(_K_TAG, "in", 7),)),
            Q.VertexPredicate(3, (Q.time_clause("overlaps", (100, T_LIFE)),)),
            Q.VertexPredicate(1, (Q.prop_clause(_K_TAG, "in", 9),)),
            Q.VertexPredicate(0, (Q.prop_clause(_K_COUNTRY, "==", 2),)),
        ),
        e_preds=(
            Q.EdgePredicate(4, Q.DIR_IN),
            Q.EdgePredicate(4, Q.DIR_OUT, etr_op=iv.STARTS_BEFORE),
            Q.EdgePredicate(3, Q.DIR_IN),
        ),
    )


def _query_2hop_agg() -> Q.PathQuery:
    return Q.PathQuery(
        v_preds=(
            Q.VertexPredicate(0, (Q.prop_clause(_K_COUNTRY, "==", 2),)),
            Q.VertexPredicate(0),
            Q.VertexPredicate(0, (Q.prop_clause(_K_TAG, "in", 5),)),
        ),
        e_preds=(
            Q.EdgePredicate(0, Q.DIR_OUT),
            Q.EdgePredicate(0, Q.DIR_OUT, etr_op=iv.FULLY_BEFORE),
        ),
        agg_op=Q.AGG_COUNT,
    )


SHAPES = dict(
    q3hop_etr=dict(split=1, mode=E.MODE_STATIC, qf=_query_3hop_etr, agg=False),
    q3hop_rtl=dict(split=0, mode=E.MODE_STATIC, qf=_query_3hop_etr, agg=False),
    agg_2hop=dict(split=0, mode=E.MODE_STATIC, qf=_query_2hop_agg, agg=True),
    warp_2hop=dict(split=0, mode=E.MODE_BUCKET, qf=_query_2hop_agg, agg=True),
)


def analytic_flops(shape_name: str, n_vertices=None, n_edges=None,
                   n_buckets: int = 16) -> float:
    """The reference's analytic global operation count of one query
    execution.  Per hop: predicate evaluation and weight mask ≈ 60
    operations a traversal edge, the delivery's segment sum ≈ 1; an ETR hop
    adds two log-depth prefix scans (≈ 2 log2(2E)) and 4 gathers; bucket
    mode multiplies the edge work by B."""
    V = n_vertices or V_FULL
    e2 = 2.0 * (n_edges or E_FULL)
    info = SHAPES[shape_name]
    n_hops = len(info["qf"]().e_preds)
    has_etr = any(p.etr_op != -1 for p in info["qf"]().e_preds)
    per_edge = 60.0
    if has_etr:
        per_edge += 2 * np.log2(e2) + 8
    bucket_mult = n_buckets if info["mode"] == E.MODE_BUCKET else 1
    return n_hops * e2 * per_edge * bucket_mult + 4.0 * V * n_hops


def _gdev_sds(V: int, E2: int, n_buckets: int) -> dict:
    """The port's device graph (``engine.prepare_gdev``) as meta tensors:
    the reference's dry-run layout plus ``t_src_l`` and ``t_dst_l``, the
    int64 copies of ``t_src`` and ``t_dst`` that torch indexing reads.  At
    2 × 218 M traversal edges those two alone are 2 × 8 × E2 bytes, about
    7.0 GB, beside the 1.7 GB of the int32 pair they copy."""
    s, i32 = common.sds, torch.int32
    return dict(
        v_type=s((V,), i32),
        v_life=s((V, 2), i32),
        t_src=s((E2,), i32),
        t_dst=s((E2,), i32),
        t_src_l=s((E2,), torch.int64),
        t_dst_l=s((E2,), torch.int64),
        t_life=s((E2, 2), i32),
        t_type=s((E2,), i32),
        t_isfwd=s((E2,), i32),
        arr_ptr=s((V + 1,), i32),
        type_ranges=s((N_VTYPES, 2), i32),
        etr_perm_start=s((E2,), i32),
        etr_perm_end=s((E2,), i32),
        etr_dep_ranks=s((4, E2), i32),
        etr_arr_ranks=s((4, E2), i32),
        vprops={
            _K_TAG: (s((V, 1), i32), s((V, 1, 2), i32)),
            _K_COUNTRY: (s((V, 1), i32), s((V, 1, 2), i32)),
        },
        eprops_t={},
    )


def _gdev_shardings(mesh, V: int, E2: int) -> dict:
    """Specs of ``_gdev_sds``: every array split over all mesh axes along its
    vertex or edge dimension; ``arr_ptr`` and ``type_ranges`` replicated."""
    a = tuple(mesh.axis_names)
    return dict(
        v_type=P(a),
        v_life=P(a, None),
        t_src=P(a),
        t_dst=P(a),
        t_src_l=P(a),
        t_dst_l=P(a),
        t_life=P(a, None),
        t_type=P(a),
        t_isfwd=P(a),
        arr_ptr=P(None),          # offsets replicated
        type_ranges=P(None, None),
        etr_perm_start=P(a),
        etr_perm_end=P(a),
        etr_dep_ranks=P(None, a),
        etr_arr_ranks=P(None, a),
        vprops={
            _K_TAG: (P(a, None), P(a, None, None)),
            _K_COUNTRY: (P(a, None), P(a, None, None)),
        },
        eprops_t={},
    )


def _cell(shape_name: str, mesh) -> common.ShapeCell:
    info = SHAPES[shape_name]
    qry = info["qf"]()
    split, mode = info["split"], info["mode"]
    n_buckets = 16
    V, E2 = V_FULL, 2 * E_FULL
    a = tuple(mesh.axis_names)

    def run(gdev, params, bedges):
        # the port's plan runs a batch of queries: this one as a batch of 1
        out = E.execute_plan(gdev, qry, split, mode, n_buckets, params[None], bedges,
                             impl="torch")
        if info["agg"]:
            return out.total[0], out.per_vertex[0]
        return out.total[0]

    if info["agg"]:
        out_specs = (P(), P(a) if mode == E.MODE_STATIC else P(a, None))
    else:
        out_specs = P() if mode == E.MODE_STATIC else P(None)
    return common.ShapeCell(
        run, (_gdev_sds(V, E2, n_buckets), common.sds(Q.query_params(qry).shape, torch.int32),
              common.sds((n_buckets + 1,), torch.int32)),
        (_gdev_shardings(mesh, V, E2), P(None, None), P(None)),
        out_specs, "query", note=f"split={split} mode={mode}",
        analytic_flops=analytic_flops(shape_name),
    )


def _smoke(device=None) -> dict:
    """The reference's smoke: one Q2 and one Q4 (seed 3) on a 50-person
    LDBC graph (seed 11), counted in static mode by the engine on ``device``
    (None: the card) and by the oracle (``RefEngine``); ok when all agree.
    ``counts`` holds (engine, oracle) per query."""
    from ..core.ref_engine import RefEngine
    from ..graphdata.ldbc import LdbcParams, generate_ldbc
    from ..graphdata.queries import make_workload

    g = generate_ldbc(LdbcParams(n_persons=50, seed=11))
    wl = make_workload(g, templates=("Q2", "Q4"), n_per_template=1, seed=3)
    ref = RefEngine(g)
    counts = [(E.count_results(g, inst.qry, mode=E.MODE_STATIC, device=device),
               ref.count(inst.qry, mode=E.MODE_STATIC)) for inst in wl]
    return dict(ok=all(got == want for got, want in counts), counts=counts)


def get_arch() -> common.ArchSpec:
    return common.ArchSpec(
        arch_id="granite-ldbc", family="graph-query",
        shapes={name: partial(_cell, name) for name in SHAPES}, skip={}, smoke=_smoke,
        meta=dict(V=V_FULL, E=E_FULL, note="paper 100k:F scale"),
    )
