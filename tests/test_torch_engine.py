"""The torch port's executors on the conformance matrix, against the
reference package's dense executor (``impl='xla'``) and the port's own copy
of the pure-Python oracle.

Every cell of ``conformance.case_matrix`` × static/bucket/interval runs the
port's dense executor, and its sliced executor where the query is sliceable,
under ``impl='torch'`` (plain ops) and ``impl='cuda'`` (the kernels' plain
versions on CPU tensors); ``total``/``per_vertex``/``minmax`` must be
``np.array_equal`` to the reference's.  Both packages run on the very same
graph and queries (``repro_torch.interop``)."""
import dataclasses

import numpy as np
import pytest

import conformance as C
from repro.core import engine as JE
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.core import engine_sliced as TES
from repro_torch.core import query as TQ
from repro_torch.core.ref_engine import RefEngine

# the names conformance.case_matrix generates at smoke scale
CASE_NAMES = [
    "plain-2hop", "plain-bidir", "etr-before", "etr-overlaps",
    "agg-count", "agg-min", "agg-max", "agg-min-2hop", "etr-agg-count",
    "empty-result", "single-vertex",
]


@pytest.fixture(scope="module")
def port_graph(small_dynamic_graph):
    return interop.graph_from_arrays(small_dynamic_graph)


@pytest.fixture(scope="module")
def matrix(small_dynamic_graph):
    cases = C.case_matrix(small_dynamic_graph)
    assert set(CASE_NAMES) <= set(cases)
    return cases


@pytest.fixture(scope="module")
def port_oracle(port_graph):
    return RefEngine(port_graph)


def port_legs(graph, qry, mode, split=None):
    """The port's executor legs: dense/sliced × torch/cuda."""
    legs = {}
    for sliced in (False, True):
        if sliced and not TES.sliceable(qry):
            continue
        for impl in ("torch", "cuda"):
            out = TE.execute(graph, qry, split=split, mode=mode, n_buckets=C.N_BUCKETS,
                             sliced=sliced, impl=impl, device="cpu")
            legs[f"{'sliced' if sliced else 'dense'}+{impl}"] = {
                f: None if getattr(out, f) is None else getattr(out, f).numpy()
                for f in ("total", "per_vertex", "minmax")}
    return legs


def assert_legs_equal_reference(ref_out, legs, ctx):
    for name, got in legs.items():
        for f in ("total", "per_vertex", "minmax"):
            want = getattr(ref_out, f)
            if want is None:
                assert got[f] is None, (ctx, name, f)
                continue
            assert got[f] is not None, (ctx, name, f)
            assert np.array_equal(np.asarray(want), got[f]), (ctx, name, f)


@pytest.mark.parametrize("mode", C.ALL_MODES)
@pytest.mark.parametrize("name", CASE_NAMES)
def test_port_matches_reference_on_the_matrix(small_dynamic_graph, port_graph, matrix,
                                              port_oracle, name, mode):
    case = matrix[name]
    ctx = (name, mode)
    ref = JE.execute(small_dynamic_graph, case.qry, mode=mode, n_buckets=C.N_BUCKETS,
                     sliced=False)
    qry = interop.query_from_dict(dataclasses.asdict(case.qry))
    legs = port_legs(port_graph, qry, mode)
    assert len(legs) == (4 if TES.sliceable(qry) else 2)
    assert_legs_equal_reference(ref, legs, ctx)
    if case.expect_empty:
        assert float(np.sum(legs["dense+cuda"]["total"])) == 0.0, ctx
    if mode in case.oracle_modes:
        view = {"dense": legs["dense+cuda"]}
        if qry.agg_op == TQ.AGG_NONE:
            C.assert_oracle_counts(port_oracle, port_graph, qry, mode, view,
                                   C.N_BUCKETS, ctx)
        else:
            C.assert_oracle_aggregate(port_oracle, port_graph, qry, mode, view,
                                      C.N_BUCKETS, ctx)
