"""The torch port's plans, batches and entry-point rules against the
reference package: every split point (product join and ETR-at-join), the
batched entry points against sequential execution and the reference's
``execute_batch``, MIN/MAX across ETR, and the device and impl rules."""
import dataclasses

import numpy as np
import pytest
import torch

import conformance as C
from repro.core import engine as JE
from repro.graphdata.queries import make_workload
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.core import engine_sliced as TES
from repro_torch.core import query as TQ
from test_torch_engine import assert_legs_equal_reference, port_legs

SPLIT_CASES = ["plain-2hop", "etr-before", "etr-overlaps"]
# templates whose n_vertices // 2 split joins across an ETR hop (Q4, Q7, Q8)
# or by product (Q1): their batches are also held against the reference's
# execute_batch; the others against the port's sequential answers
JAX_BATCH_TEMPLATES = ("Q1", "Q4", "Q7", "Q8")


@pytest.fixture(scope="module")
def port_graph(small_dynamic_graph):
    return interop.graph_from_arrays(small_dynamic_graph)


@pytest.fixture(scope="module")
def matrix(small_dynamic_graph):
    return C.case_matrix(small_dynamic_graph)


@pytest.mark.parametrize("split", [0, 1, 2])
@pytest.mark.parametrize("name", SPLIT_CASES)
def test_every_split_matches_reference(small_dynamic_graph, port_graph, matrix, name,
                                       split):
    """Split 1 of the ETR cases joins across the ETR hop (ETR-at-join);
    split 1 of plain-2hop is the product join."""
    case = matrix[name]
    qry = interop.query_from_dict(dataclasses.asdict(case.qry))
    for mode in C.ALL_MODES:
        ref = JE.execute(small_dynamic_graph, case.qry, split=split, mode=mode,
                         n_buckets=C.N_BUCKETS, sliced=False)
        assert_legs_equal_reference(ref, port_legs(port_graph, qry, mode, split),
                                    (name, split, mode))


@pytest.mark.parametrize("mode", C.ALL_MODES)
def test_batches_equal_sequential_and_reference(small_dynamic_graph, port_graph, mode):
    wl = make_workload(small_dynamic_graph, n_per_template=2, seed=2)
    templates = sorted({i.template for i in wl})
    for t in templates:
        ref_qs = [i.qry for i in wl if i.template == t]
        qs = [interop.query_from_dict(dataclasses.asdict(q)) for q in ref_qs]
        split = qs[0].n_vertices // 2
        want = None
        if t in JAX_BATCH_TEMPLATES:
            want = np.asarray(JE.execute_batch(small_dynamic_graph, ref_qs, split=split,
                                               mode=mode, n_buckets=C.N_BUCKETS))
        for impl in ("torch", "cuda"):
            kw = dict(split=split, mode=mode, n_buckets=C.N_BUCKETS, impl=impl,
                      device="cpu")
            got = TE.execute_batch(port_graph, qs, **kw)
            if want is None:
                want = got
            assert np.array_equal(got, want), (t, mode, impl)
            out = TE.execute_batch_out(port_graph, qs, **kw)
            assert out.total.shape[0] == len(qs)
            for i, q in enumerate(qs):
                one = TE.execute(port_graph, q, **kw)
                assert np.array_equal(one.total.numpy(), out.total[i].numpy()), (t, i)
            assert TE.count_results(port_graph, qs[0], **kw) == float(want[0].sum())


def test_batched_aggregates_equal_sequential(port_graph, matrix):
    for name in ("agg-count", "agg-min", "agg-min-2hop", "etr-agg-count"):
        q = interop.query_from_dict(dataclasses.asdict(matrix[name].qry))
        for mode in C.ALL_MODES:
            for impl in ("torch", "cuda"):
                kw = dict(mode=mode, n_buckets=C.N_BUCKETS, impl=impl, device="cpu")
                run = TE.batch_executable(port_graph, q, **kw)
                params = np.stack([TQ.query_params(q)] * 2)
                out = run(params)
                one = TE.execute(port_graph, q, **kw)
                for f in ("total", "per_vertex", "minmax"):
                    a, b = getattr(out, f), getattr(one, f)
                    assert (a is None) == (b is None), (name, f)
                    if a is not None:
                        assert np.array_equal(a[1].numpy(), b.numpy()), (name, mode, f)


def test_minmax_across_etr_raises_like_the_reference(small_dynamic_graph, port_graph,
                                                     matrix):
    ref_q = dataclasses.replace(matrix["etr-agg-count"].qry, agg_op=TQ.AGG_MIN,
                                agg_key=small_dynamic_graph.meta["builder"].key_ids["length"])
    with pytest.raises(NotImplementedError):
        JE.execute(small_dynamic_graph, ref_q, mode=0, sliced=False)
    q = interop.query_from_dict(dataclasses.asdict(ref_q))
    assert not TES.sliceable(q)
    for impl in ("torch", "cuda"):
        with pytest.raises(NotImplementedError):
            TE.execute(port_graph, q, mode=0, impl=impl, device="cpu")


def test_entry_points_need_the_card_or_an_explicit_cpu(port_graph, matrix, monkeypatch):
    q = interop.query_from_dict(dataclasses.asdict(matrix["plain-2hop"].qry))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TE.execute(port_graph, q)
    with pytest.raises(RuntimeError):
        TE.execute_batch(port_graph, [q], device="cuda")
    with pytest.raises(ValueError):
        TE.execute(port_graph, q, impl="xla", device="cpu")
    agg_min = interop.query_from_dict(dataclasses.asdict(matrix["agg-min"].qry))
    with pytest.raises(ValueError, match="sliceable"):
        TE.execute(port_graph, agg_min, sliced=True, device="cpu")
    with pytest.raises(ValueError, match="template shape"):
        TE.execute_batch(port_graph, [q, agg_min], device="cpu")
