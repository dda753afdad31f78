"""The port's executors write nothing into the device graph they are given.

The reference's plans are pure functions of their arguments; the port's must
be too.  After a bare ``engine_sliced.execute_plan_sliced`` call, and after
the runs of a ``batch_executable`` (sliced, dense) or of the partitioned
executor's, the ``prepare_gdev`` dict holds the same keys and the very same
objects under them as before (the partitioned executor's worker tables too),
and every top-level key stays a string, so a tree walk over the arguments can sort
them.  A bare sliced plan traced twice over one ``meta`` argument dict counts
the same bytes and operations both times.  The answers are
``np.array_equal`` to the JAX package's on the same graph and queries.  One
ETR query and one plain query, on the tests' small dynamic graph."""
import dataclasses

import numpy as np
import pytest
import torch

import conformance as C
from repro.core import engine as JE
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.core import engine_partitioned as TEP
from repro_torch.core import engine_sliced as TES
from repro_torch.core import query as TQ
from repro_torch.roofline import analysis as A

NAMES = ["plain-2hop", "etr-before"]
MODES = [TE.MODE_STATIC, TE.MODE_BUCKET]   # the main path's and the served path's
_REFERENCE = {}


@pytest.fixture(scope="module")
def matrix(small_dynamic_graph):
    return C.case_matrix(small_dynamic_graph)


@pytest.fixture
def port_graph(small_dynamic_graph):
    # a graph of its own per test: its device dict starts as the upload made it
    return interop.graph_from_arrays(small_dynamic_graph)


def reference_total(small_dynamic_graph, matrix, name, mode):
    key = (name, mode)
    if key not in _REFERENCE:
        _REFERENCE[key] = np.asarray(JE.execute(
            small_dynamic_graph, matrix[name].qry, mode=mode, n_buckets=C.N_BUCKETS,
            sliced=False).total)
    return _REFERENCE[key]


def port_query(matrix, name):
    return interop.query_from_dict(dataclasses.asdict(matrix[name].qry))


def snapshot(d: dict) -> dict:
    return {k: snapshot(v) if isinstance(v, dict) else v for k, v in d.items()}


def assert_unchanged(before: dict, d: dict, path=()):
    if not path:   # property columns are keyed by int; the graph's arrays by name
        assert all(isinstance(k, str) for k in d), [k for k in d if not isinstance(k, str)]
    assert set(d) == set(before), (path, set(d) ^ set(before))
    for k, v in before.items():
        if isinstance(v, dict):
            assert_unchanged(v, d[k], path + (k,))
        elif isinstance(v, tuple):
            assert len(d[k]) == len(v) and all(a is b for a, b in zip(d[k], v)), path + (k,)
        else:
            assert d[k] is v, path + (k,)


def bare_sliced(gdev, graph, qry, mode):
    """One sliced plan as its callers call it, with no pointer map."""
    dev = gdev["arr_ptr"].device
    params = torch.as_tensor(TQ.query_params(qry)[None]).to(dev)
    bedges = TE.bucket_edges_for(graph, C.N_BUCKETS, "cpu").to(dev)
    return lambda impl: TES.execute_plan_sliced(
        gdev, qry, TE.default_split(qry), mode, C.N_BUCKETS, params, bedges,
        TES.SliceBounds.from_graph(graph), impl=impl)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("entry", ["bare", "executable"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_sliced_plan_leaves_its_device_graph_as_it_was(small_dynamic_graph, matrix,
                                                       port_graph, name, mode, entry, impl):
    qry = port_query(matrix, name)
    assert TES.sliceable(qry)
    gdev = TE.prepare_gdev(port_graph, "cpu")
    before = snapshot(gdev)
    if entry == "bare":
        plan = bare_sliced(gdev, port_graph, qry, mode)
        totals = [plan(impl).total for _ in range(2)]
    else:
        run = TE.batch_executable(port_graph, qry, mode=mode, n_buckets=C.N_BUCKETS,
                                  sliced=True, impl=impl, device="cpu")
        params = TQ.query_params(qry)[None]
        totals = [run(params).total for _ in range(2)]
    assert_unchanged(before, gdev)
    want = reference_total(small_dynamic_graph, matrix, name, mode)
    for total in totals:
        assert np.array_equal(want, total[0].numpy()), (name, mode, entry, impl)


@pytest.mark.parametrize("engine", ["dense", "partitioned"])
@pytest.mark.parametrize("name", NAMES)
def test_dense_and_partitioned_plans_leave_their_arguments_as_they_were(
        small_dynamic_graph, matrix, port_graph, name, engine):
    qry = port_query(matrix, name)
    mode = TE.MODE_STATIC
    gdev = TE.prepare_gdev(port_graph, "cpu")
    if engine == "dense":
        run = TE.batch_executable(port_graph, qry, mode=mode, n_buckets=C.N_BUCKETS,
                                  sliced=False, impl="cuda", device="cpu")
        args = [gdev]
    else:
        run = TEP.batch_executable(port_graph, qry, mode=mode, n_buckets=C.N_BUCKETS,
                                   n_workers=2, impl="cuda", device="cpu")
        args = [gdev, TEP.device_tables(port_graph, 2, None, torch.device("cpu"))[1]]
    before = [snapshot(d) for d in args]
    total = run(TQ.query_params(qry)[None]).total
    for b, d in zip(before, args):
        assert_unchanged(b, d)
    assert np.array_equal(reference_total(small_dynamic_graph, matrix, name, mode),
                          total[0].numpy())


def to_meta(d: dict) -> dict:
    def one(v):
        if isinstance(v, dict):
            return to_meta(v)
        if isinstance(v, tuple):
            return tuple(one(x) for x in v)
        return torch.empty(v.shape, dtype=v.dtype, device="meta")
    return {k: one(v) for k, v in d.items()}


@pytest.mark.parametrize("name", NAMES)
def test_a_bare_sliced_plan_counts_the_same_on_every_trace(matrix, port_graph, name):
    qry = port_query(matrix, name)
    gdev = to_meta(TE.prepare_gdev(port_graph, "cpu"))
    before = snapshot(gdev)
    plan = bare_sliced(gdev, port_graph, qry, TE.MODE_STATIC)
    first, second = (A.count_program(plan, ("torch",)) for _ in range(2))
    assert first.ops > 0 and first.bytes > 0
    assert (second.bytes, second.ops) == (first.bytes, first.ops)
    assert_unchanged(before, gdev)
