"""The port's partitioned executor off the matrix's default plans: every
split, batched entry points, empty partitions, the structural exchange
volumes and ``measure_supersteps``, each against the reference package's
partitioned executor (``np.array_equal``, or exact integers)."""
import dataclasses

import numpy as np
import pytest

import conformance as C
from repro.core import engine_partitioned as JEP
from repro.graphdata import queries as JW
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.core import engine_partitioned as TEP
from repro_torch.core import superstep as TSS
from serving_parity import one_torch_thread  # noqa: F401  (autouse)

FIELDS = ("total", "per_vertex", "minmax")


@pytest.fixture(scope="module")
def port_graph(small_dynamic_graph):
    return interop.graph_from_arrays(small_dynamic_graph)


@pytest.fixture(scope="module")
def matrix(small_dynamic_graph):
    return C.case_matrix(small_dynamic_graph)


def port_query(q):
    return interop.query_from_dict(dataclasses.asdict(q))


def assert_equal_outputs(want, got, ctx):
    for f in FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None) == (b is None), (ctx, f)
        if a is not None:
            assert np.array_equal(np.asarray(a), b.numpy()), (ctx, f)


@pytest.mark.parametrize("mode", C.ALL_MODES)
@pytest.mark.parametrize("template", ["Q1", "Q3", "Q5", "Q7"])
def test_every_split_equals_reference(small_dynamic_graph, port_graph, template, mode):
    """Every split point of a template (ETR-at-join splits included) at W = 4,
    both impls."""
    inst = JW.make_workload(small_dynamic_graph, templates=(template,),
                            n_per_template=1, seed=3)[0]
    qry = port_query(inst.qry)
    for split in range(inst.qry.n_vertices):
        ref = JEP.execute(small_dynamic_graph, inst.qry, split=split, mode=mode,
                          n_buckets=C.N_BUCKETS, n_workers=4)
        for impl in ("torch", "cuda"):
            got = TEP.execute(port_graph, qry, split=split, mode=mode,
                              n_buckets=C.N_BUCKETS, n_workers=4, impl=impl,
                              device="cpu")
            assert_equal_outputs(ref, got, (template, mode, split, impl))


@pytest.mark.parametrize("name", ["agg-count", "agg-min", "agg-max", "etr-overlaps"])
def test_empty_partitions_equal_reference(small_dynamic_graph, port_graph, matrix, name):
    """One sub-partition per vertex type over 8 workers leaves workers with
    no vertices, no edges and no ghosts."""
    qry = matrix[name].qry
    _, arrays = TEP.partition_for(port_graph, 8, parts_per_type=1)
    assert (arrays.n_own == 0).any() and (arrays.n_ghost == 0).any()
    for mode in C.ALL_MODES:
        ref = JEP.execute(small_dynamic_graph, qry, mode=mode, n_buckets=C.N_BUCKETS,
                          n_workers=8, parts_per_type=1)
        for impl in ("torch", "cuda"):
            got = TEP.execute(port_graph, port_query(qry), mode=mode,
                              n_buckets=C.N_BUCKETS, n_workers=8, parts_per_type=1,
                              impl=impl, device="cpu")
            assert_equal_outputs(ref, got, (name, mode, impl))


@pytest.mark.parametrize("mode", C.ALL_MODES)
@pytest.mark.parametrize("name", ["plain-2hop", "etr-before", "agg-min-2hop",
                                  "etr-agg-count"])
def test_batch_executable_equals_sequential(port_graph, matrix, name, mode):
    """A perturbed same-shape batch through ``execute_batch_out`` equals the
    per-query calls, field by field."""
    queries = [port_query(q) for q in C.perturbed_batch(matrix[name].qry, 3)]
    for impl in ("torch", "cuda"):
        out = TEP.execute_batch_out(port_graph, queries, mode=mode,
                                    n_buckets=C.N_BUCKETS, n_workers=4, impl=impl,
                                    device="cpu")
        for j, q in enumerate(queries):
            one = TEP.execute(port_graph, q, mode=mode, n_buckets=C.N_BUCKETS,
                              n_workers=4, impl=impl, device="cpu")
            for f in FIELDS:
                a, b = getattr(out, f), getattr(one, f)
                assert (a is None) == (b is None)
                if a is not None:
                    assert np.array_equal(a[j].numpy(), b.numpy()), (name, mode, impl, f)


@pytest.mark.parametrize("w", [2, 4, 8])
@pytest.mark.parametrize("name", ["plain-2hop", "etr-before", "agg-min-2hop",
                                  "etr-agg-count"])
def test_exchange_channels_and_measure_supersteps_equal_reference(
        small_dynamic_graph, port_graph, matrix, name, w):
    qry = matrix[name].qry
    _, jarr, _ = JEP.partition_for(small_dynamic_graph, w)
    _, tarr = TEP.partition_for(port_graph, w)
    pq = port_query(qry)
    assert TEP.hop_exchange_channels(pq, tarr) == JEP.hop_exchange_channels(qry, jarr)
    assert TEP.query_exchange_volumes(pq, tarr) == JEP.query_exchange_volumes(qry, jarr)
    ref = JEP.measure_supersteps(small_dynamic_graph, qry, n_workers=w,
                                 mode=TSS.MODE_STATIC, repeats=1)
    for impl in ("torch", "cuda"):
        prof = TEP.measure_supersteps(port_graph, pq, n_workers=w,
                                      mode=TSS.MODE_STATIC, repeats=1, impl=impl,
                                      device="cpu")
        assert np.array_equal(prof.exchange_channels, ref.exchange_channels)
        assert np.array_equal(prof.exchange_msgs, ref.exchange_msgs)
        assert prof.channel_totals() == ref.channel_totals()
        assert prof.total == ref.total
        assert prof.times_s.shape == ref.times_s.shape and (prof.times_s > 0).all()
        assert 0.0 < prof.balance_eff <= 1.0


def test_partitioned_equals_dense_at_default_workers(port_graph, matrix):
    """The port's own invariant: partitioned = dense, the default W."""
    for name in ("plain-2hop", "agg-max", "etr-agg-count"):
        qry = port_query(matrix[name].qry)
        for mode in C.ALL_MODES:
            dense = TE.execute(port_graph, qry, mode=mode, n_buckets=C.N_BUCKETS,
                               sliced=False, impl="torch", device="cpu")
            part = TEP.execute(port_graph, qry, mode=mode, n_buckets=C.N_BUCKETS,
                               impl="cuda", device="cpu")
            for f in FIELDS:
                a, b = getattr(dense, f), getattr(part, f)
                assert (a is None) == (b is None)
                if a is not None:
                    assert np.array_equal(a.numpy(), b.numpy()), (name, mode, f)
    assert TEP.count_results(port_graph, port_query(matrix["plain-bidir"].qry),
                             impl="cuda", device="cpu") == \
        TE.count_results(port_graph, port_query(matrix["plain-bidir"].qry),
                         impl="torch", device="cpu")


@pytest.mark.parametrize("mode", C.ALL_MODES)
def test_etr_producer_in_worker_groups_equals_reference(small_dynamic_graph, port_graph,
                                                        matrix, monkeypatch, mode):
    """The ETR producer takes the workers in groups that fit
    ``ETR_CHUNK_BYTES``; one worker at a time gives the same answers."""
    monkeypatch.setattr(TEP, "ETR_CHUNK_BYTES", 1)
    for name in ("etr-before", "etr-agg-count"):
        qry = matrix[name].qry
        ref = JEP.execute(small_dynamic_graph, qry, mode=mode, n_buckets=C.N_BUCKETS,
                          n_workers=4)
        for impl in ("torch", "cuda"):
            got = TEP.execute(port_graph, port_query(qry), mode=mode,
                              n_buckets=C.N_BUCKETS, n_workers=4, impl=impl,
                              device="cpu")
            assert_equal_outputs(ref, got, (name, mode, impl))
