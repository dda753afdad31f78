"""The port's partitioned executor on the conformance matrix, against the
reference package's partitioned executor.

Every cell of ``conformance.case_matrix`` × static/bucket/interval runs the
port's ``engine_partitioned.execute`` at each of the case's worker counts
(``Case.workers`` at smoke scale) under ``impl='torch'`` (plain ops) and
``impl='cuda'`` (the worker-form kernels' plain versions on CPU tensors);
``total``/``per_vertex``/``minmax`` must be ``np.array_equal`` to the JAX
package's ``partitioned-w{W}`` legs (``impl='xla'``), which its own
conformance suite holds equal to its dense executor.  Both packages run on
the very same graph and queries (``repro_torch.interop``)."""
import dataclasses

import numpy as np
import pytest

import conformance as C
from repro.core import engine_partitioned as JEP
from repro_torch import interop
from repro_torch.core import engine_partitioned as TEP
from serving_parity import one_torch_thread  # noqa: F401  (autouse)

CASE_NAMES = [
    "plain-2hop", "plain-bidir", "etr-before", "etr-overlaps",
    "agg-count", "agg-min", "agg-max", "agg-min-2hop", "etr-agg-count",
    "empty-result", "single-vertex",
]
FIELDS = ("total", "per_vertex", "minmax")


@pytest.fixture(scope="module")
def port_graph(small_dynamic_graph):
    return interop.graph_from_arrays(small_dynamic_graph)


@pytest.fixture(scope="module")
def matrix(small_dynamic_graph):
    cases = C.case_matrix(small_dynamic_graph)
    assert set(CASE_NAMES) <= set(cases)
    return cases


def assert_equal_outputs(want, got, ctx):
    for f in FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None) == (b is None), (ctx, f)
        if a is not None:
            assert np.array_equal(np.asarray(a), b.numpy()), (ctx, f)


@pytest.mark.parametrize("mode", C.ALL_MODES)
@pytest.mark.parametrize("name", CASE_NAMES)
def test_partitioned_legs_equal_reference(small_dynamic_graph, port_graph, matrix,
                                          name, mode):
    case = matrix[name]
    qry = interop.query_from_dict(dataclasses.asdict(case.qry))
    for w in case.workers:
        ref = JEP.execute(small_dynamic_graph, case.qry, mode=mode,
                          n_buckets=C.N_BUCKETS, n_workers=w)
        if case.expect_empty:
            assert float(np.sum(np.asarray(ref.total))) == 0.0
        for impl in ("torch", "cuda"):
            got = TEP.execute(port_graph, qry, mode=mode, n_buckets=C.N_BUCKETS,
                              n_workers=w, impl=impl, device="cpu")
            assert_equal_outputs(ref, got, (name, mode, w, impl))
