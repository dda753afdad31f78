"""The partitioned executor's multi-process leg on the CPU: two and four
``torch.distributed`` gloo ranks (each running its share of the 4 workers,
the exchange as ``all_to_all_single`` and the segment-end publish as
``all_reduce``) give ``np.array_equal`` answers to the one-process
simulation on the conformance matrix.  The ranks are spawned processes
(``torch_dist_leg.rank_main``); the test bounds its own wait."""
import dataclasses
import multiprocessing as mp
import queue as queue_mod
import socket

import numpy as np
import pytest

import conformance as C
import torch_dist_leg
from repro_torch import interop
from repro_torch.core import engine_partitioned as TEP
from serving_parity import one_torch_thread  # noqa: F401  (autouse)

WAIT_S = 90.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(world: int, n_workers: int, jobs):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=torch_dist_leg.rank_main,
                         args=(r, world, port, n_workers, jobs, q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        status, payload = q.get(timeout=WAIT_S)
    except queue_mod.Empty:
        payload, status = f"no answer from {world} ranks in {WAIT_S} s", "error"
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    assert status == "ok", payload
    return payload


@pytest.mark.parametrize("world,impl", [(2, "torch"), (4, "cuda")])
def test_gloo_ranks_equal_the_simulation(small_dynamic_graph, world, impl):
    cases = C.case_matrix(small_dynamic_graph)
    jobs = [(f"{name}/{mode}", dataclasses.asdict(case.qry), mode, impl)
            for name, case in sorted(cases.items()) for mode in C.ALL_MODES]
    got = _run_ranks(world, 4, jobs)
    g = interop.graph_from_arrays(small_dynamic_graph)
    assert set(got) == {j[0] for j in jobs}
    for key, qd, mode, _ in jobs:
        want = TEP.execute(g, interop.query_from_dict(qd), mode=mode,
                           n_buckets=C.N_BUCKETS, n_workers=4, impl=impl,
                           device="cpu")
        for f, b in zip(("total", "per_vertex", "minmax"), got[key]):
            a = getattr(want, f)
            assert (a is None) == (b is None), (key, f)
            if a is not None:
                assert np.array_equal(a.numpy(), b), (key, f)


def test_workers_must_divide_over_the_ranks():
    class Two:
        pass

    import torch.distributed as dist
    orig = dist.get_world_size, dist.get_rank
    try:
        dist.get_world_size = lambda group=None: 3
        dist.get_rank = lambda group=None: 0
        with pytest.raises(ValueError, match="divide"):
            TEP.worker_slice(4, Two())
        assert TEP.worker_slice(6, Two()) == slice(0, 2)
    finally:
        dist.get_world_size, dist.get_rank = orig
    assert TEP.worker_slice(4) == slice(0, 4)
