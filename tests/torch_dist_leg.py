"""The partitioned executor's multi-process leg, run by spawned ranks.

``tests/test_torch_engine_partitioned_dist.py`` starts R processes on the CPU,
each calling ``rank_main``: a ``torch.distributed`` gloo group over
``tcp://localhost:<port>``, the small dynamic graph made from its seed, and
every query of the given list through ``engine_partitioned.execute`` with
``group=``.  Rank 0 puts its answers on the queue; every rank gets the same
ones after the segment-end all_reduce.  Kept out of the test module so the
spawned interpreter can import it without pytest.
"""
from __future__ import annotations

import traceback


def rank_main(rank: int, world: int, port: int, n_workers: int, jobs, queue):
    try:
        import torch
        import torch.distributed as dist

        from repro_torch import interop
        from repro_torch.core import engine_partitioned as TEP
        from repro_torch.graphdata.ldbc import LdbcParams, generate_ldbc

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        graph = generate_ldbc(LdbcParams(n_persons=40, seed=5, dynamic=True))
        out = {}
        for key, qd, mode, impl in jobs:
            r = TEP.execute(graph, interop.query_from_dict(qd), mode=mode,
                            n_buckets=8, n_workers=n_workers, impl=impl,
                            device="cpu", group=dist.group.WORLD)
            out[key] = tuple(None if x is None else x.numpy()
                             for x in (r.total, r.per_vertex, r.minmax))
        dist.barrier()
        dist.destroy_process_group()
        if rank == 0:
            queue.put(("ok", out))
    except Exception:  # report, so the parent fails with the trace
        queue.put(("error", f"rank {rank}:\n{traceback.format_exc()}"))
