"""The training slice's multi-process legs, run by spawned gloo ranks.

``tests/test_torch_training.py`` and ``tests/test_torch_pipeline.py`` start
R processes on the CPU, each calling one function here in a
``torch.distributed`` gloo group over ``tcp://localhost:<port>``:

  dp_rank_main    one ``make_dp_train_step`` step of minicpm-2b SMOKE per
                  compression kind, on this rank's shard of the batch
  pipe_rank_main  the GPipe forward of a tanh layer stack over the ranks as
                  stages, and the losses summed on the last stage

``dp_rank_main``'s last rank puts its results on the queue, and every rank
of ``pipe_rank_main`` does; ``run_ranks`` spawns the ranks and bounds its
wait.  Kept out of the test modules so the spawned interpreter can import
it without pytest.
"""
from __future__ import annotations

import multiprocessing as mp
import queue as queue_mod
import socket
import traceback

WAIT_S = 90.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(target, world: int, *args, n_answers: int = 1) -> list:
    """Spawn ``world`` gloo ranks of ``target(rank, world, port, *args,
    queue)``; wait at most WAIT_S for ``n_answers`` answers; raise
    ``AssertionError`` on a rank's error or on the wait running out."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=target, args=(r, world, port, *args, q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    answers = []
    try:
        for _ in range(n_answers):
            try:
                status, payload = q.get(timeout=WAIT_S)
            except queue_mod.Empty:
                raise AssertionError(f"no answer from {world} ranks in {WAIT_S} s") from None
            assert status == "ok", payload
            answers.append(payload)
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    return answers


def _init(rank: int, world: int, port: int):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    return dist


def dp_rank_main(rank: int, world: int, port: int, tree, shards, kinds, queue):
    try:
        import torch

        from repro_torch import interop
        from repro_torch.configs.minicpm_2b import SMOKE
        from repro_torch.models import transformer as TR
        from repro_torch.training import tree as T
        from repro_torch.training.compression import CompressionCfg, init_error_state
        from repro_torch.training.optimizer import OptCfg, init_state
        from repro_torch.training.train_loop import make_dp_train_step

        dist = _init(rank, world, port)
        batch = {k: torch.from_numpy(v) for k, v in shards[rank].items()}
        out = {}
        for kind in kinds:
            params = interop.transformer_params_from_arrays(SMOKE, tree, device="cpu")
            step = make_dp_train_step(lambda p, b: TR.loss_fn(SMOKE, p, b),
                                      OptCfg(lr=1e-3, schedule="const", warmup_steps=0),
                                      compression=CompressionCfg(kind=kind, topk_frac=0.2))
            p, _, err, m = step(params, init_state(params), init_error_state(params), batch)
            out[kind] = dict(params=[x.numpy() for x in T.leaves(p)],
                             err=[x.numpy() for x in T.leaves(err)],
                             loss=float(m["loss"]))
        dist.barrier()
        dist.destroy_process_group()
        if rank == world - 1:
            queue.put(("ok", out))
    except Exception:  # report, so the parent fails with the trace
        queue.put(("error", f"rank {rank}:\n{traceback.format_exc()}"))


def tanh_layer(lp, x):
    import torch

    return torch.tanh(x @ lp["w"] + lp["b"])


def pipe_rank_main(rank: int, world: int, port: int, w, b, x, targets, queue):
    try:
        import torch

        from repro_torch.training.pipeline import (PipelineCfg, make_pipelined_forward,
                                                   pipeline_loss)

        dist = _init(rank, world, port)
        params = dict(w=torch.from_numpy(w), b=torch.from_numpy(b))
        fwd = make_pipelined_forward(tanh_layer, world, PipelineCfg(n_microbatches=x.shape[0]))
        out = fwd(params, torch.from_numpy(x))
        loss = pipeline_loss(out, torch.from_numpy(targets),
                             lambda y, t: ((y - t) ** 2).mean(), world)
        dist.barrier()
        dist.destroy_process_group()
        queue.put(("ok", dict(rank=rank, out=out.numpy(), loss=float(loss))))
    except Exception:  # report, so the parent fails with the trace
        queue.put(("error", f"rank {rank}:\n{traceback.format_exc()}"))
