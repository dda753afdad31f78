"""The port's two-level partitioner and boundary-exchange primitives against
the reference package's.

* ``partition_graph`` (type + topology, and the hash baseline),
  ``build_partition_arrays``, ``extend_partitioning`` and
  ``reassign_on_failure`` give ``np.array_equal`` tables (and equal stats) on
  the three fixture graphs at W = 2, 4, 8.
* ``PartitionArrays.worker_arrival_ptr`` (the per-worker arrival CSR the
  port's kernels walk, in place of the reference's TPU block layouts) is a
  searchsorted over ``dst_local``, and its flattened form
  (``kernels.hop_scatter.worker_csr``) covers exactly the real edges.
* ``superstep.p2p_exchange`` equals the reference's on the same lanes, and
  the global publish-then-halo-gather exchange; ``etr_local_summaries``
  equals the reference's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import superstep as JSS
from repro.graphdata import partitioner as JP
from repro_torch import interop
from repro_torch.core import superstep as TSS
from repro_torch.graphdata import partitioner as TP
from repro_torch.kernels import hop_scatter as HK
from serving_parity import one_torch_thread  # noqa: F401  (autouse)

GRAPHS = ("small_static_graph", "small_dynamic_graph", "medium_static_graph")
WORKERS = (2, 4, 8)


@pytest.fixture(scope="module")
def pair(request):
    cache = {}

    def get(name):
        if name not in cache:
            ref = request.getfixturevalue(name)
            cache[name] = (ref, interop.graph_from_arrays(ref))
        return cache[name]
    return get


def assert_partitioning_equal(a, b, ctx):
    assert np.array_equal(a.part_of, b.part_of), ctx
    assert np.array_equal(a.worker_of_part, b.worker_of_part), ctx
    assert (a.n_parts, a.n_workers) == (b.n_parts, b.n_workers), ctx
    assert a.stats == b.stats, ctx


def assert_arrays_equal(a, b, ctx):
    for f in dataclasses.fields(JP.PartitionArrays):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), (ctx, f.name)
        else:
            assert x == y, (ctx, f.name)
    assert a.exchange_volume() == b.exchange_volume(), ctx
    assert a.etr_exchange_volume() == b.etr_exchange_volume(), ctx
    assert (a.v_max, a.e_max, a.h_max, a.s_max) == (b.v_max, b.e_max, b.h_max, b.s_max)


@pytest.mark.parametrize("w", WORKERS)
@pytest.mark.parametrize("name", GRAPHS)
def test_partition_tables_equal_reference(pair, name, w):
    ref, port = pair(name)
    for ppt, hb in ((max(4, w // 2), False), (4, True)):
        ctx = (name, w, ppt, hb)
        jp = JP.partition_graph(ref, n_workers=w, parts_per_type=ppt, hash_baseline=hb)
        tp = TP.partition_graph(port, n_workers=w, parts_per_type=ppt, hash_baseline=hb)
        assert_partitioning_equal(jp, tp, ctx)
        ja = JP.build_partition_arrays(ref, jp)
        ta = TP.build_partition_arrays(port, tp)
        assert_arrays_equal(ja, ta, ctx)
        for failed in (0, w - 1):
            assert_partitioning_equal(JP.reassign_on_failure(jp, failed),
                                      TP.reassign_on_failure(tp, failed), ctx)


@pytest.mark.parametrize("name", GRAPHS)
def test_extend_partitioning_equal_reference(pair, name):
    ref, port = pair(name)
    rng = np.random.default_rng(7)
    for w in WORKERS:
        jp = JP.partition_graph(ref, n_workers=w)
        tp = TP.partition_graph(port, n_workers=w)
        # carry a random 85 % of the vertices; the rest are "new"
        keep = np.sort(rng.choice(ref.n_vertices, int(0.85 * ref.n_vertices),
                                  replace=False))
        jb = JP.Partitioning(jp.part_of[keep], jp.worker_of_part, jp.n_parts, w,
                             dict(jp.stats))
        tb = TP.Partitioning(tp.part_of[keep], tp.worker_of_part, tp.n_parts, w,
                             dict(tp.stats))
        je = JP.extend_partitioning(jb, ref, keep)
        te = TP.extend_partitioning(tb, port, keep)
        assert je is not None and te is not None
        assert_partitioning_equal(je, te, (name, w))
        assert (te.part_of >= 0).all()


@pytest.mark.parametrize("name", GRAPHS)
def test_worker_arrival_ptr_is_a_searchsorted_over_dst_local(pair, name):
    _, port = pair(name)
    for w in WORKERS:
        pa = TP.build_partition_arrays(port, TP.partition_graph(port, n_workers=w))
        ptr = pa.worker_arrival_ptr()
        assert ptr.shape == (w, pa.v_max + 2) and ptr.dtype == np.int32
        for d in range(w):
            want = np.searchsorted(pa.dst_local[d], np.arange(pa.v_max + 2))
            assert np.array_equal(ptr[d], want)
            # real edges first, the trash segment v_max holds only the pads
            assert ptr[d, pa.v_max] == pa.n_edges[d] and ptr[d, -1] == pa.e_max
        lay = HK.worker_csr(ptr, pa.e_max, "cpu")
        assert lay.n_real == int(pa.n_edges.sum()) == 2 * port.n_edges
        assert lay.n_pad == w * pa.e_max - lay.n_real
        assert int(lay.ptr[-1]) == lay.n_real and lay.ptr.shape[0] == w * pa.v_max + 1
        # every flattened run is the worker's run, at real positions only
        real = lay.real.numpy()
        assert np.array_equal(pa.dst_local.reshape(-1)[real] + (real // pa.e_max) * pa.v_max,
                              HK.segment_ids(lay.ptr, lay.n_real).numpy())
        assert (pa.edge_ids.reshape(-1)[real] < 2 * port.n_edges).all()


def _exchange_ref(rows, lanes):
    """The reference's p2p_exchange, one query at a time."""
    own, send, recv, n = lanes
    out = [np.asarray(JSS.p2p_exchange(jnp.asarray(r), jnp.asarray(own),
                                       jnp.asarray(send), jnp.asarray(recv), n))
           for r in rows]
    return np.stack(out)


@pytest.mark.parametrize("ts", [(), (3,), (2, 3)])
def test_p2p_exchange_equals_reference_and_global_halo_gather(pair, ts):
    ref, port = pair("medium_static_graph")
    rng = np.random.default_rng(11)
    for w in WORKERS:
        pa = TP.build_partition_arrays(port, TP.partition_graph(port, n_workers=w,
                                                                parts_per_type=4))
        rows = rng.integers(-5, 50, size=(2, w, pa.v_max) + ts).astype(np.float32)
        got = TSS.p2p_exchange(torch.from_numpy(rows), torch.from_numpy(pa.halo_own_slot),
                               torch.from_numpy(pa.xchg_send_slot),
                               torch.from_numpy(pa.xchg_recv_slot), pa.h_max).numpy()
        want = _exchange_ref(rows, (pa.halo_own_slot, pa.xchg_send_slot,
                                    pa.xchg_recv_slot, pa.h_max))
        assert got.shape == want.shape == (2, w, pa.h_max) + ts
        assert np.array_equal(got, want), w
        # the global publish-then-halo-gather view
        glob = np.zeros((2, port.n_vertices + 1) + ts, np.float32)
        glob[:, pa.own_ids.reshape(-1)] = rows.reshape((2, -1) + ts)
        for d in range(w):
            n_h = int(pa.n_halo[d])
            assert np.array_equal(got[:, d, :n_h], glob[:, pa.halo_ids[d, :n_h]]), (w, d)
        # the ETR channel (summary rows to owned-edge slots), with a fill
        summ = rng.integers(0, 9, size=(1, w, pa.s_max) + ts).astype(np.float32)
        got_e = TSS.p2p_exchange(torch.from_numpy(summ), torch.from_numpy(pa.etr_local_slot),
                                 torch.from_numpy(pa.etr_send_slot),
                                 torch.from_numpy(pa.etr_recv_slot), pa.e_max,
                                 fill=-1.0).numpy()
        want_e = np.stack([np.asarray(JSS.p2p_exchange(
            jnp.asarray(summ[0]), jnp.asarray(pa.etr_local_slot),
            jnp.asarray(pa.etr_send_slot), jnp.asarray(pa.etr_recv_slot),
            pa.e_max, fill=-1.0))])
        assert np.array_equal(got_e, want_e), w
        # only ghost entries ride the lanes; diagonal lanes are empty
        assert int((pa.xchg_send_slot < pa.v_max).sum()) == pa.exchange_volume()
        assert int((pa.etr_send_slot < pa.s_max).sum()) == pa.etr_exchange_volume()
        for d in range(w):
            assert (pa.xchg_send_slot[d, d] == pa.v_max).all()


@pytest.mark.parametrize("op", [0, 1, 2, 3, 7])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("ts", [(), (4,)])
def test_etr_local_summaries_equal_reference(op, backward, ts):
    rng = np.random.default_rng(op + 10 * backward)
    Wl, K, S = 3, 40, 25
    cps = rng.integers(0, 7, size=(2, Wl, K) + ts).astype(np.float32)
    cpe = rng.integers(0, 7, size=(2, Wl, K) + ts).astype(np.float32)
    base = rng.integers(0, K // 2, size=(Wl, S))
    seg_len = rng.integers(0, K // 2, size=(Wl, S))
    ranks = np.minimum(rng.integers(0, K // 2, size=(Wl, 4, S)), seg_len[:, None])
    base[:, -3:] = seg_len[:, -3:] = ranks[:, :, -3:] = 0      # pad rows
    need_end = TSS.etr_needs_end(op, backward)
    got = TSS.etr_local_summaries(
        torch.from_numpy(cps), torch.from_numpy(cpe) if need_end else None,
        torch.from_numpy(base), torch.from_numpy(seg_len), torch.from_numpy(ranks),
        op, backward).numpy()
    for q in range(2):
        for w in range(Wl):
            want = np.asarray(JSS.etr_local_summaries(
                jnp.asarray(cps[q, w]), jnp.asarray(cpe[q, w]) if need_end else None,
                jnp.asarray(base[w]), jnp.asarray(seg_len[w]), jnp.asarray(ranks[w]),
                op, backward))
            assert np.array_equal(got[q, w], want), (q, w)
    assert np.array_equal(got[:, :, -3:], np.zeros_like(got[:, :, -3:]))
