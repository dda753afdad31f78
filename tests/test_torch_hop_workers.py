"""The worker form of the hop kernels B1, B2 and B3 (the partitioned
executor's local hops, every worker in one launch) on the CPU.

``hop_cases``'s skewed CSRs are cut into W shards (worker 1 takes the
238-degree hub, so the others pad far past their own edges, and one worker
is mostly pads).  Each shard gets the partitioner's padded layout: its edges
in canonical order, padded to the longest shard with pads on the trash
segment ``v_max``.  The worker form is the wrappers' ordinary call on the
flattened real-edge CSR (``kernels.hop_scatter.worker_csr``): on CPU tensors
their plain versions, which must equal

* today's plain versions called once per worker on that worker's padded
  CSR (``np.array_equal``), and
* the JAX package's Pallas kernels in interpret mode vmapped over the
  workers on ``build_worker_layouts`` (how the reference's partitioned
  executor runs them).

Counts are small integers, exact in any order.  ``test_torch_kernels.py``
holds the CUDA launches to these plain versions on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hop_cases
from repro.kernels import hop_scatter as JHK
from repro_torch.kernels import hop_scatter as HK

Q, R, V, W = 3, 40, 200, 4
BLOCK_V = 64


def shard(ptr, seed):
    sh = hop_cases.worker_shards(ptr, W, seed)
    sh["lay"] = HK.worker_csr(sh["ptr_w"], sh["e_max"], "cpu")
    return sh


def layouts(sh):
    lays = JHK.build_worker_layouts(sh["dst_local"], sh["v_max"] + 1, block_v=BLOCK_V,
                                    block_e_mult=128)
    return lays, JHK.stack_layout_tables(lays)


def worker_slots(tab, x_w, fill):
    nb, be = tab["hop_ldst"].shape[1:]
    return jax.vmap(lambda x, g, v: JHK.slots(jnp.asarray(x), g, v, fill).reshape(
        (nb, be) + x.shape[1:]))(jnp.asarray(x_w), tab["hop_gather"], tab["hop_valid"])


@pytest.mark.parametrize("ext", [None, "min", "max"])
@pytest.mark.parametrize("C", [1, 16])
def test_fused_hop_cols_workers(C, ext):
    case = hop_cases.cols_case(C, Q, R, V, C, shared_w=False)
    sh = shard(case["ptr"], C)
    rng = np.random.default_rng(C + 1)
    table = rng.integers(0, 4, size=(Q, W, R, C)).astype(np.float32)
    mch = rng.integers(1, 500, size=(Q, W, R)).astype(np.float32)
    s_w, s_flat = hop_cases.src_rows(sh, rng, R)
    w_w = np.stack([hop_cases.edge_rows(sh, np.moveaxis(case["w"][q], 0, -1), 0.0) for q in range(Q)])
    neutral = {"min": np.inf, "max": -np.inf}.get(ext, 0.0)
    kw = dict(neutral=float(neutral), op_is_min=ext == "min")
    t = torch.from_numpy
    lay = sh["lay"]
    got, got_m = HK.fused_hop_cols(
        t(table).reshape(Q, W * R, C), t(s_flat),
        t(np.stack([hop_cases.at_real(sh, w_w[q]) for q in range(Q)])), lay.ptr,
        mch=t(mch).reshape(Q, W * R) if ext else None, **kw)
    vm = sh["v_max"]
    got = got.reshape(Q, W, vm, C).numpy()
    _, tab = layouts(sh)
    for w in range(W):   # today's plain version, once per worker
        want, want_m = HK.fused_hop_cols_plain(
            t(table[:, w]), t(s_w[w]), t(w_w[:, w]), t(sh["ptr_w"][w]),
            mch=t(mch[:, w]) if ext else None, **kw)
        assert np.array_equal(got[:, w], want[:, :vm].numpy()), w
        if ext:
            assert np.array_equal(got_m.reshape(Q, W, vm)[:, w].numpy(),
                                  want_m[:, :vm].numpy()), w
    for q in range(Q):   # the Pallas kernel vmapped over the workers
        state_p = np.concatenate([table[q], np.zeros((W, 1, C), np.float32)], axis=1)
        mch_p = np.concatenate([mch[q], np.full((W, 1), neutral, np.float32)], axis=1)

        def one(st, s, wt, ss, se, ld, mp):
            return JHK.fused_hop_cols_pallas(st, s, wt, ss, se, ld, BLOCK_V, interpret=True,
                                             mch_p=mp[:, None] if ext else None, **kw)
        want, want_m = jax.vmap(one)(
            jnp.asarray(state_p), worker_slots(tab, s_w, R), worker_slots(tab, w_w[q], 0.0),
            tab["hop_sstart"], tab["hop_send"], tab["hop_ldst"], jnp.asarray(mch_p))
        assert np.array_equal(got[q], np.asarray(want)[:, :vm]), q
        if ext:
            assert np.array_equal(got_m.reshape(Q, W, vm)[q].numpy(),
                                  np.asarray(want_m)[:, :vm]), q
    assert lay.n_pad > 3 * lay.n_real // W            # the shards are pad-heavy


@pytest.mark.parametrize("ext", [None, "max"])
@pytest.mark.parametrize("B", [4, 16])
def test_fused_hop_interval_workers(B, ext):
    case = hop_cases.interval_case(B, Q, R, V, B, shared_w=False)
    sh = shard(case["ptr"], B)
    rng = np.random.default_rng(B + 2)
    cells = rng.integers(0, 3, size=(Q, W, R, B, B + 1)).astype(np.float32)
    cells *= np.triu(np.ones((B, B + 1), np.float32), 1)
    mch = rng.integers(1, 500, size=(Q, W, R)).astype(np.float32)
    s_w, s_flat = hop_cases.src_rows(sh, rng, R)
    pw = {k: np.stack([hop_cases.edge_rows(sh, case[k][q], 0) for q in range(Q)])
          for k in ("w", "sb", "eb")}
    kw = dict(neutral=-np.inf, op_is_min=False) if ext else {}
    t = torch.from_numpy
    got, got_m = HK.fused_hop_interval(
        t(cells).reshape(Q, W * R, B, B + 1), t(s_flat),
        *(t(np.stack([hop_cases.at_real(sh, pw[k][q]) for q in range(Q)])) for k in ("w", "sb", "eb")),
        sh["lay"].ptr, mch=t(mch).reshape(Q, W * R) if ext else None, **kw)
    vm, NC = sh["v_max"], B * (B + 1)
    got = got.reshape(Q, W, vm, B, B + 1).numpy()
    _, tab = layouts(sh)
    for w in range(W):
        want, want_m = HK.fused_hop_interval_plain(
            t(cells[:, w]), t(s_w[w]), *(t(pw[k][:, w]) for k in ("w", "sb", "eb")),
            t(sh["ptr_w"][w]), mch=t(mch[:, w]) if ext else None, **kw)
        assert np.array_equal(got[:, w], want[:, :vm].numpy()), w
        if ext:
            assert np.array_equal(got_m.reshape(Q, W, vm)[:, w].numpy(),
                                  want_m[:, :vm].numpy()), w
    for q in range(Q):
        state_p = np.concatenate([cells[q].reshape(W, R, NC),
                                  np.zeros((W, 1, NC), np.float32)], axis=1)
        mch_p = np.concatenate([mch[q], np.full((W, 1), -np.inf, np.float32)], axis=1)

        def one(st, s, wt, sb, eb, ss, se, ld, mp):
            return JHK.fused_hop_interval_pallas(
                st, s, wt, sb, eb, ss, se, ld, BLOCK_V, B, interpret=True,
                mch_p=mp[:, None] if ext else None, **kw)
        want, want_m = jax.vmap(one)(
            jnp.asarray(state_p), worker_slots(tab, s_w, R),
            *(worker_slots(tab, pw[k][q], 0) for k in ("w", "sb", "eb")),
            tab["hop_sstart"], tab["hop_send"], tab["hop_ldst"], jnp.asarray(mch_p))
        assert np.array_equal(got[q].reshape(W, vm, NC), np.asarray(want)[:, :vm]), q
        if ext:
            assert np.array_equal(got_m.reshape(Q, W, vm)[q].numpy(),
                                  np.asarray(want_m)[:, :vm]), q


@pytest.mark.parametrize("C", [1, 16, 272])
def test_scatter_cols_workers(C):
    ptr = hop_cases.skewed_ptr(np.random.default_rng(C), V)
    sh = shard(ptr, C)
    rng = np.random.default_rng(C + 3)
    contrib_w = rng.integers(0, 5, size=(Q, W, sh["e_max"], C)).astype(np.float32)
    contrib_w[:, sh["eid"] < 0] = 0.0                 # the pads carry nothing
    t = torch.from_numpy
    got = HK.scatter_cols(
        t(np.stack([hop_cases.at_real(sh, contrib_w[q]) for q in range(Q)])), sh["lay"].ptr)
    vm = sh["v_max"]
    got = got.reshape(Q, W, vm, C).numpy()
    _, tab = layouts(sh)
    for w in range(W):
        want = HK.scatter_cols_plain(t(contrib_w[:, w]), t(sh["ptr_w"][w]))
        assert np.array_equal(got[:, w], want[:, :vm].numpy()), w
    for q in range(Q):
        want = jax.vmap(lambda cp, ss, se: JHK.scatter_cols_pallas(
            cp, ss, se, BLOCK_V, interpret=True))(
            worker_slots(tab, contrib_w[q], 0.0), tab["hop_sstart"], tab["hop_send"])
        assert np.array_equal(got[q], np.asarray(want)[:, :vm]), q


def test_worker_csr_leaves_every_pad_out():
    """The flattened CSR's runs are the shards' runs, at real positions, in
    canonical order; the trash segments do not exist in it."""
    ptr = hop_cases.skewed_ptr(np.random.default_rng(5), V)
    sh = shard(ptr, 5)
    lay = sh["lay"]
    real = lay.real.numpy()
    assert lay.n_real == int(ptr[-1]) and (sh["eid"].reshape(-1)[real] >= 0).all()
    fp = lay.ptr.numpy()
    assert fp.shape == (W * sh["v_max"] + 1,) and fp[-1] == lay.n_real
    assert (np.diff(fp) >= 0).all()
    # destination (w, v) walks exactly the global run of its vertex
    eids = sh["eid"].reshape(-1)[real]
    for w in range(W):
        for v in range(sh["v_max"]):
            run = eids[fp[w * sh["v_max"] + v]: fp[w * sh["v_max"] + v + 1]]
            if len(run):
                assert np.array_equal(run, np.arange(run[0], run[0] + len(run)))
    assert lay.n_pad == W * sh["e_max"] - lay.n_real > 0
