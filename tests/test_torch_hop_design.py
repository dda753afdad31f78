"""The hop kernels' design choices on the host, and their plain versions
against the JAX package's Pallas kernels.

* ``lane_group`` — the narrow-row kernels' edge slots per destination — is a
  power of two dividing 32 / (lanes an edge takes) and monotone in the mean
  degree E / V; ``vector_width`` takes float4 lanes only on aligned rows,
  and ``cols_vector_width`` not on B1's packed extremum table;
  ``query_stride`` reads a packed, broadcast or single query axis;
  ``extremum_tiles`` gives B4 a tile for every edge position 0 .. E.
* ``fused_hop_cols_plain`` (B1) and ``fused_hop_interval_plain`` (B2) equal
  ``fused_hop_cols_pallas`` and ``fused_hop_interval_pallas`` in interpret
  mode (``np.array_equal``) on the skewed CSRs of ``hop_cases``: a 238-degree
  destination, degree-0 and degree-1 runs, Q = 3, weights shared across the
  queries or per query, with and without the MIN/MAX channel.  The reference
  kernels take one query at a time over the slot layout of
  ``build_hop_layout``; counts are small integers, exact in any order.
* ``scatter_extremum_plain`` (B4) equals ``scatter_extremum_pallas`` in
  interpret mode on the same CSRs, also with a hub longer than one of the
  CUDA kernel's tiles, dead edges and +-inf among the values, Q = 3, MIN and
  MAX.
``tests/test_torch_kernels.py`` holds the CUDA kernels to the plain versions
on the same shapes.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hop_cases
from repro.kernels import hop_scatter as JHK
from repro_torch.kernels import hop_scatter as HK

NARROW = (1, 2, 4, 8, 16, 32)
Q, N, V = 3, 150, 200
BLOCK_V = 64                # several destination blocks in the reference layout


# =========================================================================
# the lane-group choice
# =========================================================================
@pytest.mark.parametrize("C", NARROW)      # here C = the lanes an edge takes
def test_lane_group_is_a_power_of_two_dividing_the_warp(C):
    for V_ in (1, 7, 1000, 1_380_000):
        for E in (0, 1, V_ // 2, V_, 5 * V_, 64 * V_, 10**9):
            g = HK.lane_group(E, V_, C)
            assert g >= 1 and g & (g - 1) == 0, (E, V_, C, g)
            assert (32 // C) % g == 0, (E, V_, C, g)


@pytest.mark.parametrize("C", NARROW)
def test_lane_group_is_monotone_in_the_mean_degree(C):
    V_ = 1000
    gs = [HK.lane_group(E, V_, C) for E in range(0, 80 * V_, 97)]
    assert gs == sorted(gs)
    assert gs[0] == 1 and gs[-1] == 32 // C


def test_lane_group_at_the_main_path_degree():
    """The main path's graph: 6,881,632 traversal edges over 1,380,000
    destinations (mean 4.99): two edge slots a destination whether an edge
    takes one lane (C = 1) or four (C = 16 in float4s); a sliced hop of
    2,781,395 edges into 100,000 destinations (mean 27.8) gets eight; no
    narrow path, 1."""
    assert HK.lane_group(6_881_632, 1_380_000, 1) == 2
    assert HK.lane_group(6_881_632, 1_380_000, 4) == 2
    assert HK.lane_group(2_781_395, 100_000, 1) == 8
    assert HK.lane_group(2_781_395, 100_000, 16) == 2
    assert HK.lane_group(6_881_632, 1_380_000, 68) == 1
    assert HK.lane_group(6_881_632, 1_380_000, 3) == 1


def test_vector_width():
    """float4 lanes where C is a multiple of 4 and every table starts and
    strides on 16 bytes (B4 too: its query rows)."""
    x = torch.zeros(2, 10, 16)
    assert HK.vector_width(16, (x, 160)) == 4
    assert HK.vector_width(16, (x, 0)) == 4
    assert HK.vector_width(1, (x, 160)) == 1
    assert HK.vector_width(24, (x, 240)) == 4
    assert HK.vector_width(16, (x.view(-1)[1:].view(1, -1)[:, :16], 16)) == 1   # unaligned
    assert HK.vector_width(16, (x, 17)) == 1
    # B4's [Q, E] tables (C = 4: a thread's 4 edges): rows off 16 bytes when
    # E % 4 != 0, every row on them when the channel is shared (stride 0)
    assert HK.vector_width(4, (torch.zeros(3, 1023), 1023)) == 1
    assert HK.vector_width(4, (torch.zeros(1, 1023).expand(3, -1), 0)) == 4


def test_cols_vector_width():
    """B1 loads float4s where ``vector_width`` allows, except where the
    extremum makes it read the packed [N, Q, C + 1] table (C < 8)."""
    for C in (4, 8, 16):
        x, w = torch.zeros(2, 10, C), torch.zeros(1, 7, C).expand(2, -1, -1)
        rows = ((x, HK.query_stride(x, "x")), (w, HK.query_stride(w, "w")))
        assert HK.cols_vector_width(C, False, *rows) == 4
        assert HK.cols_vector_width(C, True, *rows) == (1 if C < HK.SECTOR_FLOATS else 4)
    x = torch.zeros(2, 10, 3)
    assert HK.cols_vector_width(3, False, (x, 30)) == 1


def test_extremum_tiles():
    """B4's tiles cover every edge position 0 .. E, so each destination's run
    start (ptr[v] <= E) lies in exactly one tile: E // tile + 1 tiles, the
    last of which holds no edge when the tile divides E.  The main path's
    delivery shapes: 2,781,395 and 6,881,632 edges.  The tile is the CUDA
    source's (kExtThreads * kExtEdges), which sizes the scratch the wrapper
    allocates from it."""
    tile = HK.EXT_TILE
    assert tile == 1024
    src = (Path(HK.__file__).resolve().parents[2] / "csrc" / "hop_scatter.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (kExt\w+) = (\d+);", src)}
    assert const["kExtThreads"] * const["kExtEdges"] == tile
    for E in (0, 1, tile - 1, tile, tile + 1, 5 * tile, 2_781_395, 6_881_632):
        n = HK.extremum_tiles(E)
        assert (n - 1) * tile <= E < n * tile, (E, n)
    assert HK.extremum_tiles(2_781_395) == 2717
    assert HK.extremum_tiles(6_881_632) == 6721


def test_query_stride():
    """Packed (the per-query size), broadcast (0) or a single query; rows
    that are not contiguous within a query are refused."""
    x = torch.zeros(3, 5, 4)
    assert HK.query_stride(x, "x") == 20
    assert HK.query_stride(x[:1], "x") == 20
    assert HK.query_stride(x[:1].expand(3, -1, -1), "x") == 0
    with pytest.raises(ValueError):
        HK.query_stride(x[:, :, :2], "x")
    with pytest.raises(ValueError):
        HK.query_stride(x[::2], "x")


# =========================================================================
# plain versions vs the Pallas kernels (interpret mode)
# =========================================================================
def _layout(ptr):
    seg = np.repeat(np.arange(V, dtype=np.int32), np.diff(ptr))
    return JHK.build_hop_layout(seg, V, block_v=BLOCK_V, block_e_mult=128)


def _slots(lay, x, fill):
    nb, be = lay.local_dst.shape
    x = jnp.asarray(x)
    return JHK.slots(x, lay.gather_idx, lay.valid, fill).reshape((nb, be) + x.shape[1:])


def _extremum(ext):
    if ext is None:
        return {}, None
    is_min = ext == "min"
    return dict(neutral=float("inf") if is_min else float("-inf"), op_is_min=is_min), is_min


def _mch_p(mch_q, neutral):
    return np.concatenate([mch_q, [neutral]]).astype(np.float32)[:, None]


@pytest.mark.parametrize("ext", [None, "min", "max"])
@pytest.mark.parametrize("shared_w", [False, True])
@pytest.mark.parametrize("C", [1, 16])
def test_fused_hop_cols_plain_equals_pallas(C, shared_w, ext):
    case = hop_cases.cols_case(C + 10 * shared_w, Q, N, V, C, shared_w)
    kw, is_min = _extremum(ext)
    t = torch.from_numpy
    w = t(case["w"]).expand(Q, -1, -1)
    got, got_m = HK.fused_hop_cols_plain(
        t(case["state"]), t(case["src"]), w, t(case["ptr"]),
        mch=t(case["mch"]) if ext else None, **kw)
    lay = _layout(case["ptr"])
    src_sl = _slots(lay, case["src"], N)
    for q in range(Q):
        state_p = np.concatenate([case["state"][q], np.zeros((1, C), np.float32)])
        w_sl = _slots(lay, case["w"][q % case["w"].shape[0]], 0.0)
        want, want_m = JHK.fused_hop_cols_pallas(
            state_p, src_sl, w_sl, lay.seg_start, lay.seg_end, lay.local_dst,
            lay.block_v, interpret=True,
            mch_p=_mch_p(case["mch"][q], kw["neutral"]) if ext else None, **kw)
        assert np.array_equal(got[q].numpy(), np.asarray(want)[:V]), q
        if ext:
            assert np.array_equal(got_m[q].numpy(), np.asarray(want_m)[:V]), q
        else:
            assert got_m is None and want_m is None
    if ext:   # the shapes reach dead edges and empty segments
        assert bool((got_m == kw["neutral"]).any())
        assert bool(torch.isfinite(got_m).any())


@pytest.mark.parametrize("ext", [None, "max"])
@pytest.mark.parametrize("shared_w", [False, True])
@pytest.mark.parametrize("B", [4, 16])
def test_fused_hop_interval_plain_equals_pallas(B, shared_w, ext):
    case = hop_cases.interval_case(B + shared_w, Q, N, V, B, shared_w)
    kw, _ = _extremum(ext)
    t = torch.from_numpy
    w, sb, eb = (t(case[k]).expand(Q, -1) for k in ("w", "sb", "eb"))
    got, got_m = HK.fused_hop_interval_plain(
        t(case["state"]), t(case["src"]), w, sb, eb, t(case["ptr"]),
        mch=t(case["mch"]) if ext else None, **kw)
    lay = _layout(case["ptr"])
    src_sl = _slots(lay, case["src"], N)
    NC = B * (B + 1)
    for q in range(Q):
        r = q % case["w"].shape[0]
        state_p = np.concatenate([case["state"][q].reshape(N, NC), np.zeros((1, NC), np.float32)])
        want, want_m = JHK.fused_hop_interval_pallas(
            state_p, src_sl, _slots(lay, case["w"][r], 0.0), _slots(lay, case["sb"][r], 0),
            _slots(lay, case["eb"][r], 0), lay.seg_start, lay.seg_end, lay.local_dst,
            lay.block_v, B, interpret=True,
            mch_p=_mch_p(case["mch"][q], kw["neutral"]) if ext else None, **kw)
        assert np.array_equal(got[q].reshape(V, NC).numpy(), np.asarray(want)[:V]), q
        if ext:
            assert np.array_equal(got_m[q].numpy(), np.asarray(want_m)[:V]), q


@pytest.mark.parametrize("ext", ["min", "max"])
@pytest.mark.parametrize("hub", ["deg238", "past_a_tile"])
def test_scatter_extremum_plain_equals_pallas(hub, ext):
    tile = HK.EXT_TILE
    rng = np.random.default_rng(41 + (hub == "past_a_tile"))
    ptr = hop_cases.skewed_ptr(rng, V, hub=hop_cases.HUB if hub == "deg238" else tile + 300)
    E = int(ptr[-1])
    m = rng.integers(1, 500, size=(Q, E)).astype(np.float32)
    m[rng.random((Q, E)) < 0.05] = np.inf
    m[rng.random((Q, E)) < 0.05] = -np.inf
    alive = (rng.random((Q, E)) < 0.5).astype(np.float32)
    kw, _ = _extremum(ext)
    t = torch.from_numpy
    got = HK.scatter_extremum_plain(t(m), t(alive), t(ptr), **kw)
    lay = _layout(ptr)
    for q in range(Q):
        want = JHK.scatter_extremum_pallas(
            _slots(lay, m[q], kw["neutral"]), _slots(lay, alive[q], 0.0), lay.local_dst,
            lay.block_v, interpret=True, **kw)
        assert np.array_equal(got[q].numpy(), np.asarray(want)[:V]), q
    # the shapes reach empty runs and all-dead runs, finite values and both infinities
    assert bool((got == kw["neutral"]).any())
    assert bool(torch.isfinite(got).any())
    assert bool((got == -kw["neutral"]).any())
    assert int(np.diff(ptr).max()) > (tile if hub == "past_a_tile" else 200)
