"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test needs an NVIDIA Hopper card (capability 9.0) and nvcc, and
skips elsewhere; run them there with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py``.

Hop kernels: inputs are small non-negative integers in float32, so every sum
is exact and the comparison is ``torch.equal`` whatever order the kernel sums
in; B1, B2 and B3 also on the skewed CSRs of ``hop_cases`` (the shapes on
which ``tests/test_torch_hop_design.py`` holds B1's and B2's plain versions
to the JAX package), B1 and B2 on a 2^20-edge hub, B1 at every lane-group
size with and without the extremum, and B1 once with
sums above 2^24 over at most 8 edges a destination, held to rtol 1e-6 (each
order's rounding error is at most 7 units of 2^-24 of the sum); their worker
form (the partitioned executor's one launch over every worker's CSR) on
``hop_cases.worker_shards``, with a pad-heavy variant whose pads carry NaN.
Gated min/max (B4): ``torch.equal`` to the plain version around its tiles
of 1,024 edges (runs across one tile edge or several, runs ending on one,
a destination over several tiles, all runs empty, E = 0), on zipf and
skewed CSRs with +-inf, on a channel shared by the queries and on an
unaligned view (scalar loads).
Attention: atol = rtol = 2e-5 in float32 (the tolerance of
``tests/test_kernels.py``'s sweep); in bf16 atol 1e-3 and rtol 2^-7, one
bf16 rounding of the output, tighter than that sweep's 2e-2, since kernel and
plain version both sum in float32 (the tensor-core route also rounds p to
bf16 before P V, which moves each term by at most 2^-9 of its weight).
Each attention test also checks which of the three routes launched.  EmbeddingBag: atol 1e-5
against the plain version (exact at one row a bag), and the table-batched
launch bit-equal to its single-table calls.  Segment-sum
(B5): small integers are exact in any order (``torch.equal``); normal
values within atol = rtol = 1e-4 in float32 (the reference's sweep) and one
bf16 rounding (rtol 2^-7) in bfloat16, since both versions sum in float32.
TimeWarp (B6): equal values, NaN in the same places and the same signs of
zero.  GNN forwards on the card: impl='cuda' within 1e-4 of the largest
|output| of impl='torch' (summation order)."""
import hop_cases
import numpy as np
import pytest
import torch

from repro_torch.kernels import bucket_scatter as BS
from repro_torch.kernels import embedding_bag as EB
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import hop_scatter as HK
from repro_torch.kernels import interval_warp as IW

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda")


def _csr(rng, V, max_deg=40):
    """Arrival CSR with a heavy tail (a few hubs, many empty runs)."""
    deg = np.minimum(rng.zipf(1.8, size=V) - 1, max_deg)
    ptr = np.zeros(V + 1, np.int32)
    np.cumsum(deg, out=ptr[1:])
    return ptr


def _inputs(seed, Q, N, V, C, dev, shared_w=False):
    rng = np.random.default_rng(seed)
    ptr = _csr(rng, V)
    E = int(ptr[-1])
    src = rng.integers(0, N + 1, size=E).astype(np.int32)   # N = zero row
    state = rng.integers(0, 4, size=(Q, N, C)).astype(np.float32)
    wq = 1 if shared_w else Q
    w = (rng.random((wq, E, C)) < 0.6).astype(np.float32)
    mch = rng.integers(1, 500, size=(Q, N)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)
    w_t = t(w).expand(Q, -1, -1) if shared_w else t(w)
    return t(state), t(src), w_t, t(ptr), t(mch), rng


@pytest.mark.parametrize("C", [1, 16, 24])
@pytest.mark.parametrize("extremum", [False, True])
@pytest.mark.parametrize("shared_w", [False, True])
def test_fused_hop_cols(dev, C, extremum, shared_w):
    state, src, w, ptr, mch, _ = _inputs(1, 3, 500, 700, C, dev, shared_w)
    kw = dict(mch=mch, neutral=float("inf"), op_is_min=True) if extremum else {}
    n0 = HK.LAUNCHES["fused_hop_cols"]
    out, mm = HK.fused_hop_cols(state, src, w, ptr, **kw)
    torch.cuda.synchronize()
    assert HK.LAUNCHES["fused_hop_cols"] == n0 + 1
    ref, ref_mm = HK.fused_hop_cols_plain(state, src, w, ptr, **kw)
    assert torch.equal(out, ref)
    if extremum:
        assert torch.equal(mm, ref_mm)
    else:
        assert mm is None


@pytest.mark.parametrize("B", [4, 16, 40])
@pytest.mark.parametrize("extremum", [False, True])
def test_fused_hop_interval(dev, B, extremum):
    Q, N, V = 2, 300, 400
    rng = np.random.default_rng(B)
    ptr = _csr(rng, V)
    E = int(ptr[-1])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cells = rng.integers(0, 3, size=(Q, N, B, B + 1)).astype(np.float32)
    cells *= np.triu(np.ones((B, B + 1), np.float32), 1)     # s < e cells
    src = t(rng.integers(0, N + 1, size=E).astype(np.int32))
    w = t((rng.random((Q, E)) < 0.7).astype(np.float32))
    sb = t(rng.integers(0, B, size=(Q, E)).astype(np.int32))
    eb = t(rng.integers(0, B + 1, size=(Q, E)).astype(np.int32))
    mch = t(rng.integers(1, 500, size=(Q, N)).astype(np.float32))
    kw = dict(mch=mch, neutral=float("-inf"), op_is_min=False) if extremum else {}
    out, mm = HK.fused_hop_interval(t(cells), src, w, sb, eb, t(ptr), **kw)
    torch.cuda.synchronize()
    ref, ref_mm = HK.fused_hop_interval_plain(t(cells), src, w, sb, eb, t(ptr), **kw)
    assert torch.equal(out, ref)
    if extremum:
        assert torch.equal(mm, ref_mm)


def _run_cols(case, dev, ext, Q):
    """B1 on a hop_cases operand dict against its plain version."""
    t = lambda a: torch.from_numpy(a).to(dev)
    kw = {}
    if ext:
        kw = dict(mch=t(case["mch"]), neutral=float("inf") if ext == "min" else float("-inf"),
                  op_is_min=ext == "min")
    a = (t(case["state"]), t(case["src"]), t(case["w"]).expand(Q, -1, -1), t(case["ptr"]))
    n0 = HK.LAUNCHES["fused_hop_cols"]
    out, mm = HK.fused_hop_cols(*a, **kw)
    torch.cuda.synchronize()
    assert HK.LAUNCHES["fused_hop_cols"] == n0 + 1
    ref, ref_mm = HK.fused_hop_cols_plain(*a, **kw)
    return out, mm, ref, ref_mm


@pytest.mark.parametrize("ext", [None, "min", "max"])
@pytest.mark.parametrize("shared_w", [False, True])
@pytest.mark.parametrize("Q", [1, 3, 8, 11])
@pytest.mark.parametrize("C", [1, 4, 16, 32, 64, 128])
def test_fused_hop_cols_skewed(dev, C, Q, shared_w, ext):
    """Degree-0 and degree-1 runs, each lane-group size +-1, a 238-degree
    destination; query tiles of 8 with a partial last tile at Q = 11; at
    C = 64 and 128 an edge takes 16 and 32 float4 lanes."""
    case = hop_cases.cols_case(C * 100 + Q, Q, 200, 300, C, shared_w)
    out, mm, ref, ref_mm = _run_cols(case, dev, ext, Q)
    assert torch.equal(out, ref)
    if ext:
        assert torch.equal(mm, ref_mm)
        assert bool((ref_mm == float("inf") if ext == "min" else ref_mm == float("-inf")).any())
    else:
        assert mm is None


@pytest.mark.parametrize("ext", [None, "max"])
@pytest.mark.parametrize("C", [1, 4, 16])
@pytest.mark.parametrize("g", hop_cases.GROUPS)
def test_fused_hop_cols_each_lane_group(dev, g, C, ext):
    """Mean degree near 2g, so the wrapper's lane group runs through every
    size it can take at this C (a 238-degree destination among them).  The
    lanes an edge takes are C / 4 on float4 lanes, but C where the extremum
    reads the packed [N, Q, C + 1] table (C < 8)."""
    rng = np.random.default_rng(g * 10 + C)
    V, N, Q = 400, 300, 8
    deg = rng.integers(2 * g - 1, 2 * g + 2, size=V)   # mean degree just above 2g
    deg[7] = hop_cases.HUB
    ptr = np.zeros(V + 1, np.int32)
    np.cumsum(deg, out=ptr[1:])
    E = int(ptr[-1])
    case = dict(state=rng.integers(0, 4, size=(Q, N, C)).astype(np.float32),
                src=rng.integers(0, N + 1, size=E).astype(np.int32),
                w=(rng.random((1, E, C)) < 0.6).astype(np.float32), ptr=ptr,
                mch=rng.integers(1, 500, size=(Q, N)).astype(np.float32))
    state = torch.from_numpy(case["state"]).to(dev)
    w = torch.from_numpy(case["w"]).to(dev).expand(Q, -1, -1)
    vec = HK.cols_vector_width(C, ext is not None, (state, HK.query_stride(state, "state")),
                               (w, HK.query_stride(w, "w")))
    assert vec == (4 if C % 4 == 0 and not (ext and C < 8) else 1)
    lanes = C // vec
    assert HK.lane_group(E, V, lanes) == min(g, 32 // lanes)
    out, mm, ref, ref_mm = _run_cols(case, dev, ext, Q)
    assert torch.equal(out, ref)
    if ext:
        assert torch.equal(mm, ref_mm)


@pytest.mark.parametrize("C", [1, 16])
def test_fused_hop_cols_hub_of_2_20_edges(dev, C):
    rng = np.random.default_rng(C)
    V, N, Q = 500, 4000, 3
    deg = np.minimum(rng.zipf(1.8, size=V) - 1, 40)
    deg[123] = 1 << 20
    ptr = np.zeros(V + 1, np.int64)
    np.cumsum(deg, out=ptr[1:])
    E = int(ptr[-1])
    case = dict(state=rng.integers(0, 4, size=(Q, N, C)).astype(np.float32),
                src=rng.integers(0, N + 1, size=E).astype(np.int32),
                w=(rng.random((Q, E, C)) < 0.6).astype(np.float32), ptr=ptr.astype(np.int32),
                mch=rng.integers(1, 500, size=(Q, N)).astype(np.float32))
    out, mm, ref, ref_mm = _run_cols(case, dev, "min", Q)
    assert torch.equal(out, ref) and torch.equal(mm, ref_mm)


@pytest.mark.parametrize("C", [1, 16])
def test_fused_hop_cols_sums_above_2_24(dev, C):
    """Odd counts in [2^20, 2^22) over at most 8 edges a destination: sums
    pass 2^24, so the two summation orders may round apart, each by at most
    7 units of 2^-24 of the sum: rtol 1e-6."""
    rng = np.random.default_rng(24 + C)
    V, N, Q = 600, 500, 8
    deg = rng.integers(0, 9, size=V)
    ptr = np.zeros(V + 1, np.int32)
    np.cumsum(deg, out=ptr[1:])
    E = int(ptr[-1])
    case = dict(state=(2 * rng.integers(1 << 19, 1 << 21, size=(Q, N, C)) + 1).astype(np.float32),
                src=rng.integers(0, N, size=E).astype(np.int32),
                w=np.ones((1, E, C), np.float32), ptr=ptr,
                mch=rng.integers(1, 500, size=(Q, N)).astype(np.float32))
    out, mm, ref, ref_mm = _run_cols(case, dev, "min", Q)
    assert bool((ref >= 2.0 ** 24).any())
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=0)
    assert torch.equal(mm, ref_mm)


def _run_interval(case, dev, ext, Q, B):
    t = lambda a: torch.from_numpy(a).to(dev)
    kw = {}
    if ext:
        kw = dict(mch=t(case["mch"]), neutral=float("inf") if ext == "min" else float("-inf"),
                  op_is_min=ext == "min")
    w, sb, eb = (t(case[k]).expand(Q, -1) for k in ("w", "sb", "eb"))
    a = (t(case["state"]), t(case["src"]), w, sb, eb, t(case["ptr"]))
    n0 = HK.LAUNCHES["fused_hop_interval"]
    out, mm = HK.fused_hop_interval(*a, **kw)
    torch.cuda.synchronize()
    assert HK.LAUNCHES["fused_hop_interval"] == n0 + 1
    ref, ref_mm = HK.fused_hop_interval_plain(*a, **kw)
    return out, mm, ref, ref_mm


@pytest.mark.parametrize("ext", [None, "min", "max"])
@pytest.mark.parametrize("shared_w", [False, True])
@pytest.mark.parametrize("Q", [1, 3])
@pytest.mark.parametrize("B", [4, 16, 31, 40])
def test_fused_hop_interval_skewed(dev, B, Q, shared_w, ext):
    """The warp path (B + 1 <= 32) and the block path (B = 40) on the
    skewed CSRs."""
    case = hop_cases.interval_case(B * 10 + Q, Q, 150, 200, B, shared_w)
    out, mm, ref, ref_mm = _run_interval(case, dev, ext, Q, B)
    assert torch.equal(out, ref)
    if ext:
        assert torch.equal(mm, ref_mm)
    else:
        assert mm is None


def test_fused_hop_interval_hub_of_2_20_edges(dev):
    rng = np.random.default_rng(20)
    V, N, Q, B = 300, 2000, 1, 16
    deg = np.minimum(rng.zipf(1.8, size=V) - 1, 40)
    deg[77] = 1 << 20
    ptr = np.zeros(V + 1, np.int64)
    np.cumsum(deg, out=ptr[1:])
    E = int(ptr[-1])
    cells = rng.integers(0, 3, size=(Q, N, B, B + 1)).astype(np.float32)
    cells *= np.triu(np.ones((B, B + 1), np.float32), 1)
    case = dict(state=cells, src=rng.integers(0, N + 1, size=E).astype(np.int32),
                w=(rng.random((Q, E)) < 0.7).astype(np.float32),
                sb=rng.integers(0, B, size=(Q, E)).astype(np.int32),
                eb=rng.integers(0, B + 1, size=(Q, E)).astype(np.int32),
                ptr=ptr.astype(np.int32), mch=rng.integers(1, 500, size=(Q, N)).astype(np.float32))
    out, mm, ref, ref_mm = _run_interval(case, dev, "max", Q, B)
    assert torch.equal(out, ref) and torch.equal(mm, ref_mm)


@pytest.mark.parametrize("C", [1, 16, 272])
def test_scatter_cols(dev, C):
    rng = np.random.default_rng(C)
    ptr = _csr(rng, 900)
    E = int(ptr[-1])
    contrib = torch.from_numpy(
        rng.integers(0, 5, size=(2, E, C)).astype(np.float32)).to(dev)
    ptr_t = torch.from_numpy(ptr).to(dev)
    out = HK.scatter_cols(contrib, ptr_t)
    torch.cuda.synchronize()
    assert torch.equal(out, HK.scatter_cols_plain(contrib, ptr_t))


@pytest.mark.parametrize("Q", [1, 3, 11])
@pytest.mark.parametrize("C", [1, 4, 16, 64, 128, 272])
def test_scatter_cols_skewed(dev, C, Q):
    """B3 on the skewed CSRs of ``hop_cases``: every lane-group size, float4
    lanes up to 32 an edge (C = 128) and the wide path (C = 272)."""
    rng = np.random.default_rng(C * 100 + Q)
    ptr = hop_cases.skewed_ptr(rng, 300)
    E = int(ptr[-1])
    contrib = torch.from_numpy(rng.integers(0, 5, size=(Q, E, C)).astype(np.float32)).to(dev)
    ptr_t = torch.from_numpy(ptr).to(dev)
    n0 = HK.LAUNCHES["scatter_cols"]
    out = HK.scatter_cols(contrib, ptr_t)
    torch.cuda.synchronize()
    assert HK.LAUNCHES["scatter_cols"] == n0 + 1
    assert torch.equal(out, HK.scatter_cols_plain(contrib, ptr_t))


# ---- the worker form (the partitioned executor): every worker in one launch
W_SHARDS, R_ROWS = 4, 40


def _shards(dev, seed, ptr, pad_heavy: bool):
    """``hop_cases.worker_shards`` of ``ptr`` with its flattened CSR on the
    card.  ``pad_heavy`` appends a 2^20-edge hub on worker 1, so every other
    worker's row is more than 2^20 pads (its trash segment), the kind of run
    one warp would walk if the pads were in the CSR.

    That no lane walks a pad is a property of the CSR the kernel is given,
    checked here: it covers the real edges only (``ptr[-1]`` is their
    count), and each destination's run is its vertex's run in the global
    CSR.  The pads are not in the operands at all."""
    if pad_heavy:
        ptr = np.concatenate([ptr, [ptr[-1] + (1 << 20)]]).astype(np.int32)
    sh = hop_cases.worker_shards(ptr, W_SHARDS, seed)
    lay = sh["lay"] = HK.worker_csr(sh["ptr_w"], sh["e_max"], dev)
    fp = lay.ptr.cpu().numpy().astype(np.int64)
    assert fp[-1] == lay.n_real == int(ptr[-1])
    eids = sh["eid"].reshape(-1)[lay.real.cpu().numpy()]
    for d in np.nonzero(np.diff(fp))[0]:
        run = eids[fp[d]:fp[d + 1]]
        v = np.searchsorted(ptr, run[0], side="right") - 1
        assert np.array_equal(run, np.arange(ptr[v], ptr[v + 1]))
    if pad_heavy:
        assert lay.n_pad > (1 << 20)
    return sh


@pytest.mark.parametrize("pad_heavy", [False, True])
@pytest.mark.parametrize("ext", [None, "min"])
@pytest.mark.parametrize("C", [1, 16])
def test_fused_hop_cols_workers(dev, C, ext, pad_heavy):
    """B1 over every shard: one launch on the flattened CSR, equal to its
    plain version."""
    Q = 3
    rng = np.random.default_rng(C + 10 * pad_heavy)
    sh = _shards(dev, C, hop_cases.skewed_ptr(rng, 300), pad_heavy)
    lay = sh["lay"]
    E = int(sh["eid"].max()) + 1
    w_e = (rng.random((Q, C, E)) < 0.6).astype(np.float32)
    _, s_flat = hop_cases.src_rows(sh, rng, R_ROWS)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    state = t(rng.integers(0, 4, size=(Q, W_SHARDS * R_ROWS, C)).astype(np.float32))
    w = t(np.stack([hop_cases.at_real(sh, hop_cases.edge_rows(sh, w_e[q], 0.0))
                    for q in range(Q)]))
    kw = dict(mch=t(rng.integers(1, 500, size=(Q, W_SHARDS * R_ROWS)).astype(np.float32)),
              neutral=float("inf"), op_is_min=True) if ext else {}
    n0 = HK.LAUNCHES["fused_hop_cols"]
    out, mm = HK.fused_hop_cols(state, t(s_flat), w, lay.ptr, **kw)
    torch.cuda.synchronize()
    assert HK.LAUNCHES["fused_hop_cols"] == n0 + 1
    ref, ref_mm = HK.fused_hop_cols_plain(state, t(s_flat), w, lay.ptr, **kw)
    assert torch.equal(out, ref)
    if ext:
        assert torch.equal(mm, ref_mm)


@pytest.mark.parametrize("pad_heavy", [False, True])
@pytest.mark.parametrize("ext", [None, "max"])
def test_fused_hop_interval_workers(dev, ext, pad_heavy):
    Q, B = 1, 16
    rng = np.random.default_rng(7 + pad_heavy)
    sh = _shards(dev, 3, hop_cases.skewed_ptr(rng, 300), pad_heavy)
    lay = sh["lay"]
    E = int(sh["eid"].max()) + 1
    _, s_flat = hop_cases.src_rows(sh, rng, R_ROWS)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cells = rng.integers(0, 3, size=(Q, W_SHARDS * R_ROWS, B, B + 1)).astype(np.float32)
    cells *= np.triu(np.ones((B, B + 1), np.float32), 1)
    per = dict(w=(rng.random((Q, E)) < 0.7).astype(np.float32),
               sb=rng.integers(0, B, size=(Q, E)).astype(np.int32),
               eb=rng.integers(0, B + 1, size=(Q, E)).astype(np.int32))
    ops = [t(np.stack([hop_cases.at_real(sh, hop_cases.edge_rows(sh, per[k][q], 0))
                       for q in range(Q)])) for k in ("w", "sb", "eb")]
    kw = dict(mch=t(rng.integers(1, 500, size=(Q, W_SHARDS * R_ROWS)).astype(np.float32)),
              neutral=float("-inf"), op_is_min=False) if ext else {}
    n0 = HK.LAUNCHES["fused_hop_interval"]
    out, mm = HK.fused_hop_interval(t(cells), t(s_flat), *ops, lay.ptr, **kw)
    torch.cuda.synchronize()
    assert HK.LAUNCHES["fused_hop_interval"] == n0 + 1
    ref, ref_mm = HK.fused_hop_interval_plain(t(cells), t(s_flat), *ops, lay.ptr, **kw)
    assert torch.equal(out, ref)
    if ext:
        assert torch.equal(mm, ref_mm)


@pytest.mark.parametrize("pad_heavy", [False, True])
@pytest.mark.parametrize("C", [1, 16, 272])
def test_scatter_cols_workers(dev, C, pad_heavy):
    Q = 2
    rng = np.random.default_rng(C + pad_heavy)
    sh = _shards(dev, 5, hop_cases.skewed_ptr(rng, 300), pad_heavy)
    E = int(sh["eid"].max()) + 1
    contrib_e = rng.integers(0, 5, size=(Q, C, E)).astype(np.float32)
    contrib = torch.from_numpy(np.stack([hop_cases.at_real(
        sh, hop_cases.edge_rows(sh, contrib_e[q], 0.0)) for q in range(Q)])).to(dev)
    n0 = HK.LAUNCHES["scatter_cols"]
    out = HK.scatter_cols(contrib, sh["lay"].ptr)
    torch.cuda.synchronize()
    assert HK.LAUNCHES["scatter_cols"] == n0 + 1
    assert torch.equal(out, HK.scatter_cols_plain(contrib, sh["lay"].ptr))


def _extremum_ptr(case, rng):
    """B4's arrival pointers, cut around its tile of T edges: runs that cross
    one tile edge or several, runs that end exactly on one, all runs empty,
    E = 0, one destination over several tiles, and zipf CSRs."""
    T = HK.EXT_TILE
    if case in ("zipf", "strided", "unaligned"):
        return _csr(rng, 900)
    if case == "row_shifts":       # E = 1 mod 4: five query rows start 0, 1, 2, 3, 0 floats
        ptr = _csr(rng, 3000).astype(np.int64)   # past a 16-byte boundary (scalar loads)
        ptr[-1] += (1 - ptr[-1]) % 4
        return ptr.astype(np.int32)
    if case == "skewed":
        return hop_cases.skewed_ptr(rng, 200, hub=T + 300)
    deg = {"cross_one": [T - 5, 10] + [1] * 300,           # run 1 holds edge T
           "cross_several": [7, 3 * T + 11, 2] + [0] * 20 + [T],
           "tile_edge": [T, 0, T, 5, T - 5, 0, 3],         # runs end at T, 2T, 3T
           "all_empty": [0] * 3000,
           "E0": [0],
           "one_dest": [3 * T + 17]}[case]
    ptr = np.zeros(len(deg) + 1, np.int32)
    np.cumsum(deg, out=ptr[1:])
    return ptr


@pytest.mark.parametrize("case", ["zipf", "skewed", "cross_one", "cross_several", "tile_edge",
                                  "all_empty", "E0", "one_dest", "strided", "unaligned",
                                  "row_shifts"])
@pytest.mark.parametrize("op_is_min", [True, False])
def test_scatter_extremum(dev, op_is_min, case):
    """B4 equals its plain version: dead edges, +-inf among the values
    (``skewed``), a channel shared by every query (query stride 0), and the
    scalar loads on query rows that start off 16 bytes (``row_shifts``, and
    every case with E % 4 != 0) and on an unaligned view."""
    rng = np.random.default_rng(7)
    ptr = _extremum_ptr(case, rng)
    E, Q = int(ptr[-1]), 5 if case == "row_shifts" else 3
    t = lambda a: torch.from_numpy(a).to(dev)
    m = rng.integers(1, 500, size=(Q, E)).astype(np.float32)
    if case == "skewed":
        m[rng.random((Q, E)) < 0.05] = np.inf
        m[rng.random((Q, E)) < 0.05] = -np.inf
    m = t(m)
    alive = t((rng.random((Q, E)) < 0.5).astype(np.float32))
    if case == "strided":
        m = m[:1].expand(Q, -1)
    if case == "unaligned":
        flat = torch.empty(Q * E + 1, device=dev)
        m = flat[1:].view(Q, E).copy_(m)
        assert HK.vector_width(HK.VEC, (m, HK.query_stride(m, "m_e"))) == 1
    neutral = float("inf") if op_is_min else float("-inf")
    n0 = HK.LAUNCHES["scatter_extremum"]
    out = HK.scatter_extremum(m, alive, t(ptr), neutral, op_is_min)
    torch.cuda.synchronize()
    assert HK.LAUNCHES["scatter_extremum"] == n0 + 1
    assert torch.equal(out, HK.scatter_extremum_plain(m, alive, t(ptr), neutral, op_is_min))


def test_scatter_extremum_short_scratch(dev):
    """B4's C entry point refuses a tile scratch shorter than its own tile
    size needs (E // kExtTile + 2 ints) and launches nothing, so a Python
    tile size that disagrees with the C one cannot write past the scratch."""
    from repro_torch.kernels import build

    E, V, Q = 5 * HK.EXT_TILE + 3, 40, 2
    ptr = torch.linspace(0, E, V + 1, device=dev).round().to(torch.int32)
    m = torch.ones(Q, E, device=dev)
    out = torch.full((Q, V), 7.0, device=dev)
    tile_lo = torch.zeros(HK.extremum_tiles(E) + 1, dtype=torch.int32, device=dev)
    for n in (tile_lo.numel() - 1, 0):
        err = build.load().hop_scatter_extremum(
            m.data_ptr(), E, m.data_ptr(), E, ptr.data_ptr(), V, E, Q, 1, float("inf"), 1,
            tile_lo.data_ptr(), n, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        torch.cuda.synchronize()
        assert err != 0
    assert bool((out == 7.0).all()) and not bool(tile_lo.any())


def test_wrappers_refuse_bad_operands(dev):
    state, src, w, ptr, _, _ = _inputs(3, 2, 50, 60, 1, dev)
    with pytest.raises(ValueError):
        HK.fused_hop_cols(state, src.cpu(), w, ptr)            # mixed devices
    with pytest.raises(TypeError):
        HK.fused_hop_cols(state, src, w.double(), ptr)         # wrong dtype
    with pytest.raises(ValueError):
        HK.fused_hop_cols(state, src, w[:, :-1], ptr)          # wrong shape


# =========================================================================
# B7 attention
# =========================================================================
def _normal(seed, shape, dev, dtype):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)


def _tol(dtype):
    if dtype == torch.float32:
        return dict(atol=2e-5, rtol=2e-5)
    # both sum in float32 and round the output to bf16 once: one rounding apart
    return dict(atol=1e-3, rtol=2.0 ** -7)


@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (1, 4, 2, 128, 64),
    (2, 8, 8, 256, 64),
    (1, 8, 1, 128, 128),   # MQA
    (2, 2, 2, 192, 32),    # a sequence that is no multiple of the tiles
    (2, 8, 4, 200, 256),   # gemma3-4b's heads
    (2, 4, 2, 20, 16),     # gemma3-4b SMOKE's heads
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64), (False, None), (False, 64)])
def test_flash_attention(dev, B, Hq, Hkv, S, D, dtype, causal, window):
    q = _normal(1, (B, Hq, S, D), dev, dtype)
    k = _normal(2, (B, Hkv, S, D), dev, dtype)
    v = _normal(3, (B, Hkv, S, D), dev, dtype)
    n0 = FA.LAUNCHES["flash_attention"]
    out = FA.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["flash_attention"] == n0 + 1
    want = FA.attention_plain(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("window", [None, 1024])
@pytest.mark.parametrize("cache_len", [1, 63, 199, 1025, 2079])
def test_decode_attention(dev, dtype, window, cache_len):
    """One token against a [B, Hkv, 2080, 256] cache whose rows past
    cache_len hold values the kernel must not see."""
    q = _normal(4, (2, 8, 1, 256), dev, dtype)
    kc = _normal(5, (2, 4, 2080, 256), dev, dtype)
    vc = _normal(6, (2, 4, 2080, 256), dev, dtype)
    out = FA.decode_attention(q, kc, vc, cache_len, window=window)
    torch.cuda.synchronize()
    want = FA.attention_plain(q, kc[:, :, :cache_len], vc[:, :, :cache_len], causal=True,
                              window=window, q_offset=cache_len - 1)
    torch.testing.assert_close(out.float(), want.float(), **_tol(dtype))


def test_flash_attention_takes_strided_views(dev):
    """q, k, v as the transformer hands them over: [B, S, H, D] projections
    seen as [B, H, S, D], and a layer of a [L, B, H, S, D] cache."""
    B, S, Hq, Hkv, D = 2, 77, 8, 4, 256
    q = _normal(7, (B, S, Hq, D), dev, torch.bfloat16).transpose(1, 2)
    cache = _normal(8, (3, B, Hkv, 96, D), dev, torch.bfloat16)
    k, v = cache[1, :, :, :S], cache[2, :, :, :S]
    out = FA.flash_attention(q, k, v, causal=True, window=16)
    torch.cuda.synchronize()
    want = FA.attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), window=16)
    torch.testing.assert_close(out.float(), want.float(), **_tol(torch.bfloat16))


def test_flash_attention_rows_that_see_no_key_are_zero(dev):
    q = _normal(9, (1, 2, 40, 64), dev, torch.float32)
    k = _normal(10, (1, 1, 100, 64), dev, torch.float32)
    out = FA.flash_attention(q, k, k, causal=True, q_offset=-20)
    torch.cuda.synchronize()
    want = FA.attention_plain(q, k, k, causal=True, q_offset=-20)
    assert torch.equal(out[:, :, :20], torch.zeros_like(out[:, :, :20]))
    torch.testing.assert_close(out, want, **_tol(torch.float32))


def _launched(route):
    """Counts of the total and of ``route``'s launches, to diff after a call."""
    return FA.LAUNCHES["flash_attention"], FA.LAUNCHES["flash_attention_" + route]


def _check_route(before, route):
    total, own = _launched(route)
    assert (total - before[0], own - before[1]) == (1, 1), route


GEMMA_HEADS = dict(Hq=8, Hkv=4, D=256)     # gemma3-4b's attention at full width


@pytest.mark.parametrize("S,window", [(2048, None), (2048, 1024), (200, None), (1000, 1024),
                                      (1000, None), (129, 64)])
def test_flash_attention_tc_gemma_heads(dev, S, window):
    """The tensor-core prefill (wgmma + TMA) at gemma3-4b's heads: full and
    windowed 2048-token prompts, and ragged lengths off the 128-row and
    64-key tiles."""
    g = GEMMA_HEADS
    q = _normal(11, (2, g["Hq"], S, g["D"]), dev, torch.bfloat16)
    k = _normal(12, (2, g["Hkv"], S, g["D"]), dev, torch.bfloat16)
    v = _normal(13, (2, g["Hkv"], S, g["D"]), dev, torch.bfloat16)
    assert FA.attention_route(q.dtype, g["D"], S, g["Hq"] // g["Hkv"]) == "tc"
    before = _launched("tc")
    out = FA.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    _check_route(before, "tc")
    want = FA.attention_plain(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out.float(), want.float(), **_tol(torch.bfloat16))


@pytest.mark.parametrize("Sq,Sk,q_offset,window", [(300, 1000, 700, None), (300, 1000, 700, 256),
                                                   (100, 100, -20, None), (256, 256, -200, 64),
                                                   (300, 1200, 700, None)])
def test_flash_attention_tc_offsets(dev, Sq, Sk, q_offset, window):
    """Chunked prefill (q_offset > 0: the rows sit after earlier keys; with
    Sk past q_offset + Sq the keys beyond the last row's position hold NaN
    and must never be read) and negative offsets, whose first rows see no
    key and give 0."""
    g = GEMMA_HEADS
    q = _normal(14, (1, g["Hq"], Sq, g["D"]), dev, torch.bfloat16)
    k = _normal(15, (1, g["Hkv"], Sk, g["D"]), dev, torch.bfloat16)
    v = _normal(16, (1, g["Hkv"], Sk, g["D"]), dev, torch.bfloat16)
    end = max(q_offset + Sq, 0)
    k[:, :, end:] = float("nan")
    v[:, :, end:] = float("nan")
    before = _launched("tc")
    out = FA.flash_attention(q, k, v, causal=True, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    _check_route(before, "tc")
    want = FA.attention_plain(q, k[:, :, :end], v[:, :, :end], causal=True, window=window,
                              q_offset=q_offset)
    torch.testing.assert_close(out.float(), want.float(), **_tol(torch.bfloat16))
    if q_offset < 0:
        assert torch.equal(out[:, :, :-q_offset], torch.zeros_like(out[:, :, :-q_offset]))


@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_attention_tc_strided_views(dev, D):
    """q as the [B, S, Hq, D] projection seen as [B, Hq, S, D], k and v as
    layers of [L, B, Hkv, S, D] caches, k and v with different layouts."""
    B, S, Hq, Hkv = 2, 333, 8, 4
    q = _normal(17, (B, S, Hq, D), dev, torch.bfloat16).transpose(1, 2)
    cache = _normal(18, (3, B, Hkv, 400, D), dev, torch.bfloat16)
    k = cache[1, :, :, :S]
    v = _normal(19, (B, S, Hkv, D), dev, torch.bfloat16).transpose(1, 2)
    before = _launched("tc")
    out = FA.flash_attention(q, k, v, causal=True, window=100)
    torch.cuda.synchronize()
    _check_route(before, "tc")
    want = FA.attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), window=100)
    torch.testing.assert_close(out.float(), want.float(), **_tol(torch.bfloat16))


@pytest.mark.parametrize("dtype,D", [(torch.float32, 256), (torch.float32, 64),
                                     (torch.bfloat16, 16), (torch.bfloat16, 32),
                                     (torch.float32, 16)])
def test_flash_attention_simt_routes(dev, dtype, D):
    """Float32 and the narrow head widths keep the CUDA-core kernel."""
    q = _normal(20, (2, 4, 150, D), dev, dtype)
    k = _normal(21, (2, 2, 150, D), dev, dtype)
    v = _normal(22, (2, 2, 150, D), dev, dtype)
    before = _launched("simt")
    out = FA.flash_attention(q, k, v, causal=True, window=40)
    torch.cuda.synchronize()
    _check_route(before, "simt")
    want = FA.attention_plain(q, k, v, causal=True, window=40)
    torch.testing.assert_close(out.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("window", [None, 1024, 100])
@pytest.mark.parametrize("cache_len", [1, 63, 64, 65, 127, 128, 129, 231, 232, 1024, 1025,
                                       1155, 2079, 2080])
def test_decode_split_edges(dev, dtype, window, cache_len):
    """The split-K decode at gemma3-4b's heads (batch 8, the serve path's
    shape) with the last visible row on and either side of split edges (231
    and 1155 are edges of the global layer's 2,079 rows, 128 of the local
    layer's); rows past cache_len hold NaN and must not be read."""
    g = GEMMA_HEADS
    q = _normal(23, (8, g["Hq"], 1, g["D"]), dev, dtype)
    kc = _normal(24, (8, g["Hkv"], 2080, g["D"]), dev, dtype)
    vc = _normal(25, (8, g["Hkv"], 2080, g["D"]), dev, dtype)
    kc[:, :, cache_len:] = float("nan")
    vc[:, :, cache_len:] = float("nan")
    lo, hi = FA.visible_rows(1, 2080, True, window, cache_len - 1)
    splits, chunk = FA.decode_splits(8, g["Hkv"], hi - lo, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    before = _launched("decode")
    out = FA.decode_attention(q, kc, vc, cache_len, window=window)
    torch.cuda.synchronize()
    _check_route(before, "decode")
    want = FA.attention_plain(q, kc[:, :, :cache_len], vc[:, :, :cache_len], causal=True,
                              window=window, q_offset=cache_len - 1)
    torch.testing.assert_close(out.float(), want.float(), **_tol(dtype))
    split = FA.decode_attention_split_plain(q, kc[:, :, :cache_len], vc[:, :, :cache_len],
                                            splits=splits, chunk=chunk, window=window,
                                            q_offset=cache_len - 1)
    torch.testing.assert_close(out.float(), split.float(), **_tol(dtype))


@pytest.mark.parametrize("Sq,group,q_offset,window", [(4, 2, 600, 50), (16, 1, 300, None),
                                                      (8, 2, -3, None), (2, 8, 1000, 7)])
def test_decode_route_several_rows(dev, Sq, group, q_offset, window):
    """Up to 16 query rows a kv head go to the decode kernel, each with its
    own causal bound and window edge inside the splits."""
    Hkv, D, Sk = 2, 128, 1100
    q = _normal(26, (2, Hkv * group, Sq, D), dev, torch.bfloat16)
    k = _normal(27, (2, Hkv, Sk, D), dev, torch.bfloat16)
    v = _normal(28, (2, Hkv, Sk, D), dev, torch.bfloat16)
    before = _launched("decode")
    out = FA.flash_attention(q, k, v, causal=True, window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    _check_route(before, "decode")
    want = FA.attention_plain(q, k, v, causal=True, window=window, q_offset=q_offset)
    torch.testing.assert_close(out.float(), want.float(), **_tol(torch.bfloat16))


def test_flash_attention_refuses_bad_operands(dev):
    q = torch.zeros(1, 2, 8, 64, device=dev)
    with pytest.raises(ValueError):
        FA.flash_attention(q[..., :48], q[..., :48], q[..., :48])   # head width not built
    with pytest.raises(TypeError):
        FA.flash_attention(q, q.bfloat16(), q)                      # mixed dtypes
    with pytest.raises(ValueError):
        FA.flash_attention(q, q.cpu(), q)                            # mixed devices
    odd = torch.zeros(q.numel() + 1, device=dev)[1:].view(q.shape)
    with pytest.raises(ValueError):
        FA.flash_attention(q, odd, q)                                # unaligned base


# =========================================================================
# B8 EmbeddingBag
# =========================================================================
@pytest.mark.parametrize("V,D,Bb,L,past", [(1000, 32, 64, 8, 0), (257, 16, 33, 3, 0),
                                           (4096, 64, 16, 1, 0), (1_000_000, 64, 5000, 1, 0),
                                           (50, 100, 40, 5, 0), (300, 64, 64, 6, 50)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag(dev, V, D, Bb, L, past, mode):
    """``past`` > 0 draws some indices at or above V (clamped to row V - 1)."""
    rng = np.random.default_rng(V + Bb)
    table = torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32)).to(dev)
    idx = rng.integers(-1, V + past, size=(Bb, L)).astype(np.int32)
    idx[0] = -1                                   # a bag with no valid index
    idx_t = torch.from_numpy(idx).to(dev)
    n0 = EB.LAUNCHES["embedding_bag"]
    out = EB.embedding_bag(table, idx_t, mode)
    torch.cuda.synchronize()
    assert EB.LAUNCHES["embedding_bag"] == n0 + 1
    want = EB.embedding_bag_plain(table, idx_t, mode)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=0)
    assert torch.equal(out[0], torch.zeros_like(out[0]))


def test_embedding_bag_skips_indices_past_the_table(dev):
    """Padding is skipped; an index at or above V reads row V - 1 and is
    counted, as the reference's gather clamps it."""
    table = torch.arange(12, dtype=torch.float32, device=dev).view(3, 4)
    idx = torch.tensor([[0, 3, -1], [2, 2, 1 << 30]], dtype=torch.int32, device=dev)
    out = EB.embedding_bag(table, idx, "mean")
    torch.cuda.synchronize()
    assert torch.equal(out, torch.stack([(table[0] + table[2]) / 2, table[2]]))
    assert torch.equal(out, EB.embedding_bag_plain(table, idx, "mean"))


def _bag_operands(rng, F, Bb, L, D, dev, past=5):
    """F tables of their own V (1..300 rows) and [Bb, F, L] indices with
    padding and indices up to ``past`` beyond each table's V."""
    vocabs = rng.integers(1, 300, size=F)
    tables = [torch.from_numpy(rng.normal(size=(v, D)).astype(np.float32)).to(dev)
              for v in vocabs]
    idx = np.stack([rng.integers(-1, v + past, size=(Bb, L)) for v in vocabs], axis=1)
    return tables, torch.from_numpy(idx.astype(np.int32)).to(dev)


@pytest.mark.parametrize("F,D,L", [(1, 64, 1), (26, 64, 1), (26, 64, 3), (64, 64, 1),
                                   (26, 13, 1), (26, 13, 3), (5, 100, 2), (3, 256, 4),
                                   (7, 16, 1)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bags(dev, F, D, L, mode):
    """One launch over F tables equals the F single-table calls bit for bit,
    the plain version exactly at L = 1 (a bag is one row) and within atol
    1e-5 at L > 1; written through ``out=`` into a slice of a NaN-poisoned
    buffer it leaves the neighbouring slots untouched.  D = 13 takes the
    narrow path."""
    rng = np.random.default_rng(F * 1000 + D + L)
    tables, idx = _bag_operands(rng, F, 300, L, D, dev)
    n0 = EB.LAUNCHES["embedding_bag"]
    out = EB.embedding_bags(tables, idx, mode)
    torch.cuda.synchronize()
    assert EB.LAUNCHES["embedding_bag"] == n0 + 1
    assert out.shape == (300, F, D)
    singles = torch.stack([EB.embedding_bag(t, idx[:, f].contiguous(), mode)
                           for f, t in enumerate(tables)], dim=1)
    assert torch.equal(out, singles)
    want = EB.embedding_bags_plain(tables, idx, mode)
    if L == 1:
        assert torch.equal(out, want)
    else:
        torch.testing.assert_close(out, want, atol=1e-5, rtol=0)
    buf = torch.full((300, F + 2, D), float("nan"), device=dev)
    EB.embedding_bags(tables, idx, mode, out=buf[:, 1:F + 1])
    torch.cuda.synchronize()
    assert torch.equal(buf[:, 1:F + 1], out)
    assert bool(torch.isnan(buf[:, 0]).all() and torch.isnan(buf[:, F + 1]).all())


def test_embedding_bags_table_count_and_empty_shapes(dev):
    """64 tables are taken and 65 refused; a batch of 0 bags launches
    nothing; bags of L = 0 are zeros (one launch)."""
    rng = np.random.default_rng(3)
    tables, idx = _bag_operands(rng, 65, 8, 1, 64, dev)
    EB.embedding_bags(tables[:64], idx[:, :64].contiguous())
    with pytest.raises(ValueError):
        EB.embedding_bags(tables, idx)
    n0 = EB.LAUNCHES["embedding_bag"]
    empty = EB.embedding_bags(tables[:26], torch.zeros(0, 26, 1, dtype=torch.int32, device=dev))
    assert empty.shape == (0, 26, 64) and EB.LAUNCHES["embedding_bag"] == n0
    for mode in ("sum", "mean"):
        z = EB.embedding_bags(tables[:26], torch.zeros(8, 26, 0, dtype=torch.int32, device=dev),
                              mode)
        torch.cuda.synchronize()
        assert torch.equal(z, torch.zeros(8, 26, 64, device=dev))
    assert EB.LAUNCHES["embedding_bag"] == n0 + 2


def test_embedding_bags_refuse_bad_operands(dev):
    rng = np.random.default_rng(4)
    tables, idx = _bag_operands(rng, 3, 8, 2, 64, dev)
    with pytest.raises(ValueError):
        EB.embedding_bags(tables, idx.long())
    with pytest.raises(ValueError):
        EB.embedding_bags(tables[:2] + [tables[2][:, :32].contiguous()], idx)   # D differs
    with pytest.raises(ValueError):
        EB.embedding_bags(tables, idx, out=torch.empty(8, 64, 3, device=dev).transpose(1, 2))
    with pytest.raises(ValueError):
        EB.embedding_bags(tables, idx[:, :, :1].expand(8, 3, 2))             # not contiguous


def test_embedding_bag_refuses_bad_operands(dev):
    table = torch.ones(10, 64, device=dev)
    idx = torch.zeros(4, 2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        EB.embedding_bag(table, idx.long())
    with pytest.raises(ValueError):
        EB.embedding_bag(table.double(), idx)
    with pytest.raises(ValueError):
        EB.embedding_bag(table, idx.cpu())


# =========================================================================
# B5 segment-sum
# =========================================================================
def _segments(rng, E, V):
    return torch.from_numpy(np.sort(rng.integers(0, V, size=E)).astype(np.int32))


@pytest.mark.parametrize("E,V,C", [(1000, 100, 8), (5000, 700, 16), (300, 512, 4),
                                   (2000, 300, 1), (2000, 300, 3), (1500, 200, 75),
                                   (168960, 169984, 128), (4000, 900, 64), (700, 50, 9)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bucket_scatter(dev, E, V, C, dtype):
    rng = np.random.default_rng(E + C)
    seg = _segments(rng, E, V).to(dev)
    contrib = torch.from_numpy(rng.normal(size=(E, C)).astype(np.float32)).to(dev, dtype)
    n0 = BS.LAUNCHES["bucket_scatter"]
    out = BS.bucket_scatter(contrib, seg, V)
    torch.cuda.synchronize()
    assert BS.LAUNCHES["bucket_scatter"] == n0 + 1
    assert out.dtype == dtype and tuple(out.shape) == (V, C)
    want = BS.bucket_scatter_plain(contrib, seg, V)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)
    else:
        torch.testing.assert_close(out.float(), want.float(), atol=1e-5, rtol=2.0 ** -7)
    empty = torch.bincount(seg.long(), minlength=V) == 0
    assert bool((out[empty] == 0).all())


@pytest.mark.parametrize("C", [1, 3, 75, 128])
def test_bucket_scatter_exact_with_hub_and_empty_segments(dev, C):
    """Integer contributions are exact in any order: a hub of 10^5 edges,
    long runs of empty segments (first and last included)."""
    rng = np.random.default_rng(C)
    V = 5000
    seg = np.concatenate([np.full(100_000, 17), rng.integers(20, V - 10, size=3000)])
    seg = torch.from_numpy(np.sort(seg).astype(np.int32)).to(dev)
    contrib = torch.from_numpy(rng.integers(-3, 4, size=(seg.numel(), C)).astype(np.float32))
    contrib = contrib.to(dev)
    lay = BS.build_layout(seg, V)
    for dtype in (torch.float32, torch.bfloat16):
        out = BS.bucket_scatter(contrib.to(dtype), seg, V, layout=lay)
        torch.cuda.synchronize()
        # both round the same exact float32 sum once
        assert torch.equal(out, BS.bucket_scatter_plain(contrib.to(dtype), seg, V))
        assert bool((out[:17] == 0).all()) and bool((out[V - 10:] == 0).all())


def _near_one_segments(rng, V, hub):
    """About one edge a segment (a GNN request's union graph): degrees 0, 1
    and 2, empty runs at both ends, one hub."""
    deg = rng.choice([0, 1, 1, 1, 2], size=V)
    deg[:5] = 0
    deg[-5:] = 0
    deg[V // 3] = hub
    return np.repeat(np.arange(V, dtype=np.int32), deg)


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hub", [1, 5000])
def test_bucket_scatter_narrow_at_one_edge_a_segment(dev, C, dtype, hub):
    """B5's narrow path where E is about V: a thread a segment (G = 1)."""
    rng = np.random.default_rng(C + hub)
    V = 169_984
    seg = torch.from_numpy(_near_one_segments(rng, V, hub)).to(dev)
    E = seg.numel()
    assert BS.build_layout(seg, V).lanes == 1
    contrib = torch.from_numpy(rng.normal(size=(E, C)).astype(np.float32)).to(dev, dtype)
    n0 = BS.LAUNCHES["bucket_scatter"]
    out = BS.bucket_scatter(contrib, seg, V, layout=BS.build_layout(seg, V))
    torch.cuda.synchronize()
    assert BS.LAUNCHES["bucket_scatter"] == n0 + 1
    want = BS.bucket_scatter_plain(contrib, seg, V)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)
    else:
        torch.testing.assert_close(out.float(), want.float(), atol=1e-5, rtol=2.0 ** -7)
    empty = torch.bincount(seg.long(), minlength=V) == 0
    assert bool((out[empty] == 0).all())


@pytest.mark.parametrize("E,V", [(4000, 1000), (16_000, 1000), (200_000, 1000)])
@pytest.mark.parametrize("C", [1, 3, 8])
def test_bucket_scatter_narrow_lane_groups(dev, E, V, C):
    """Longer segments take G = 2 .. 32 lanes; integer values are exact in
    any order, so the kernel equals its plain version."""
    rng = np.random.default_rng(E + C)
    seg = _segments(rng, E, V).to(dev)
    assert BS.build_layout(seg, V).lanes > 1
    contrib = torch.from_numpy(rng.integers(-3, 4, size=(E, C)).astype(np.float32)).to(dev)
    out = BS.bucket_scatter(contrib, seg, V)
    torch.cuda.synchronize()
    assert torch.equal(out, BS.bucket_scatter_plain(contrib, seg, V))


def test_bucket_scatter_refuses_bad_operands(dev):
    seg = torch.zeros(6, dtype=torch.int32, device=dev)
    c = torch.ones(6, 4, device=dev)
    with pytest.raises(ValueError):
        BS.bucket_scatter(c.double(), seg, 3)
    with pytest.raises(ValueError):
        BS.bucket_scatter(c.t(), seg, 3)                          # not contiguous
    with pytest.raises(ValueError):
        BS.bucket_scatter(c, seg, 3, layout=BS.build_layout(seg, 4))
    with pytest.raises(ValueError):
        BS.bucket_scatter(c[:5], seg[:5], 3, layout=BS.build_layout(seg, 3))


def test_gnn_forwards_on_card(dev):
    """Each GNN at SMOKE width on a union graph sampled on the card: impl
    'cuda' against impl 'torch', and B5 launched as the models' code says."""
    import dataclasses

    from repro_torch.configs import egnn, meshgraphnet, pna, schnet
    from repro_torch.graphdata.sampler import CSR, sample_union_graph
    from repro_torch.models import gnn as G

    gen = torch.Generator(device=dev).manual_seed(0)
    n = 2000
    csr = CSR.from_edge_index(torch.randint(0, n - 50, (40_000,), generator=gen, device=dev),
                              torch.randint(0, n, (40_000,), generator=gen, device=dev), n,
                              device=dev)
    feats = torch.randn(n, 32, generator=gen, device=dev)
    seeds = torch.randperm(n, generator=gen, device=dev)[:64].to(torch.int32)
    gids, s, d = sample_union_graph(csr, seeds, (15, 10), gen)
    x = feats[gids.long()]
    g = G.GraphBatch(node_feat=x, edge_src=s, edge_dst=d, coords=x[:, :3])
    apply = {"pna": G.pna_apply, "egnn": G.egnn_apply, "meshgraphnet": G.mgn_apply,
             "schnet": G.schnet_apply}
    per_call = {"pna": 17, "egnn": 12, "meshgraphnet": 15, "schnet": 3}
    for arch, mod in (("pna", pna), ("egnn", egnn), ("meshgraphnet", meshgraphnet),
                      ("schnet", schnet)):
        cfg = mod.CONFIG
        params = G.INIT[arch](cfg, gen, 32, device=dev)
        n0 = BS.LAUNCHES["bucket_scatter"]
        got = apply[arch](cfg, params, g)
        torch.cuda.synchronize()
        assert BS.LAUNCHES["bucket_scatter"] - n0 == per_call[arch], arch
        want = apply[arch](dataclasses.replace(cfg, impl="torch"), params, g)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert bool(torch.isfinite(a).all())
            scale = max(float(b.abs().max()), 1.0)
            torch.testing.assert_close(a, b, atol=1e-4 * scale, rtol=0)


# =========================================================================
# B6 TimeWarp
# =========================================================================
def _identical(a, b):
    na, nb = torch.isnan(a), torch.isnan(b)
    return (torch.equal(na, nb) and torch.equal(a[~na], b[~nb])
            and torch.equal(torch.signbit(a[~na]), torch.signbit(b[~nb])))


@pytest.mark.parametrize("N,B", [(512, 8), (3000, 16), (100, 32), (1_380_000, 16), (77, 1),
                                 (1000, 64), (1001, 13), (1003, 16), (333, 64), (5, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 1])
def test_interval_warp(dev, N, B, dtype, offset):
    """The vector path (16-byte chunks: B a multiple of 4 in float32, of 8
    in bfloat16) and the scalar path (other B, and, at ``offset`` 1, a
    contiguous view that starts one element into a larger buffer)."""
    rng = np.random.default_rng(N + B)
    cnts = rng.normal(size=(N, B)).astype(np.float32)
    for v, p in ((np.nan, 0.02), (np.inf, 0.02), (-np.inf, 0.02), (-0.0, 0.05)):
        cnts[rng.random((N, B)) < p] = v
    ivl = np.stack([rng.integers(-50, 1000, N), rng.integers(0, 1200, N)], 1).astype(np.int32)
    be = np.linspace(0, 1100, B + 1).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(dev)
    buf = torch.empty(N * B + offset, dtype=dtype, device=dev)
    counts = buf[offset:].view(N, B)
    counts.copy_(t(cnts).to(dtype))
    assert counts.is_contiguous()
    n0 = IW.LAUNCHES["interval_warp"]
    out = IW.interval_warp(counts, t(ivl), t(be))
    torch.cuda.synchronize()
    assert IW.LAUNCHES["interval_warp"] == n0 + 1
    assert out.dtype == dtype and out.shape == counts.shape
    assert _identical(out, IW.interval_warp_plain(counts, t(ivl), t(be)))


def test_interval_warp_refuses_bad_operands(dev):
    counts = torch.ones(10, 8, device=dev)
    ivl = torch.zeros(10, 2, dtype=torch.int32, device=dev)
    be = torch.arange(9, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        IW.interval_warp(counts, ivl.long(), be)
    with pytest.raises(ValueError):
        IW.interval_warp(counts, ivl, be[:8])
    with pytest.raises(ValueError):
        IW.interval_warp(counts.double(), ivl, be)
    with pytest.raises(ValueError):
        IW.interval_warp(torch.ones(10, 65, device=dev), ivl,
                         torch.arange(66, dtype=torch.int32, device=dev))
