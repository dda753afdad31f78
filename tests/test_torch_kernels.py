"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test needs an NVIDIA Hopper card (capability 9.0) and nvcc, and
skips elsewhere; run them there with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py``.

Hop kernels: inputs are small non-negative integers in float32, so every sum
is exact and the comparison is ``torch.equal`` whatever order the kernel sums
in.  Attention: atol = rtol = 2e-5 in float32 (the tolerance of
``tests/test_kernels.py``'s sweep); in bf16 atol 1e-3 and rtol 2^-7, one
bf16 rounding of the output, tighter than that sweep's 2e-2, since kernel and
plain version both sum in float32.  EmbeddingBag: atol 1e-5."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import embedding_bag as EB
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import hop_scatter as HK

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


@pytest.mark.parametrize("op_is_min", [True, False])
def test_scatter_extremum(dev, op_is_min):
    rng = np.random.default_rng(7)
    ptr = _csr(rng, 900)
    E = int(ptr[-1])
    t = lambda a: torch.from_numpy(a).to(dev)
    m = t(rng.integers(1, 500, size=(3, E)).astype(np.float32))
    alive = t((rng.random((3, E)) < 0.5).astype(np.float32))
    neutral = float("inf") if op_is_min else float("-inf")
    out = HK.scatter_extremum(m, alive, t(ptr), neutral, op_is_min)
    torch.cuda.synchronize()
    assert torch.equal(out, HK.scatter_extremum_plain(m, alive, t(ptr), neutral, op_is_min))


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
@pytest.mark.parametrize("V,D,Bb,L", [(1000, 32, 64, 8), (257, 16, 33, 3), (4096, 64, 16, 1),
                                      (1_000_000, 64, 5000, 1), (50, 100, 40, 5)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag(dev, V, D, Bb, L, mode):
    rng = np.random.default_rng(V + Bb)
    table = torch.from_numpy(rng.normal(size=(V, D)).astype(np.float32)).to(dev)
    idx = rng.integers(-1, V, size=(Bb, L)).astype(np.int32)
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
    table = torch.arange(12, dtype=torch.float32, device=dev).view(3, 4)
    idx = torch.tensor([[0, 3, -1], [2, 2, 1 << 30]], dtype=torch.int32, device=dev)
    out = EB.embedding_bag(table, idx, "mean")
    torch.cuda.synchronize()
    assert torch.equal(out, torch.stack([table[0], table[2]]))


def test_embedding_bag_refuses_bad_operands(dev):
    table = torch.ones(10, 64, device=dev)
    idx = torch.zeros(4, 2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        EB.embedding_bag(table, idx.long())
    with pytest.raises(ValueError):
        EB.embedding_bag(table.double(), idx)
    with pytest.raises(ValueError):
        EB.embedding_bag(table, idx.cpu())
