"""The port's CUDA hop kernels against their plain PyTorch versions, on the
card.  Every test needs an NVIDIA Hopper card (capability 9.0) and nvcc, and
skips elsewhere; run them there with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels.py``.

Inputs are small non-negative integers in float32, so every sum is exact and
the comparison is ``torch.equal`` whatever order the kernel sums in."""
import numpy as np
import pytest
import torch

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
