"""The launch choices and plain versions behind B7's attention routes and
B5's narrow path, on the CPU (no card needed).

  * ``attention_route`` and ``decode_splits``: which kernel a call goes to,
    and how the decode kernel cuts the visible cache rows into splits (every
    row once, in order, none empty, enough blocks for the card), both from
    the shape alone with no device sync.
  * ``decode_attention_split_plain``, the decode kernel's arithmetic written
    out (a softmax per split, then the merge), held to the JAX package's
    ``attention_ref`` and its Pallas kernel in interpret mode at float32
    atol 2e-5 (the tolerance of the reference's own attention sweep), with
    cache lengths on and either side of the split edges.
  * B5's lane choice (``common.lane_group``, which B1 and B3 share) and
    ``bucket_scatter_lanes_plain``, its narrow path (G lanes a segment, then
    a butterfly), held to ``bucket_scatter_ref`` and
    the Pallas kernel in interpret mode on CSRs of about one edge a segment
    with empty runs and a hub (1e-4 float32, 5e-2 bfloat16: the sweep of
    ``tests/test_torch_gnn.py``; in bfloat16 the JAX functions sum the same
    values in float32, as the port does).
  * The ctypes signatures of ``kernels/build.py`` against the C entry points
    of ``csrc/*.cu``: an argument of the wrong width would pass the CPU tests
    and corrupt the launch on the card.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bucket_scatter import bucket_scatter as bucket_scatter_jax
from repro.kernels.bucket_scatter import bucket_scatter_ref
from repro.kernels.bucket_scatter.ops import build_layout as build_layout_jax
from repro.kernels.flash_attention import attention_ref
from repro.kernels.flash_attention import flash_attention as flash_attention_jax
from repro_torch.kernels import bucket_scatter as BS
from repro_torch.kernels import build
from repro_torch.kernels.common import lane_group
from repro_torch.kernels import flash_attention as FA

H100_SMS = 132
GEMMA_DECODE = dict(batch=8, kv_heads=4, q_heads=8, d_head=256)   # chip_smoke's LM serve


# =========================================================================
# (a) routes and splits
# =========================================================================
@pytest.mark.parametrize("dtype,D,Sq,group,want", [
    (torch.bfloat16, 256, 2048, 2, "tc"),      # gemma3-4b prefill
    (torch.bfloat16, 256, 1, 2, "decode"),     # gemma3-4b decode
    (torch.float32, 256, 1, 2, "decode"),      # its float32 check
    (torch.float32, 256, 2048, 2, "simt"),     # float32 prefill keeps the old kernel
    (torch.bfloat16, 128, 200, 1, "tc"),
    (torch.bfloat16, 64, 17, 1, "tc"),
    (torch.bfloat16, 64, 16, 1, "decode"),     # 16 rows a kv head still fit a block
    (torch.bfloat16, 64, 8, 2, "decode"),
    (torch.bfloat16, 64, 9, 2, "tc"),
    (torch.bfloat16, 32, 192, 1, "simt"),      # no tensor-core width
    (torch.float32, 16, 20, 2, "simt"),        # gemma3-4b SMOKE prefill
    (torch.float32, 16, 1, 2, "decode"),       # and its decode
    (torch.bfloat16, 64, 1, 16, "decode"),
    (torch.bfloat16, 64, 1, 17, "tc"),
])
def test_attention_route(dtype, D, Sq, group, want):
    assert FA.attention_route(dtype, D, Sq, group) == want


def _ranges(lo, hi, splits, chunk):
    return [(lo + s * chunk, min(lo + (s + 1) * chunk, hi)) for s in range(splits)]


@pytest.mark.parametrize("cache_len", [1, 64, 65, 1025, 2079])
@pytest.mark.parametrize("window", [None, 1024])
def test_decode_splits_cover_gemma_decode(cache_len, window, monkeypatch):
    """At gemma3-4b's decode shapes: every visible row in exactly one split,
    in order, no split empty, runs of at least 64 rows where there is more
    than one, and as many blocks as the card's SMs wherever the rows allow
    that many 64-row runs; computed with no device sync."""
    def no_sync(*a, **k):
        raise AssertionError("a launch choice synchronised with the device")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    monkeypatch.setattr(torch.Tensor, "item", no_sync)
    g = GEMMA_DECODE
    lo, hi = FA.visible_rows(1, cache_len, True, window, cache_len - 1)
    assert (lo, hi) == (0 if window is None else max(0, cache_len - window), cache_len)
    splits, chunk = FA.decode_splits(g["batch"], g["kv_heads"], hi - lo, H100_SMS)
    assert isinstance(splits, int) and isinstance(chunk, int)
    covered = [r for a, b in _ranges(lo, hi, splits, chunk) for r in range(a, b)]
    assert covered == list(range(lo, hi))
    assert all(b > a for a, b in _ranges(lo, hi, splits, chunk))
    if splits > 1:
        assert chunk >= FA.MIN_SPLIT_ROWS
    pairs = g["batch"] * g["kv_heads"]
    assert pairs * splits >= min(H100_SMS, pairs * max(1, (hi - lo) // FA.MIN_SPLIT_ROWS))
    assert FA.attention_route(torch.bfloat16, g["d_head"], 1, g["q_heads"] // g["kv_heads"]) \
        == "decode"


def test_global_decode_fills_the_card():
    """The global layer's decode at 2,079 rows launches at least 132 blocks."""
    g = GEMMA_DECODE
    splits, chunk = FA.decode_splits(g["batch"], g["kv_heads"], 2079, H100_SMS)
    assert g["batch"] * g["kv_heads"] * splits >= H100_SMS
    assert splits * chunk >= 2079 > (splits - 1) * chunk


@pytest.mark.parametrize("rows", [0, 1, 63, 64, 127, 128, 1000, 5000, 100_000])
@pytest.mark.parametrize("pairs,sms", [(1, 132), (32, 132), (64, 8), (1000, 132)])
def test_decode_splits_any_shape(rows, pairs, sms):
    splits, chunk = FA.decode_splits(pairs, 1, rows, sms)
    assert splits >= 1
    covered = [r for a, b in _ranges(0, rows, splits, chunk) for r in range(a, b)]
    assert covered == list(range(rows))
    assert all(b > a for a, b in _ranges(0, rows, splits, chunk)) or rows == 0
    assert splits == 1 or chunk >= FA.MIN_SPLIT_ROWS


@pytest.mark.parametrize("Sq,Sk,causal,window,q_offset,want", [
    (1, 2079, True, None, 2078, (0, 2079)),
    (1, 2080, True, 1024, 2078, (1055, 2079)),   # a cache past cache_len is never read
    (4, 100, True, 8, 50, (43, 54)),
    (40, 100, True, None, -20, (0, 20)),
    (3, 8, True, None, -5, (0, 0)),               # no row sees a key
    (5, 30, False, None, 0, (0, 30)),
    (5, 30, False, 4, 10, (7, 30)),
])
def test_visible_rows(Sq, Sk, causal, window, q_offset, want):
    assert FA.visible_rows(Sq, Sk, causal, window, q_offset) == want


# =========================================================================
# (b) the split-K decode's arithmetic against the JAX package
# =========================================================================
@pytest.mark.parametrize("cache_len", [1, 63, 64, 65, 128, 129, 200, 255, 256])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (4, 1)], ids=["gqa2", "mqa"])
@pytest.mark.parametrize("sms", [8, 132])
def test_split_decode_matches_reference(cache_len, window, Hq, Hkv, sms):
    """The splits land on rows 64, 128, 192 (8 SMs, two kv heads: four runs
    of 64 of a full cache), so these cache lengths put the last visible row
    on, before and after a split edge; with 132 SMs the runs are as long as
    the rows allow."""
    B, D, Smax = 2, 64, 256
    rng = np.random.default_rng(cache_len * 7 + Hkv)
    qa = rng.normal(size=(B, Hq, 1, D)).astype(np.float32)
    ka = rng.normal(size=(B, Hkv, Smax, D)).astype(np.float32)
    va = rng.normal(size=(B, Hkv, Smax, D)).astype(np.float32)
    qo = cache_len - 1
    lo, hi = FA.visible_rows(1, cache_len, True, window, qo)
    splits, chunk = FA.decode_splits(B, Hkv, hi - lo, sms)
    got = FA.decode_attention_split_plain(
        torch.from_numpy(qa), torch.from_numpy(ka), torch.from_numpy(va), splits=splits,
        chunk=chunk, causal=True, window=window, q_offset=qo).numpy()
    qj, kj, vj = (jnp.asarray(a) for a in (qa, ka, va))
    want = np.asarray(attention_ref(qj, kj, vj, causal=True, window=window, q_offset=qo))
    kern = np.asarray(flash_attention_jax(qj, kj, vj, causal=True, window=window, q_offset=qo,
                                          impl="pallas_interpret", block_q=8, block_k=64))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, kern, atol=2e-5, rtol=0)


@pytest.mark.parametrize("Sq,q_offset,window", [(2, 99, None), (4, 60, 16), (8, 10, None),
                                                (2, -1, None)])
def test_split_decode_several_rows(Sq, q_offset, window):
    """Up to 16 query rows a kv head (Sq x group), each with its own causal
    and window bounds inside the splits; a row that sees no key gives 0."""
    B, Hq, Hkv, D, Sk = 1, 4, 2, 64, 160
    rng = np.random.default_rng(Sq + q_offset)
    qa, ka, va = (rng.normal(size=(B, h, s, D)).astype(np.float32)
                  for h, s in ((Hq, Sq), (Hkv, Sk), (Hkv, Sk)))
    lo, hi = FA.visible_rows(Sq, Sk, True, window, q_offset)
    splits, chunk = FA.decode_splits(B, Hkv, hi - lo, 16)
    got = FA.decode_attention_split_plain(
        torch.from_numpy(qa), torch.from_numpy(ka), torch.from_numpy(va), splits=splits,
        chunk=chunk, window=window, q_offset=q_offset).numpy()
    want = np.asarray(attention_ref(jnp.asarray(qa), jnp.asarray(ka), jnp.asarray(va),
                                    causal=True, window=window, q_offset=q_offset))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    if q_offset < 0:
        assert not got[:, :, :-q_offset].any()


# =========================================================================
# (c) B5's narrow path: lanes a segment and their order of summation
# =========================================================================
@pytest.mark.parametrize("E,V,G", [(168_960, 169_984, 1),     # a GNN request's union graph
                                   (0, 1000, 1), (3999, 1000, 1), (4000, 1000, 2),
                                   (8000, 1000, 4), (128_000, 1000, 32),
                                   (10 ** 6, 1000, 32)])
def test_scatter_layout_takes_the_shared_lane_group(E, V, G):
    """B5's layout takes B1/B3's lane rule at one lane an edge."""
    seg = torch.from_numpy(np.sort(np.random.default_rng(E).integers(0, V, size=E)))
    lay = BS.build_layout(seg, V)
    assert lay.lanes == lane_group(E, V, 1) == G


def _near_one_segments(rng, V, hub):
    """Sorted segment ids of about one edge a segment: degrees 0, 1 and 2,
    empty runs at both ends and in the middle, and one hub of ``hub``."""
    deg = rng.choice([0, 1, 1, 1, 2], size=V)
    deg[:5] = 0
    deg[V // 2: V // 2 + 7] = 0
    deg[-5:] = 0
    deg[V // 3] = hub
    return np.repeat(np.arange(V, dtype=np.int32), deg)


@pytest.mark.parametrize("C", [1, 3, 8])
@pytest.mark.parametrize("lanes", [None, 2, 8, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lane_sums_match_reference(C, lanes, dtype):
    rng = np.random.default_rng(C * 10 + (lanes or 0))
    V = 700
    seg = _near_one_segments(rng, V, hub=300)
    E = seg.size
    vals = rng.normal(size=(E, C)).astype(np.float32)
    ts = torch.from_numpy(seg)
    lay = BS.build_layout(ts, V)
    G = lay.lanes if lanes is None else lanes
    if lanes is None:
        assert G == 1
    tc = torch.from_numpy(vals).to(getattr(torch, dtype))
    got = BS.bucket_scatter_lanes_plain(tc, lay.ptr, G)
    assert got.dtype == tc.dtype and tuple(got.shape) == (V, C)
    # the JAX functions get the inputs' values in float32: in bfloat16 they
    # would sum the 300-edge hub in bfloat16 (0.4 off), where the port sums
    # in float32 and rounds once
    jc = jnp.asarray(tc.float().numpy())
    want = np.asarray(bucket_scatter_ref(jc, jnp.asarray(seg), V))
    kern = np.asarray(bucket_scatter_jax(
        jc, jnp.asarray(seg), V, layout=build_layout_jax(seg, V, block_v=128, block_e_mult=128),
        impl="pallas", interpret=True))
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    np.testing.assert_allclose(got.float().numpy(), kern, atol=tol, rtol=tol)
    empty = np.bincount(seg, minlength=V) == 0
    assert not got[torch.from_numpy(empty)].float().any()
    if G == 1:   # a thread a segment adds its edges in order, as index_add_ does
        assert torch.equal(got, BS.bucket_scatter_plain(tc, ts, V))


# =========================================================================
# (d) the ctypes signatures against the C entry points
# =========================================================================
_C_KINDS = {"int": "int", "long long": "long long", "float": "float"}


def _c_signatures(source: str) -> dict:
    """name -> argument kinds of every extern "C" function of a source."""
    text = (build.CSRC / f"{source}.cu").read_text()
    block = text[text.index('extern "C" {'):]
    out = {}
    for name, args in re.findall(r"\bint\s+(\w+)\s*\(([^)]*)\)\s*\{", block):
        kinds = []
        for a in args.split(","):
            a = " ".join(a.split()[:-1]).replace("const ", "")
            kinds.append("pointer" if "*" in a else _C_KINDS[a])
        out[name] = kinds
    return out


@pytest.mark.parametrize("source", sorted(build.SIGNATURES))
def test_ctypes_signatures_match_the_sources(source):
    kind = {build._P: "pointer", build._I: "int", build._L: "long long", build._F: "float"}
    c = _c_signatures(source)
    assert set(c) == set(build.SIGNATURES[source])
    for fn, argtypes in build.SIGNATURES[source].items():
        assert [kind[t] for t in argtypes] == c[fn], fn
