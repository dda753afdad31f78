"""The port's int8 KV cache against the JAX package's, on the CPU.

``_quantize_kv`` bit for bit (int8 values equal, bfloat16 scales the same
bits) on seeded normals, on rows built to sit on .5 rounding boundaries, on
all-zero and tiny rows (the 1e-8 floor) and on bfloat16 input.  The cache's
tuple, dtypes, shapes and bytes.  Decode from an empty int8 cache for 8
tokens (the protocol of ``tests/test_kv_quant.py``) at llama3-405b and
gemma3-4b ``SMOKE`` (sliding windows, local:global), for ``impl='torch'``
and ``'cuda'`` (the plain version on CPU tensors), with the reference's
``init_params(PRNGKey(0))`` carried across by ``interop``: logits within
atol 2e-5 (float32; the packages sum matrix products in other orders), the
int8 caches equal.  One step from a cache the JAX package wrote, carried
across by ``interop.kv_cache_from_arrays``.  The int8 plain decode attention
against the reference's dequantization and ``attention_ref``.  The port's
int8 run against its own float run: post-softmax distance under 0.05 (the
reference's bound), the same greedy tokens on the reference test's own
tokens and, on numpy's, wherever the float run's top-2 gap decides them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_4b as JG
from repro.configs import llama3_405b as JL
from repro.kernels.flash_attention import attention_ref
from repro.models import transformer as jtr
from repro_torch import interop
from repro_torch.configs import gemma3_4b as TG
from repro_torch.configs import llama3_405b as TL
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import transformer as ttr

N_TOKENS, MAX_LEN = 8, 16
MODELS = {"llama3-405b": (JL, TL), "gemma3-4b": (JG, TG)}


def _bits(scale) -> np.ndarray:
    """The raw 16 bits of a bfloat16 array or tensor."""
    if isinstance(scale, torch.Tensor):
        return scale.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(scale).view(np.uint16)


# =========================================================================
# _quantize_kv
# =========================================================================
def _half_rows(rng) -> np.ndarray:
    """Rows whose max |x| is 127 c, the rest half-integers times c, so
    x / scale lands on (or an ulp beside) .5 and round's ties decide."""
    shape = (2, 4, 8, 32)
    halves = rng.integers(-127, 127, size=shape) + 0.5
    halves[..., 0] = np.where(rng.random(shape[:-1]) < 0.5, -127.0, 127.0)
    c = rng.choice([1.0, 0.1, 3.7, 1 / 3, 2.0 ** -20, 1e-3, 17.0], size=shape[:-1])
    return (halves * c[..., None]).astype(np.float32)


def _case(name: str) -> np.ndarray:
    rng = np.random.default_rng(2)
    if name in ("normal", "bf16"):
        return (rng.normal(size=(2, 4, 8, 32)) * 3.0).astype(np.float32)
    if name == "half":
        return _half_rows(rng)
    x = np.zeros((2, 4, 8, 32), np.float32)              # zero rows: scale 1e-8
    x[1] = rng.normal(size=(4, 8, 32)) * 1e-7            # max / 127 below the floor
    x[1, :, ::2] = rng.normal(size=(4, 4, 32)) * 1e-5    # and just above it
    return x


@pytest.mark.parametrize("name", ["normal", "half", "zeros", "bf16"])
def test_quantize_kv_bit_equal(name):
    x = _case(name)
    if name == "bf16":
        xj, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    qj, sj = jtr._quantize_kv(xj)
    qt, st = ttr._quantize_kv(xt)
    assert qt.dtype == torch.int8 and st.dtype == torch.bfloat16
    assert tuple(qt.shape) == qj.shape and tuple(st.shape) == sj.shape
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(_bits(st), _bits(sj))
    if name == "half":   # the rows do reach ties: round's rule is exercised
        r = np.abs(x / np.asarray(st.float())[..., None])
        assert (np.abs(r - np.floor(r) - 0.5) < 1e-6).sum() > 100


def test_init_cache_quantized():
    jc = dataclasses.replace(JL.SMOKE, kv_cache_quant=True)
    tc = dataclasses.replace(TL.SMOKE, kv_cache_quant=True)
    want = jtr.init_cache(jc, 4, 64)
    got = ttr.init_cache(tc, 4, 64, device="cpu")
    assert len(got) == 4
    assert [t.dtype for t in got] == [torch.int8, torch.int8, torch.bfloat16, torch.bfloat16]
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and not g.any()
    base = ttr.init_cache(TL.SMOKE, 4, 64, device="cpu")
    nbytes = lambda c: sum(t.numel() * t.element_size() for t in c)
    assert nbytes(got) < 0.65 * nbytes(base), (nbytes(got), nbytes(base))
    assert nbytes(got) == sum(np.asarray(w).nbytes for w in want)


# =========================================================================
# decode over the int8 cache
# =========================================================================
def _setup(model: str, impl: str = "cuda"):
    J, T = MODELS[model]
    jc = dataclasses.replace(J.SMOKE, kv_cache_quant=True)
    tc = dataclasses.replace(T.SMOKE, kv_cache_quant=True, impl=impl)
    jp = jtr.init_params(jc, jax.random.PRNGKey(0))
    tp = interop.transformer_params_from_arrays(tc, jax.tree_util.tree_map(np.asarray, jp),
                                                device="cpu")
    toks = np.random.default_rng(1).integers(0, jc.vocab, (2, 12)).astype(np.int32)
    step = jax.jit(lambda p, c, t, n: jtr.decode_step(jc, p, c, t, n))
    return jc, tc, jp, tp, toks, step


def _check_int8_rows(got: torch.Tensor, want, inputs: list, which: int) -> int:
    """int8 cache rows equal; where one differs it differs by 1, and the
    float32 value quantized there (``inputs``: the port's ``_quantize_kv``
    inputs, a [2, B, Hkv, Dh] stack of k and v a layer and step) lies within
    float32 rounding of a .5 boundary.  Returns the count that differ."""
    got, want = got.numpy().astype(np.int32), np.asarray(want).astype(np.int32)
    diff = np.argwhere(got != want)
    L = got.shape[0]
    for layer, b, h, pos, d in diff:
        assert abs(got[layer, b, h, pos, d] - want[layer, b, h, pos, d]) == 1
        x = inputs[pos * L + layer][which, b, h].double()
        r = float(x[d] / (x.abs().max() / 127.0))
        assert abs(abs(r) - np.floor(abs(r)) - 0.5) < 1e-4, (layer, b, h, pos, d, r)
    return len(diff)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("model", list(MODELS))
def test_decode_from_empty_cache_matches_reference(model, impl, monkeypatch):
    jc, tc, jp, tp, toks, step = _setup(model, impl)
    inputs = []
    quantize = ttr._quantize_kv
    monkeypatch.setattr(ttr, "_quantize_kv", lambda x: inputs.append(x.clone()) or quantize(x))
    jcache = jtr.init_cache(jc, 2, MAX_LEN)
    tcache = ttr.init_cache(tc, 2, MAX_LEN, device="cpu")
    for t in range(N_TOKENS):
        jl, jcache = step(jp, jcache, jnp.asarray(toks[:, t]), t + 1)
        tl, tcache = ttr.decode_step(tc, tp, tcache, torch.from_numpy(toks[:, t]), t + 1)
        assert tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5, rtol=0)
    assert len(inputs) == N_TOKENS * tc.n_layers
    for which in (0, 1):
        _check_int8_rows(tcache[which], jcache[which], inputs, which)
        np.testing.assert_array_equal(_bits(tcache[2 + which]), _bits(jcache[2 + which]))
    assert not tcache[0][:, :, :, N_TOKENS:].any()


@pytest.mark.parametrize("model", list(MODELS))
def test_one_step_from_the_reference_cache(model):
    """A cache the JAX package wrote (5 steps), carried into the port by
    ``kv_cache_from_arrays``; one more step in both packages."""
    jc, tc, jp, tp, toks, step = _setup(model)
    jcache = jtr.init_cache(jc, 2, MAX_LEN)
    for t in range(5):
        _, jcache = step(jp, jcache, jnp.asarray(toks[:, t]), t + 1)
    tcache = interop.kv_cache_from_arrays(tc, [np.asarray(a) for a in jcache], device="cpu")
    assert [t.dtype for t in tcache] == [torch.int8, torch.int8, torch.bfloat16, torch.bfloat16]
    for g, w in zip(tcache, jcache):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w).astype(np.float32))
    jl, jcache = step(jp, jcache, jnp.asarray(toks[:, 5]), 6)
    tl, tcache = ttr.decode_step(tc, tp, tcache, torch.from_numpy(toks[:, 5]), 6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5, rtol=0)
    for g, w in zip(tcache, jcache):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w).astype(np.float32))


def test_kv_cache_from_arrays_float_and_refusals():
    tc = TG.SMOKE
    k = np.random.default_rng(0).normal(size=(6, 2, 2, 8, 16)).astype(np.float32)
    ck, cv = interop.kv_cache_from_arrays(tc, (k, -k), device="cpu")
    assert ck.dtype == tc.dtype and np.array_equal(cv.numpy(), -k)
    with pytest.raises(ValueError, match="4-tuple"):
        interop.kv_cache_from_arrays(dataclasses.replace(tc, kv_cache_quant=True), (k, k),
                                     device="cpu")


@pytest.mark.parametrize("tokens", ["reference", "numpy"])
@pytest.mark.parametrize("model", list(MODELS))
def test_int8_against_the_float_cache(model, tokens):
    """The port's int8 run against its own float run on the same tokens:
    post-softmax distance < 0.05 at every step.  On the reference test's
    own tokens (``jax.random.randint(PRNGKey(1), ...)``, the same weights)
    every greedy token agrees, as that test asserts; on numpy's (seed 1)
    they agree wherever the float run's top-1/top-2 gap exceeds twice the
    step's largest |logit difference| (llama3-405b SMOKE's second step has
    a token of a gap of 1.6e-4 there, against a logit difference of
    0.025, that goes the other way)."""
    jc, tc, _, tp, toks, _ = _setup(model)
    if tokens == "reference":
        toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0, jc.vocab))
    base = dataclasses.replace(tc, kv_cache_quant=False)
    cq = ttr.init_cache(tc, 2, MAX_LEN, device="cpu")
    cb = ttr.init_cache(base, 2, MAX_LEN, device="cpu")
    errs = []
    for t in range(N_TOKENS):
        tok = torch.from_numpy(np.array(toks[:, t]))
        lq, cq = ttr.decode_step(tc, tp, cq, tok, t + 1)
        lb, cb = ttr.decode_step(base, tp, cb, tok, t + 1)
        errs.append(float((torch.softmax(lq, -1) - torch.softmax(lb, -1)).abs().max()))
        top2 = lb.topk(2, dim=-1).values
        decided = top2[:, 0] - top2[:, 1] > 2 * (lq - lb).abs().max()
        if tokens == "reference":
            decided[:] = True
        assert torch.equal(lq.argmax(-1)[decided], lb.argmax(-1)[decided]), t
    assert 0 < max(errs) < 0.05, errs


def test_prefill_keeps_the_float_cache():
    """As the reference's, prefill returns (k, v) in cfg.dtype whatever
    kv_cache_quant says; decode_step refuses a cache of the other kind."""
    tc = dataclasses.replace(TG.SMOKE, kv_cache_quant=True)
    tp = ttr.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, tc.vocab, (2, 10)))
    lq, cq = ttr.prefill(tc, tp, toks, MAX_LEN)
    lb, cb = ttr.prefill(TG.SMOKE, tp, toks, MAX_LEN)
    assert len(cq) == 2 and cq[0].dtype == tc.dtype
    assert torch.equal(lq, lb) and all(torch.equal(a, b) for a, b in zip(cq, cb))
    with pytest.raises(ValueError, match="4-tuple"):
        ttr.decode_step(tc, tp, cq, toks[:, 0], 11)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_cache_matches_reference_rows(dtype):
    """``quantize_cache`` of a prefill's float cache: each prompt row equals
    the JAX package's ``_quantize_kv`` of that row (int8 equal, bfloat16
    scales bit-equal), the rows after the prompt stay 0, and a decode step
    from it runs as from a cache the int8 decode wrote."""
    tc = dataclasses.replace(TG.SMOKE, dtype=dtype, kv_cache_quant=True)
    tp = ttr.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, tc.vocab, (2, 10)))
    _, fcache = ttr.prefill(tc, tp, toks, MAX_LEN)
    got = ttr.quantize_cache(fcache, 10)
    assert [t.dtype for t in got] == [torch.int8, torch.int8, torch.bfloat16, torch.bfloat16]
    for src, q8, s8 in ((fcache[0], got[0], got[2]), (fcache[1], got[1], got[3])):
        x = jnp.asarray(src.float().numpy(), jnp.bfloat16 if dtype == torch.bfloat16
                        else jnp.float32)
        for t in range(10):
            qj, sj = jtr._quantize_kv(x[:, :, :, t])
            np.testing.assert_array_equal(q8[:, :, :, t].numpy(), np.asarray(qj))
            np.testing.assert_array_equal(_bits(s8[:, :, :, t]), _bits(sj))
        assert not q8[:, :, :, 10:].any() and not s8[:, :, :, 10:].any()
    lg, _ = ttr.decode_step(tc, tp, got, toks[:, 0], 11)
    assert torch.isfinite(lg).all()
    with pytest.raises(ValueError, match="rows"):
        ttr.quantize_cache(fcache, MAX_LEN + 1)


# =========================================================================
# the int8 decode attention's plain version
# =========================================================================
def _int8_cache(rng, shape):
    """Random int8 rows and bfloat16 scales, as numpy (float32 scales)."""
    x8 = rng.integers(-127, 128, size=shape).astype(np.int8)
    s = np.asarray(jnp.asarray(rng.random(shape[:-1]) * 0.05 + 1e-3, jnp.bfloat16),
                   np.float32)
    return x8, s


@pytest.mark.parametrize("Hq,Hkv", [(4, 2), (8, 1)])
@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("cache_len", [1, 9, 16])
def test_int8_decode_attention_matches_reference(Hq, Hkv, window, cache_len):
    """``decode_attention`` over an int8 cache (both impls: the plain
    version on CPU tensors) against the reference's float32 dequantization
    followed by ``attention_ref``."""
    rng = np.random.default_rng(cache_len * 10 + Hq)
    D = 64
    qa = rng.normal(size=(2, Hq, 1, D)).astype(np.float32)
    (k8, sk), (v8, sv) = _int8_cache(rng, (2, Hkv, 16, D)), _int8_cache(rng, (2, Hkv, 16, D))
    deq = lambda x8, s: (jnp.asarray(x8).astype(jnp.float32)
                         * jnp.asarray(s, jnp.bfloat16).astype(jnp.float32)[..., None])
    want = np.asarray(attention_ref(jnp.asarray(qa), deq(k8, sk)[:, :, :cache_len],
                                    deq(v8, sv)[:, :, :cache_len], causal=True,
                                    window=window, q_offset=cache_len - 1))
    scales = tuple(torch.from_numpy(s).to(torch.bfloat16) for s in (sk, sv))
    for impl in ("torch", "cuda"):
        got = FA.decode_attention(torch.from_numpy(qa), torch.from_numpy(k8),
                                  torch.from_numpy(v8), cache_len, window=window,
                                  scales=scales, impl=impl)
        assert got.dtype == torch.float32 and tuple(got.shape) == qa.shape
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    deq_t = FA.dequantize_kv(torch.from_numpy(k8), scales[0])
    np.testing.assert_array_equal(deq_t.numpy(), np.asarray(deq(k8, sk)))


def test_int8_cache_without_scales_is_refused():
    q = torch.zeros(1, 2, 1, 64)
    k8 = torch.zeros(1, 1, 8, 64, dtype=torch.int8)
    with pytest.raises(TypeError, match="scales"):
        FA.decode_attention(q, k8, k8, 4, impl="torch")
