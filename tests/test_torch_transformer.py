"""The port's LM serve path against the JAX package, on the CPU.

Attention: the port's plain version and its kernel wrapper (which runs the
plain version on CPU tensors) against the reference's ``attention_ref`` and
its Pallas kernel in interpret mode, at the sweep shapes of
``tests/test_kernels.py``.  Model: gemma3-4b ``SMOKE`` with the reference's
``init_params(PRNGKey(0))`` carried across by ``interop``; ``forward``
against both reference forwards (scanned, and unscanned through the Pallas
kernel), ``prefill`` and 12 ``decode_step``s against the reference's.
Inputs are made with numpy from a seed and handed to both packages.

Tolerances: float32 atol 2e-5 (the packages sum matrix products in other
orders); for attention in bf16, 2e-2, the kernel sweep's bf16 tolerance; for
the bf16 model, twice the reference's own bf16 error (``_close``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gemma3_4b as JG
from repro.kernels.flash_attention import attention_ref
from repro.kernels.flash_attention import flash_attention as flash_attention_jax
from repro.models import transformer as jtr
from repro_torch import interop
from repro_torch.configs import gemma3_4b as TG
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import transformer as ttr

PROMPT, MAX_LEN, N_DECODE = 20, 40, 12


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _t(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dtype)


def _pair(a: np.ndarray, bf16: bool):
    """The same values as a JAX array and a torch tensor (bf16 rounds the
    same way in both: to nearest, ties to even)."""
    if bf16:
        return jnp.asarray(a, jnp.bfloat16), _t(a, torch.bfloat16)
    return jnp.asarray(a, jnp.float32), _t(a)


# =========================================================================
# attention
# =========================================================================
@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (1, 4, 2, 128, 64),
    (2, 8, 8, 256, 64),
    (1, 8, 1, 128, 128),   # MQA
    (2, 2, 2, 192, 32),    # non-pow2 seq (pad path of the reference wrapper)
])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64), (False, None)])
def test_attention_matches_reference(B, Hq, Hkv, S, D, bf16, causal, window):
    rng = np.random.default_rng(B * 1000 + Hq * 100 + S + D)
    qa, ka, va = (rng.normal(size=(B, h, S, D)) for h in (Hq, Hkv, Hkv))
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, bf16) for a in (qa, ka, va))
    want = _np(attention_ref(qj, kj, vj, causal=causal, window=window))
    tol = 2e-2 if bf16 else 2e-5
    plain = FA.attention_plain(qt, kt, vt, causal=causal, window=window)
    wrapped = FA.flash_attention(qt, kt, vt, causal=causal, window=window, impl="cuda")
    assert plain.dtype == qt.dtype and plain.shape == qt.shape
    np.testing.assert_allclose(plain.float().numpy(), want, atol=tol, rtol=tol)
    np.testing.assert_array_equal(wrapped.float().numpy(), plain.float().numpy())
    if causal or S % 64 == 0:   # the Pallas wrapper takes non-causal only unpadded
        kern = _np(flash_attention_jax(qj, kj, vj, causal=causal, window=window,
                                       impl="pallas_interpret", block_q=64, block_k=64))
        np.testing.assert_allclose(plain.float().numpy(), kern, atol=tol, rtol=tol)


@pytest.mark.parametrize("cache_len", [1, 64, 199, 256])
@pytest.mark.parametrize("window", [None, 64])
def test_decode_attention_matches_reference(cache_len, window):
    rng = np.random.default_rng(cache_len)
    qa = rng.normal(size=(2, 4, 1, 64))
    ka, va = rng.normal(size=(2, 2, 256, 64)), rng.normal(size=(2, 2, 256, 64))
    qj, kj, vj = (jnp.asarray(a, jnp.float32) for a in (qa, ka, va))
    got = FA.decode_attention(_t(qa), _t(ka), _t(va), cache_len, window=window).numpy()
    want = _np(attention_ref(qj, kj, vj, causal=True, window=window, q_offset=cache_len - 1))
    kern = _np(flash_attention_jax(qj, kj, vj, causal=True, window=window,
                                   q_offset=cache_len - 1, impl="pallas_interpret",
                                   block_q=8, block_k=64))
    np.testing.assert_allclose(got, want, atol=2e-5)
    np.testing.assert_allclose(got, kern, atol=2e-5)


def test_attention_sees_no_key_gives_zero():
    # query rows before every key (a negative offset): rows whose softmax
    # sum l stays 0 are written as 0
    q, k = torch.ones(1, 2, 3, 32), torch.ones(1, 1, 8, 32)
    out = FA.attention_plain(q, k, k, causal=True, q_offset=-5)
    assert torch.equal(out, torch.zeros_like(out))


def test_decode_attention_rejects_cache_len_outside_the_cache():
    q, k = torch.ones(1, 2, 1, 32), torch.ones(1, 1, 8, 32)
    for bad in (0, 9):
        with pytest.raises(ValueError):
            FA.decode_attention(q, k, k, bad)


def test_flash_attention_rejects_unknown_impl():
    q = torch.ones(1, 1, 4, 32)
    with pytest.raises(ValueError):
        FA.flash_attention(q, q, q, impl="pallas")


# =========================================================================
# the model
# =========================================================================
@pytest.fixture(scope="module", params=[False, True], ids=["f32", "bf16"])
def model(request):
    """The reference's SMOKE parameters in both packages.  For bf16 also the
    reference at float32 on the same (bf16-valued) weights: the yardstick of
    the reference's own bf16 rounding error."""
    bf16 = request.param
    jc, tc = JG.SMOKE, TG.SMOKE
    if bf16:
        jc = dataclasses.replace(jc, dtype=jnp.bfloat16)
        tc = dataclasses.replace(tc, dtype=torch.bfloat16)
    jp = jtr.init_params(jc, jax.random.PRNGKey(0))
    tp = interop.transformer_params_from_arrays(tc, jax.tree_util.tree_map(np.asarray, jp),
                                                device="cpu")
    refs = [(jc, jp)]
    if bf16:
        refs.append((JG.SMOKE, jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)))
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, jc.vocab, size=(2, PROMPT)).astype(np.int32)
    forced = rng.integers(0, jc.vocab, size=(N_DECODE, 2)).astype(np.int32)
    return dict(bf16=bf16, jc=jc, tc=tc, jp=jp, tp=tp, refs=refs, tokens=tokens,
                forced=forced)


def _close(got, want, want_f32=None):
    """float32: atol 2e-5.  bf16 (``want_f32`` given): the port may differ
    from the reference by at most twice the reference's own bf16 error, its
    largest distance from float32 arithmetic on the same weights (the
    triangle bound if the port rounds no worse than the reference does).
    At SMOKE that error is 1.3-1.8 % of the largest |logit|, so a fixed 2e-2
    of it would sit on the noise floor."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if want_f32 is None:
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
        return
    own = float(np.abs(want - np.asarray(want_f32, np.float32)).max())
    err = float(np.abs(got - want).max())
    assert 0 < own < 5e-2 * float(np.abs(want).max())   # the yardstick is bf16 noise
    assert err <= 2 * own, (err, own)


def _check(got, wants):
    _close(got, *wants)


def test_configs_match_reference():
    for jc, tc in ((JG.CONFIG, TG.CONFIG), (JG.SMOKE, TG.SMOKE)):
        assert tc.param_count() == jc.param_count()
        np.testing.assert_array_equal(tc.layer_windows(), jc.layer_windows())
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff",
                  "vocab", "rope_theta", "norm_eps", "sliding_window", "global_every",
                  "tie_embeddings"):
            assert getattr(tc, f) == getattr(jc, f), f
    assert TG.CONFIG.param_count() == 3_879_907_840
    assert ttr.FULL_WINDOW == jtr.FULL_WINDOW


def test_forward_matches_scanned_reference(model):
    toks = jnp.asarray(model["tokens"])
    wants = [jtr.forward(jc, jp, toks) for jc, jp in model["refs"]]
    got = ttr.forward(model["tc"], model["tp"], torch.from_numpy(model["tokens"]))
    assert got.dtype == model["tc"].dtype
    _check(got.float(), wants)


def test_forward_matches_unscanned_pallas_reference(model):
    toks = jnp.asarray(model["tokens"])
    wants = [jtr.forward(dataclasses.replace(jc, scan_layers=False,
                                             attention_impl="pallas_interpret"), jp, toks)
             for jc, jp in model["refs"]]
    got = ttr.forward(model["tc"], model["tp"], torch.from_numpy(model["tokens"]))
    _check(got.float(), wants)


def test_forward_impls_agree(model):
    tc = model["tc"]
    toks = torch.from_numpy(model["tokens"])
    a = ttr.forward(tc, model["tp"], toks)
    b = ttr.forward(dataclasses.replace(tc, impl="torch"), model["tp"], toks)
    assert torch.equal(a, b)    # on CPU tensors the wrapper runs the plain version


def test_prefill_matches_reference(model):
    toks = jnp.asarray(model["tokens"])
    outs = [jtr.prefill(jc, jp, toks, MAX_LEN) for jc, jp in model["refs"]]
    tl, (tk, tv) = ttr.prefill(model["tc"], model["tp"], torch.from_numpy(model["tokens"]),
                               MAX_LEN)
    assert tl.dtype == torch.float32 and tuple(tk.shape) == outs[0][1][0].shape
    _check(tl, [o[0] for o in outs])
    _check(tk.float(), [o[1][0] for o in outs])
    _check(tv.float(), [o[1][1] for o in outs])
    assert not tk[:, :, :, PROMPT:].any()


def test_prefill_last_logits_equal_forward(model):
    toks = torch.from_numpy(model["tokens"])
    full = ttr.forward(model["tc"], model["tp"], toks)
    last, _ = ttr.prefill(model["tc"], model["tp"], toks, MAX_LEN)
    # the same values up to the head product's summation order: in bf16 one
    # rounding step (a relative spacing of at most 2^-7)
    tol = dict(atol=0.0, rtol=2 ** -7) if model["bf16"] else dict(atol=2e-5, rtol=0.0)
    torch.testing.assert_close(last, full[:, -1].float(), **tol)


def test_decode_steps_match_reference(model):
    toks = jnp.asarray(model["tokens"])
    caches = [jtr.prefill(jc, jp, toks, MAX_LEN)[1] for jc, jp in model["refs"]]
    steps = [jax.jit(lambda p, c, t, n, jc=jc: jtr.decode_step(jc, p, c, t, n))
             for jc, _ in model["refs"]]
    _, tcache = ttr.prefill(model["tc"], model["tp"], torch.from_numpy(model["tokens"]),
                            MAX_LEN)
    for i, tok in enumerate(model["forced"]):      # teacher forcing: all get these tokens
        n = PROMPT + i + 1
        wants = []
        for r, ((_, jp), step) in enumerate(zip(model["refs"], steps)):
            logits, caches[r] = step(jp, caches[r], jnp.asarray(tok), n)
            wants.append(logits)
        tl, tcache = ttr.decode_step(model["tc"], model["tp"], tcache, torch.from_numpy(tok), n)
        assert tl.dtype == torch.float32
        _check(tl, wants)
    _check(tcache[0].float(), [c[0] for c in caches])
    _check(tcache[1].float(), [c[1] for c in caches])


def test_decode_step_equals_forward_on_the_extended_prompt():
    """Serving consistency inside the port: the logits of decode step n equal
    forward's logits at position n - 1 of the prompt plus the forced tokens."""
    tc = TG.SMOKE
    tp = ttr.init_params(tc, torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, tc.vocab, size=(2, PROMPT + 4)))
    _, cache = ttr.prefill(tc, tp, toks[:, :PROMPT], MAX_LEN)
    full = ttr.forward(tc, tp, toks)
    for n in range(PROMPT + 1, PROMPT + 5):
        logits, cache = ttr.decode_step(tc, tp, cache, toks[:, n - 1], n)
        torch.testing.assert_close(logits, full[:, n - 1], atol=2e-5, rtol=0)


def test_init_params_shapes_and_scale():
    tc = TG.SMOKE
    p = ttr.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.eval_shape(lambda k: jtr.init_params(JG.SMOKE, k), jax.random.PRNGKey(0))
    assert tuple(p["embed"].shape) == jshapes["embed"].shape
    for k, v in jshapes["layers"].items():
        assert tuple(p["layers"][k].shape) == v.shape, k
    D = tc.d_model
    assert abs(float(p["layers"]["wq"].std()) - D ** -0.5) < 0.1 * D ** -0.5
    assert torch.equal(p["layers"]["ln1"], torch.ones_like(p["layers"]["ln1"]))


def test_unported_options_raise():
    with pytest.raises(NotImplementedError, match="A11"):
        dataclasses.replace(TG.SMOKE, kv_cache_quant=True)
    with pytest.raises(NotImplementedError, match="A11"):
        dataclasses.replace(TG.SMOKE, moe=object())


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.init_params(TG.SMOKE, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.init_cache(TG.SMOKE, 1, 8)
