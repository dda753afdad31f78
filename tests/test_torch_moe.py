"""The port's mixture-of-experts LMs against the JAX package, on the CPU.

OLMoE-1B-7B and Mixtral-8x22B at ``SMOKE``, with the reference's
``init_params(PRNGKey(0))`` carried across by ``interop``: configurations
and parameter counts; ``forward`` against the scanned reference and the
unscanned one through the Pallas kernel in interpret mode; ``prefill`` and
12 teacher-forced ``decode_step``s; the MoE ``_mlp`` alone; ``loss_fn`` and
every gradient leaf against ``jax.value_and_grad`` (with ``remat`` and
``remat_inner``; the reference's ``moe_group_map`` 'vmap' and 'scan' against
the port's one batched map).  Targeted cases:
capacity drops under a router skewed to one expert, ties under a zeroed
router (experts 0..K-1 chosen, as ``jax.lax.top_k`` chooses them), decode
at capacity 1, and the CLI trainer on OLMoE.  Inputs are made with numpy
from seeds.

Tolerances: float32 atol 2e-5 (the packages sum matrix products in other
orders); bf16 within twice the reference's own bf16 error (``_close`` of
``tests/test_torch_transformer.py``; see ``_check``).  ``remat_inner`` on
and off agree within 1e-6 (the same arithmetic, recomputed).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mixtral_8x22b as JX
from repro.configs import olmoe_1b_7b as JO
from repro.models import transformer as jtr
from repro_torch import interop
from repro_torch.configs import mixtral_8x22b as TX
from repro_torch.configs import olmoe_1b_7b as TO
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as ttr
from repro_torch.training import train_loop as TT
from repro_torch.training import tree as T
from test_torch_transformer import _close

ARCHS = {"olmoe": (JO, TO), "mixtral": (JX, TX)}
PROMPT, MAX_LEN, N_DECODE = 20, 40, 12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs files in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_init(jcfg):
    """The reference's ``init_params(jcfg, PRNGKey(0))``, compiled once."""
    return jax.jit(lambda k: jtr.init_params(jcfg, k))(jax.random.PRNGKey(0))


def _port_params(tcfg, jp):
    return interop.transformer_params_from_arrays(tcfg, _np(jp), device="cpu")


def _layer0(tree):
    return {k: v[0] for k, v in tree["layers"].items()}


def _pairs(arch: str, **flags):
    jm, tm = ARCHS[arch]
    return dataclasses.replace(jm.SMOKE, **flags), dataclasses.replace(tm.SMOKE, **flags)


# =========================================================================
# configurations
# =========================================================================
@pytest.mark.parametrize("arch", list(ARCHS))
def test_configs_match_reference(arch):
    jm, tm = ARCHS[arch]
    for jc, tc in ((jm.CONFIG, tm.CONFIG), (jm.SMOKE, tm.SMOKE)):
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        np.testing.assert_array_equal(tc.layer_windows(), jc.layer_windows())
        for f in ("name", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff",
                  "vocab", "rope_theta", "norm_eps", "sliding_window", "global_every",
                  "tie_embeddings", "remat", "remat_inner"):
            assert getattr(tc, f) == getattr(jc, f), f
        assert dataclasses.asdict(tc.moe) == dataclasses.asdict(jc.moe)
    assert tm.CONFIG.dtype == torch.bfloat16 and tm.SMOKE.dtype == torch.float32
    ja, ta = jm.get_arch(), tm.get_arch()
    assert (ta.arch_id, ta.family) == (ja.arch_id, ja.family)
    assert ta.meta == ja.meta


def test_olmoe_counts_and_capacities():
    assert TO.CONFIG.param_count() == 6_816_073_728
    assert TO.CONFIG.active_param_count() == 1_178_929_152
    m = TO.CONFIG.moe
    # C = max(1, int(cf * K * S / E)): a 2,048-token prompt, a decode step
    assert m.capacity(2048) == 320 and m.capacity(1) == 1
    assert TX.CONFIG.moe.capacity(4096) == int(1.25 * 2 * 4096 / 8)


def test_moe_must_be_a_moe_cfg():
    with pytest.raises(TypeError, match="MoECfg"):
        dataclasses.replace(TO.SMOKE, moe=dict(n_experts=8, top_k=2, d_ff=64))
    with pytest.raises(ValueError, match="top_k"):
        ttr.MoECfg(n_experts=4, top_k=5, d_ff=8)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_params_shapes_and_scale(arch):
    jc, tc = _pairs(arch)
    p = ttr.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    jshapes = jax.eval_shape(lambda k: jtr.init_params(jc, k), jax.random.PRNGKey(0))
    assert set(p["layers"]) == set(jshapes["layers"])
    for k, v in jshapes["layers"].items():
        assert tuple(p["layers"][k].shape) == v.shape, k
    n = sum(t.numel() for t in T.leaves(p))
    assert n == tc.param_count()
    D, Fe = tc.d_model, tc.moe.d_ff
    for k, fan_in in (("router", D), ("wg", D), ("wd", Fe)):
        std = float(p["layers"][k].std())
        assert abs(std - fan_in ** -0.5) < 0.1 * fan_in ** -0.5, k


# =========================================================================
# the model against the reference
# =========================================================================
@pytest.fixture(scope="module", params=[(a, bf16) for a in ARCHS for bf16 in (False, True)],
                ids=lambda p: f"{p[0]}-{'bf16' if p[1] else 'f32'}")
def model(request):
    """The reference's SMOKE parameters in both packages.  For bf16 also the
    reference at float32 on the same (bf16-valued) weights: the yardstick of
    the reference's own bf16 rounding error."""
    arch, bf16 = request.param
    jc, tc = _pairs(arch)
    j32 = jc
    if bf16:
        jc = dataclasses.replace(jc, dtype=jnp.bfloat16)
        tc = dataclasses.replace(tc, dtype=torch.bfloat16)
    jp = _jax_init(jc)
    tp = _port_params(tc, jp)
    refs = [(jc, jp)]
    if bf16:
        refs.append((j32, jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)))
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, jc.vocab, size=(2, PROMPT)).astype(np.int32)
    forced = rng.integers(0, jc.vocab, size=(N_DECODE, 2)).astype(np.int32)
    return dict(bf16=bf16, jc=jc, tc=tc, jp=jp, tp=tp, refs=refs, tokens=tokens,
                forced=forced)


def _check(got, wants):
    """float32: ``_close`` (atol 2e-5).  bf16: the port within twice the
    reference's own bf16 error, ``_close``'s bound, without its check that
    this error is rounding noise: a near tie of two gates, rounded apart
    differently in bf16 and float32, sends a token to another expert, and at
    OLMoE SMOKE the reference's own bf16 run does so (its distance from
    float32 reaches half the largest |logit|).  The MoE layer alone, on the
    same bf16 input, is held to one bf16 rounding with equal routing
    (``test_moe_mlp_matches_reference``)."""
    if len(wants) == 1:
        _close(got, wants[0])
        return
    got, want, want32 = (np.asarray(a, np.float32) for a in (got, *wants))
    own, err = float(np.abs(want - want32).max()), float(np.abs(got - want).max())
    assert got.shape == want.shape and 0 < own and err <= 2 * own, (err, own)


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


def test_prefill_and_decode_steps_match_reference(model):
    toks = jnp.asarray(model["tokens"])
    outs = [jtr.prefill(jc, jp, toks, MAX_LEN) for jc, jp in model["refs"]]
    tl, tcache = ttr.prefill(model["tc"], model["tp"], torch.from_numpy(model["tokens"]),
                             MAX_LEN)
    assert tl.dtype == torch.float32
    _check(tl, [o[0] for o in outs])
    _check(tcache[0].float(), [o[1][0] for o in outs])
    _check(tcache[1].float(), [o[1][1] for o in outs])
    caches = [o[1] for o in outs]
    steps = [jax.jit(lambda p, c, t, n, jc=jc: jtr.decode_step(jc, p, c, t, n))
             for jc, _ in model["refs"]]
    for i, tok in enumerate(model["forced"]):      # teacher forcing: all get these tokens
        n = PROMPT + i + 1
        wants = []
        for r, ((_, jp), step) in enumerate(zip(model["refs"], steps)):
            logits, caches[r] = step(jp, caches[r], jnp.asarray(tok), n)
            wants.append(logits)
        tl, tcache = ttr.decode_step(model["tc"], model["tp"], tcache, torch.from_numpy(tok), n)
        _check(tl, wants)
    _check(tcache[0].float(), [c[0] for c in caches])
    _check(tcache[1].float(), [c[1] for c in caches])


def test_forward_impls_agree(model):
    toks = torch.from_numpy(model["tokens"])
    a = ttr.forward(model["tc"], model["tp"], toks)
    b = ttr.forward(dataclasses.replace(model["tc"], impl="torch"), model["tp"], toks)
    assert torch.equal(a, b)    # on CPU tensors the wrapper runs the plain version


# =========================================================================
# the MoE layer alone, and its routing
# =========================================================================
def _zero_router(tree):
    """``tree`` with every layer's router zeroed: every gate ties."""
    return dict(tree, layers=dict(tree["layers"], router=jnp.zeros_like(tree["layers"]["router"])))


_ref_mlp = jax.jit(jtr._mlp, static_argnums=0)


def _routes(h, router, k):
    """The top-k experts of the normed input ``h`` in the reference's
    arithmetic (``jtr._mlp``'s first lines)."""
    gj = jax.nn.softmax((jnp.asarray(h) @ router).astype(jnp.float32), axis=-1)
    return np.asarray(jax.lax.top_k(gj, k)[1])


@pytest.mark.parametrize("router", ["random", "zero"])
@pytest.mark.parametrize("S", [1, 3, 64])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_moe_mlp_matches_reference(arch, S, router):
    """The MoE layer alone (layer 0's weights) on the same input.  S = 1 and
    3 run at capacity 1 (a decode step's); the zeroed router ties every gate,
    so every token picks experts 0..K-1 and all but C of them are dropped.
    float32: atol 2e-5.  bf16 (the same weights and input rounded to bf16):
    the same experts for every token as the reference's bf16 routing, and
    the output within one bf16 rounding of the reference's (rtol 2^-7; atol
    2^-7, as the residual sum rounds at the size of its terms, which may
    cancel)."""
    jc, tc = _pairs(arch)
    jp = _jax_init(jc)
    if router == "zero":
        jp = _zero_router(jp)
    lpj = jax.tree_util.tree_map(lambda a: a[0], jp["layers"])
    lpt = _layer0(_port_params(tc, jp))
    x = np.random.default_rng(S).normal(size=(3, S, jc.d_model)).astype(np.float32)
    want = np.asarray(_ref_mlp(jc, lpj, jnp.asarray(x)))
    got = ttr._mlp(tc, lpt, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    assert tc.moe.capacity(S) == (1 if S <= 3 else int(1.25 * tc.moe.top_k * S / tc.moe.n_experts))

    jc16 = dataclasses.replace(jc, dtype=jnp.bfloat16)
    tc16 = dataclasses.replace(tc, dtype=torch.bfloat16)
    lpj16 = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), lpj)
    lpt16 = {k: v.bfloat16() for k, v in lpt.items()}
    xj16, xt16 = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    want16 = np.asarray(_ref_mlp(jc16, lpj16, xj16), np.float32)
    got16 = ttr._mlp(tc16, lpt16, xt16).float().numpy()
    ht = ttr.rms_norm(xt16, lpt16["ln2"], tc.norm_eps)
    port_routes = ttr.top_k(torch.softmax((ht @ lpt16["router"]).float(), -1), tc.moe.top_k)[1]
    ref_routes = _routes(jtr.rms_norm(xj16, lpj16["ln2"], jc.norm_eps), lpj16["router"],
                         jc.moe.top_k)
    np.testing.assert_array_equal(port_routes.numpy(), ref_routes)
    np.testing.assert_allclose(got16, want16, atol=2 ** -7, rtol=2 ** -7)


def test_top_k_breaks_ties_as_jax_does():
    """Equal gates: the lower expert index first, as ``jax.lax.top_k``."""
    rng = np.random.default_rng(4)
    gates = (rng.integers(0, 4, size=(50, 64)) / 4).astype(np.float32)   # many ties
    gates[0] = 1 / 64                                                    # all tie
    for k in (1, 2, 8, 64):
        wv, wi = jax.lax.top_k(jnp.asarray(gates), k)
        gv, gi = ttr.top_k(torch.from_numpy(gates), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    assert ttr.top_k(torch.from_numpy(gates[:1]), 8)[1].tolist() == [list(range(8))]


def test_zeroed_router_forward_matches_reference():
    """Every gate ties: experts 0..K-1 for every token, the rest dropped."""
    jc, tc = _pairs("olmoe")
    jp = _zero_router(_jax_init(jc))
    tp = _port_params(tc, jp)
    toks = np.random.default_rng(2).integers(0, jc.vocab, size=(2, 64)).astype(np.int32)
    want = np.asarray(jtr.forward(jc, jp, jnp.asarray(toks)))
    got = ttr.forward(tc, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_capacity_drops_under_a_skewed_router_match_reference():
    """S = 64: every embedding shares a direction u that expert 0's router
    column follows, so every token's first choice at layer 0 is expert 0 and
    44 of its 64 (capacity 20) are dropped; the forward still equals the
    reference's."""
    jc, tc = _pairs("olmoe")
    S, D = 64, jc.d_model
    jp = _np(_jax_init(jc))
    u = np.random.default_rng(8).normal(size=D).astype(np.float32)
    u /= np.linalg.norm(u)
    jp["embed"] = jp["embed"] + 2.0 * u
    jp["layers"]["router"] = jp["layers"]["router"].copy()
    jp["layers"]["router"][:, :, 0] += 8.0 * u
    toks = np.random.default_rng(9).integers(0, jc.vocab, size=(2, S)).astype(np.int32)
    # layer 0's routing, from its input (the embeddings; ln2's weight is 1)
    x = jp["embed"][toks]
    h = x / np.sqrt((x * x).mean(-1, keepdims=True) + jc.norm_eps)
    first = (h @ jp["layers"]["router"][0]).argmax(-1)
    C = tc.moe.capacity(S)
    assert C == 20 and (first == 0).all()
    want = np.asarray(jtr.forward(jc, jax.tree_util.tree_map(jnp.asarray, jp),
                                  jnp.asarray(toks)))
    got = ttr.forward(tc, _port_params(tc, jp), torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_moe_capacity_drops_bounded():
    """The port's analogue of ``tests/test_arch_smoke.py``'s: at S = 64
    over-capacity tokens are dropped, never mis-routed, and the logits stay
    finite."""
    tc = TO.SMOKE
    p = ttr.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, tc.vocab, (2, 64), generator=torch.Generator().manual_seed(1))
    logits = ttr.forward(tc, p, toks)
    assert logits.shape == (2, 64, tc.vocab) and bool(torch.isfinite(logits).all())


# =========================================================================
# training
# =========================================================================
def _batch(jc, seed=1, batch=4, seq=40):
    toks = np.random.default_rng(seed).integers(0, jc.vocab, size=(batch, seq + 1)).astype(np.int32)
    a, b = toks[:, :-1], toks[:, 1:]
    return (dict(tokens=jnp.asarray(a), labels=jnp.asarray(b)),
            dict(tokens=torch.from_numpy(a.copy()), labels=torch.from_numpy(b.copy())))


def _port_grad(tc, tp, tb):
    return TT.value_and_grad(lambda p, b: ttr.loss_fn(tc, p, b), tp, tb)


@pytest.mark.parametrize("variant", ["olmoe", "olmoe-inner", "mixtral-inner-scan"])
def test_loss_and_gradients_match_reference(variant):
    """'scan' maps the reference's groups one by one; the port maps them at
    once in every case."""
    arch = variant.split("-")[0]
    jc, tc = _pairs(arch, remat_inner="inner" in variant)
    if variant.endswith("scan"):
        jc = dataclasses.replace(jc, moe_group_map="scan")
    jp = _jax_init(jc)
    tp = _port_params(tc, jp)
    jb, tb = _batch(jc)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jtr.loss_fn(jc, p, b)))(jp, jb)
    tl, tg = _port_grad(tc, tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), atol=2e-5, rtol=0)
    want = dict(jax.tree_util.tree_flatten_with_path(jg)[0])
    got = T.leaves_with_paths(tg)
    assert [p for p, _ in got] == [jax.tree_util.keystr(k) for k in want]
    for (path, g), w in zip(got, want.values()):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=0,
                                   err_msg=path)
    assert float(tg["layers"]["router"].abs().max()) > 0     # the gates carry a gradient


@pytest.mark.parametrize("arch", list(ARCHS))
def test_remat_inner_gives_the_same_gradients(arch):
    """``remat_inner`` off and on (the MoE groups and attention chunks
    recomputed in backward): the same loss and gradients."""
    jc, tc = _pairs(arch)
    tp = _port_params(tc, _jax_init(jc))
    _, tb = _batch(jc, seed=3)
    base_l, base_g = _port_grad(tc, tp, tb)
    l, g = _port_grad(dataclasses.replace(tc, remat_inner=True), tp, tb)
    assert abs(float(l) - float(base_l)) <= 1e-6
    for a, b in zip(T.leaves(g), T.leaves(base_g)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_train_cli_runs_olmoe(tmp_path, capsys):
    losses = launch_train.train("olmoe-1b-7b", steps=2, smoke=True, ckpt_dir=str(tmp_path),
                                device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "final loss" in capsys.readouterr().out
