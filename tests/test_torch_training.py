"""The port's training path against the JAX package, on the CPU.

Optimizer: ``schedule_lr`` for the three schedules at steps 0 … 12,000
(float32 equal wherever the packages' ``cos`` or ``pow`` agree; elsewhere
within that 1-ulp difference carried through the schedule, plus 2 ulps for
the roundings after it), ``apply_updates``
on one tree over 4 steps (atol 1e-7 in float32, a bf16 leaf within one bf16
ulp, in place and not), AdamW on the quadratic of ``tests/test_training.py``.
LM: minicpm-2b SMOKE (and llama3-405b SMOKE with grouped GQA and chunk
remat) with the reference's ``init_params(PRNGKey(0))`` carried across by
``interop``: ``loss_fn`` and every gradient leaf against
``jax.value_and_grad`` (atol 2e-5), 3 train steps (parameters within 2e-5;
Adam's eps 1e-3 there, see ``TRAIN_EPS``),
the bf16 loss and gradients within twice the reference's own bf16 error,
microbatches at llama3-405b SMOKE (the reference's bounds between 1 and 2
microbatches, 2e-5 against its microbatched step).  Compression: int8 and
top-k payloads, residuals and decodes equal to the reference's over 30
rounds of error feedback, on tie-free draws.  The data-parallel step at
world size 1 against the reference's single-axis shard_map step, and two
gloo ranks against the one-process mean of their shards' gradients.  DLRM
and the four GNNs: the loss's gradients (``impl='torch'``) against
``jax.grad``.  Every kernel wrapper refuses an input that requires grad
under ``impl='cuda'`` instead of dropping its gradient.  Inputs are made
with numpy from seeds.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_dist_leg
from repro.configs import dlrm_rm2 as JR
from repro.configs import egnn as JE
from repro.configs import llama3_405b as JL
from repro.configs import meshgraphnet as JMG
from repro.configs import minicpm_2b as JM
from repro.configs import pna as JP
from repro.configs import schnet as JS
from repro.models import dlrm as jdm
from repro.models import gnn as jg
from repro.models import transformer as jtr
from repro.training import compression as JC
from repro.training import optimizer as JO
from repro.training import train_loop as JT
from repro_torch import interop
from repro_torch.configs import dlrm_rm2 as TRD
from repro_torch.configs import egnn as TE
from repro_torch.configs import llama3_405b as TL
from repro_torch.configs import meshgraphnet as TMG
from repro_torch.configs import minicpm_2b as TM
from repro_torch.configs import pna as TP
from repro_torch.configs import schnet as TS
from repro_torch.kernels import bucket_scatter as BS
from repro_torch.kernels import embedding_bag as EB
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import hop_scatter as HK
from repro_torch.kernels import interval_warp as IW
from repro_torch.models import dlrm as tdm
from repro_torch.models import gnn as tg
from repro_torch.models import transformer as ttr
from repro_torch.training import compression as TC
from repro_torch.training import optimizer as TO
from repro_torch.training import train_loop as TT
from repro_torch.training import tree as T



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the gloo ranks run with one, so the one-process
    simulation sums in the same order; and the suite runs files in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    """(path, numpy leaf) of a JAX tree, in its order."""
    return [(jax.tree_util.keystr(k), np.asarray(v))
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _assert_trees(got, want, atol, what=""):
    """The port's tree against the reference's: the same paths, each leaf
    within ``atol``."""
    g, w = T.leaves_with_paths(got), _leaves(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        a = a.detach().float().numpy() if torch.is_tensor(a) else np.asarray(a)
        np.testing.assert_allclose(a, np.asarray(b, np.float32), atol=atol, rtol=0,
                                   err_msg=f"{what} {path}")


# =========================================================================
# optimizer
# =========================================================================
@pytest.mark.parametrize("sched", ["const", "cosine", "wsd"])
def test_schedule_lr_matches_reference(sched):
    kw = dict(lr=1e-3, schedule=sched, warmup_steps=100, total_steps=10_000)
    steps = np.arange(0, 12_001, dtype=np.int32)
    want = np.asarray(JO.schedule_lr(JO.OptCfg(**kw), jnp.asarray(steps)))
    got = TO.schedule_lr(TO.OptCfg(**kw), torch.from_numpy(steps)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    s = steps.astype(np.float32)
    # the one transcendental of each schedule, on the same float32 argument
    if sched == "cosine":
        t = np.clip((s - np.float32(100)) / np.float32(9900), 0, 1).astype(np.float32)
        tj = np.asarray(jnp.cos(jnp.pi * jnp.asarray(t)))
        tt = torch.cos(math.pi * torch.from_numpy(t)).numpy()
        slope = 1e-3 * 0.9 * 0.5          # d lr / d cos after the warm-up
    elif sched == "wsd":
        t = np.clip((s - np.float32(9000)) / np.float32(1000), 0, 1).astype(np.float32)
        tj = np.asarray(0.1 ** jnp.asarray(t))
        tt = (0.1 ** torch.from_numpy(t)).numpy()
        slope = 1e-3
    else:
        tj = tt = np.zeros_like(s)
        slope = 0.0
    same = tj == tt
    np.testing.assert_array_equal(got[same], want[same])
    # elsewhere: the term's difference times the schedule's slope in it, and
    # the roundings of the products and sums after it (at most 2 ulps)
    bound = slope * np.abs(tj - tt) + 2 * np.spacing(want)
    assert (np.abs(got - want) <= bound)[~same].all()
    # the reference test's shape of each schedule
    assert got[0] < got[100] * 0.5 and got[100] == np.float32(1e-3)
    if sched == "wsd":
        assert got[5000] == np.float32(1e-3) and got[10_000] < 2e-4


def _draw_tree(rng, bf16_leaf: bool):
    t = dict(a=rng.normal(size=(5, 7)).astype(np.float32),
             b=dict(c=rng.normal(size=(3,)).astype(np.float32),
                    d=[rng.normal(size=(2, 3, 4)).astype(np.float32),
                       rng.normal(size=(6,)).astype(np.float32)]))
    if bf16_leaf:
        t["h"] = rng.normal(size=(4, 4)).astype(np.float32)
    return t


def _pair_tree(t):
    """The same values as a JAX tree and a torch tree ('h' in bf16)."""
    j = jax.tree_util.tree_map(jnp.asarray, t)
    p = T.tree_map(torch.from_numpy, t)
    if "h" in t:
        j["h"] = j["h"].astype(jnp.bfloat16)
        p["h"] = p["h"].to(torch.bfloat16)
    return j, p


@pytest.mark.parametrize("inplace", [False, True], ids=["new", "inplace"])
@pytest.mark.parametrize("clip", [1.0, None], ids=["clip", "noclip"])
def test_apply_updates_matches_reference(inplace, clip):
    rng = np.random.default_rng(7)
    jp, tp = _pair_tree(_draw_tree(rng, True))
    jcfg = JO.OptCfg(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=clip)
    tcfg = TO.OptCfg(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=clip)
    js, ts = JO.init_state(jp), TO.init_state(tp)
    assert ts["step"].dtype == torch.int32 and T.leaves(ts["mu"])[0].dtype == torch.float32
    for _ in range(4):
        jg_, tg_ = _pair_tree(_draw_tree(rng, True))
        jp, js, jm = JO.apply_updates(jcfg, jp, jg_, js)
        tp, ts, tm = TO.apply_updates(tcfg, tp, tg_, ts, inplace=inplace)
        assert float(tm["lr"]) == float(jm["lr"])
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        assert int(ts["step"]) == int(js["step"]) and ts["step"].dtype == torch.int32
        assert tp["h"].dtype == torch.bfloat16 and ts["mu"]["h"].dtype == torch.float32
        f32 = lambda t: {k: v for k, v in t.items() if k != "h"}
        _assert_trees(f32(tp), f32(jp), 1e-7, "params")
        _assert_trees(ts["mu"], js["mu"], 1e-7, "mu")
        _assert_trees(ts["nu"], js["nu"], 1e-7, "nu")
        h = np.asarray(jp["h"], np.float32)
        np.testing.assert_allclose(tp["h"].float().numpy(), h, atol=0, rtol=2 ** -8)


def test_adamw_converges_on_the_quadratic():
    """``tests/test_training.py``'s quadratic, in both packages."""
    kw = dict(lr=0.1, schedule="const", warmup_steps=0, weight_decay=0.0, clip_norm=None)
    jp, tp = dict(w=jnp.asarray([5.0, -3.0])), dict(w=torch.tensor([5.0, -3.0]))
    js, ts = JO.init_state(jp), TO.init_state(tp)
    for _ in range(300):
        jp, js, _ = JO.apply_updates(JO.OptCfg(**kw), jp, dict(w=2 * jp["w"]), js)
        tp, ts, _ = TO.apply_updates(TO.OptCfg(**kw), tp, dict(w=2 * tp["w"]), ts)
    assert float(tp["w"].abs().max()) < 0.05
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), atol=1e-6)


# =========================================================================
# the LM's loss, gradients and train step
# =========================================================================
@functools.lru_cache(maxsize=None)
def _jax_init(jcfg):
    """The reference's ``init_params(jcfg, PRNGKey(0))``, compiled once."""
    return jax.jit(lambda k: jtr.init_params(jcfg, k))(jax.random.PRNGKey(0))


def _lm(jcfg, tcfg, seed=1, batch=4, seq=32):
    jp = _jax_init(jcfg)
    tp = interop.transformer_params_from_arrays(tcfg, _np(jp), device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab, size=(batch, seq + 1)).astype(np.int32)
    return jp, tp, toks


def _batches(toks):
    a, b = toks[:, :-1], toks[:, 1:]
    return (dict(tokens=jnp.asarray(a), labels=jnp.asarray(b)),
            dict(tokens=torch.from_numpy(a.copy()), labels=torch.from_numpy(b.copy())))


def test_configs_match_reference():
    for jc, tc in ((JM.CONFIG, TM.CONFIG), (JM.SMOKE, TM.SMOKE), (JL.CONFIG, TL.CONFIG),
                   (JL.SMOKE, TL.SMOKE)):
        assert tc.param_count() == jc.param_count()
        for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff", "vocab",
                  "rope_theta", "norm_eps", "sliding_window", "global_every",
                  "tie_embeddings", "remat", "remat_inner", "gqa_native"):
            assert getattr(tc, f) == getattr(jc, f), f
    assert TM.CONFIG.param_count() == 2_724_880_896
    assert TM.CONFIG.dtype == torch.bfloat16 and TM.SMOKE.dtype == torch.float32
    for jm, tm in ((JM, TM), (JL, TL)):
        ja, ta = jm.get_arch(), tm.get_arch()
        assert ta.arch_id == ja.arch_id and ta.meta["params"] == ja.meta["params"]
        assert dataclasses.asdict(ta.meta["opt"]) == dataclasses.asdict(ja.meta["opt"])


@pytest.mark.parametrize("variant", ["minicpm", "minicpm-noremat", "llama-native-inner"])
def test_loss_and_gradients_match_reference(variant):
    jc, tc = (JL.SMOKE, TL.SMOKE) if variant.startswith("llama") else (JM.SMOKE, TM.SMOKE)
    flags = dict(remat=False) if variant.endswith("noremat") else (
        dict(gqa_native=True, remat_inner=True) if variant.endswith("inner") else {})
    jc, tc = dataclasses.replace(jc, **flags), dataclasses.replace(tc, **flags)
    jp, tp, toks = _lm(jc, tc, seq=40)
    jb, tb = _batches(toks)
    jl, jgrad = jax.jit(jax.value_and_grad(lambda p, b: jtr.loss_fn(jc, p, b)))(jp, jb)
    tl, tgrad = TT.value_and_grad(lambda p, b: ttr.loss_fn(tc, p, b), tp, tb)
    assert tl.dtype == torch.float32 and tl.dim() == 0
    np.testing.assert_allclose(float(tl), float(jl), atol=2e-5, rtol=0)
    _assert_trees(tgrad, jgrad, 2e-5, "gradient")
    assert all(not p.requires_grad for p in T.leaves(tp))     # the caller's are unmarked


def test_chunked_attention_matches_reference_across_chunks():
    """Three query chunks with padding, a sliding window, GQA both ways."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, h, 70, 8)).astype(np.float32) for h in (4, 2, 2))
    for native in (False, True):
        want = np.asarray(jtr._chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                 jnp.int32(20), 8, chunk=32, native=native))
        got = ttr._chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), 20, 8, chunk=32, native=native)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


# Adam's eps bounds its gain on a gradient near zero (|du/dg| <= 1/eps): at
# the default 1e-8 a gradient that cancels to ~1e-8 has its sign, and so
# its whole update of ``lr``, decided by the last bits of the sums, which
# the packages order differently; at 1e-3 a 1e-7 gradient difference moves
# a parameter by ~lr · 1e-4.  ``apply_updates`` is held at eps 1e-8 on
# equal gradients above.
TRAIN_EPS = 1e-3


def test_three_train_steps_match_reference():
    jc, tc = JM.SMOKE, TM.SMOKE
    jp, tp, _ = _lm(jc, tc)
    p0 = [x.clone() for x in T.leaves(tp)]
    kw = dict(lr=1e-3, schedule="cosine", warmup_steps=2, total_steps=10, eps=TRAIN_EPS)
    jstep = JT.make_train_step(lambda p, b: jtr.loss_fn(jc, p, b), JO.OptCfg(**kw), donate=False)
    tstep = TT.make_train_step(lambda p, b: ttr.loss_fn(tc, p, b), TO.OptCfg(**kw))
    js, ts = JO.init_state(jp), TO.init_state(tp)
    rng = np.random.default_rng(5)
    for _ in range(3):
        jb, tb = _batches(rng.integers(0, jc.vocab, size=(4, 33)).astype(np.int32))
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=2e-5)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
        _assert_trees(tp, jp, 2e-5, "params")
    assert max(float((a - b).abs().max()) for a, b in zip(T.leaves(tp), p0)) > 1e-3


def test_bf16_loss_and_gradients_within_twice_the_reference_error():
    """bf16 SMOKE: the port's loss and gradients may differ from the
    reference's by at most twice the reference's own bf16 error (its
    distance from float32 arithmetic on the same bf16-valued weights)."""
    jc = dataclasses.replace(JM.SMOKE, dtype=jnp.bfloat16)
    tc = dataclasses.replace(TM.SMOKE, dtype=torch.bfloat16)
    jp, tp, toks = _lm(jc, tc)
    j32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jp)
    jb, tb = _batches(toks)
    jl, jgr = jax.jit(jax.value_and_grad(lambda p, b: jtr.loss_fn(jc, p, b)))(jp, jb)
    fl, fgr = jax.jit(jax.value_and_grad(lambda p, b: jtr.loss_fn(JM.SMOKE, p, b)))(j32, jb)
    tl, tgr = TT.value_and_grad(lambda p, b: ttr.loss_fn(tc, p, b), tp, tb)
    assert abs(float(tl) - float(jl)) <= 2 * abs(float(jl) - float(fl)) + 1e-6
    for (path, g), (_, want), (_, want32) in zip(T.leaves_with_paths(tgr), _leaves(jgr),
                                                 _leaves(fgr)):
        assert g.dtype == torch.bfloat16, path
        own = np.abs(np.asarray(want, np.float32) - want32).max()
        err = np.abs(g.float().numpy() - np.asarray(want, np.float32)).max()
        assert 0 < own and err <= 2 * own, (path, err, own)


def test_microbatches_match_one_batch_and_reference():
    """llama3-405b SMOKE: 1 against 2 microbatches with the reference test's
    bounds, and the port's 2-microbatch step against the reference's."""
    jc, tc = JL.SMOKE, TL.SMOKE
    jp, tp, toks = _lm(jc, tc, seq=16)
    jb, tb = _batches(toks)
    kw = dict(lr=1e-3, schedule="const", warmup_steps=0, eps=TRAIN_EPS)
    loss_t = lambda p, b: ttr.loss_fn(tc, p, b)
    p1, _, m1 = TT.make_train_step(loss_t, TO.OptCfg(**kw), 1, donate=False)(
        tp, TO.init_state(tp), tb)
    p2, _, m2 = TT.make_train_step(loss_t, TO.OptCfg(**kw), 2, donate=False)(
        tp, TO.init_state(tp), tb)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-4)
    assert max(float((a - b).abs().max()) for a, b in zip(T.leaves(p1), T.leaves(p2))) < 5e-3
    jstep = JT.make_train_step(lambda p, b: jtr.loss_fn(jc, p, b), JO.OptCfg(**kw), 2,
                               donate=False)
    jp2, _, jm2 = jstep(jp, JO.init_state(jp), jb)
    np.testing.assert_allclose(float(m2["loss"]), float(jm2["loss"]), atol=2e-5)
    _assert_trees(p2, jp2, 2e-5, "params")


def test_microbatches_must_divide_the_batch():
    step = TT.make_train_step(lambda p, b: (p["w"] * b["x"]).sum(), TO.OptCfg(), 3)
    p = dict(w=torch.ones(2))
    with pytest.raises(ValueError, match="microbatches"):
        step(p, TO.init_state(p), dict(x=torch.ones(4, 2)))


# =========================================================================
# compression and the data-parallel step
# =========================================================================
def _tie_free(rng, shape):
    """Normal draws whose magnitudes are distinct (top-k has no ties)."""
    n = int(np.prod(shape))
    mags = (rng.permutation(n) + 1 + rng.uniform(0.1, 0.9, n)) / n
    return (mags * rng.choice([-1.0, 1.0], n)).astype(np.float32).reshape(shape)


def _grad_tree(rng):
    return dict(w=_tie_free(rng, (64,)), m=[_tie_free(rng, (8, 5)), _tie_free(rng, (3, 4, 2))])


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compression_and_error_feedback_match_reference(kind):
    rng = np.random.default_rng(0)
    jcfg, tcfg = JC.CompressionCfg(kind=kind, topk_frac=0.2), TC.CompressionCfg(kind=kind,
                                                                                topk_frac=0.2)
    g = _grad_tree(rng)
    jgr, tgr = jax.tree_util.tree_map(jnp.asarray, g), T.tree_map(torch.from_numpy, g)
    jerr, terr = JC.init_error_state(jgr), TC.init_error_state(tgr)
    for _ in range(30):
        jpay, jerr = JC.compress(jcfg, jgr, jerr)
        tpay, terr = TC.compress(tcfg, tgr, terr)
        for x, e in zip(T.leaves(tgr), T.leaves(terr)):   # the next round's: tie-free
            gf = (x + e).numpy().ravel()
            assert np.unique(np.abs(gf)).size == gf.size
        jtuples = jax.tree_util.tree_leaves(jpay, is_leaf=lambda x: isinstance(x, tuple))
        for jt, tt in zip(jtuples, T.leaves_like(tpay, tgr)):
            assert len(jt) == len(tt)
            for a, b in zip(jt, tt):
                np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
        _assert_trees(terr, jerr, 0.0, "residual")
        _assert_trees(TC.decompress(tcfg, tpay, tgr), JC.decompress(jcfg, jpay, jgr), 0.0,
                      "decoded")
    if kind == "int8":
        assert T.leaves_like(tpay, tgr)[0][0].dtype == torch.int8


def _linear_problem(seed):
    """A loss whose gradient is its coefficient tree exactly, in both
    packages (so the exchange sees equal inputs)."""
    rng = np.random.default_rng(seed)
    p, c = _grad_tree(rng), _grad_tree(rng)
    jloss = lambda q, b: sum(jnp.sum(x * y) for x, y in
                             zip(jax.tree_util.tree_leaves(q), jax.tree_util.tree_leaves(b)))
    tloss = lambda q, b: sum((x * y).sum() for x, y in zip(T.leaves(q), T.leaves(b)))
    return p, c, jloss, tloss


@pytest.mark.parametrize("kind", ["none", "int8", "topk"])
def test_dp_step_world_one_matches_reference(kind):
    p, c, jloss, tloss = _linear_problem(2)
    kw = dict(lr=1e-2, schedule="const", warmup_steps=0)
    mesh = jax.make_mesh((1,), ("data",))
    jstep = JT.make_dp_train_step(jloss, JO.OptCfg(**kw), mesh,
                                  JC.CompressionCfg(kind=kind, topk_frac=0.2))
    tstep = TT.make_dp_train_step(tloss, TO.OptCfg(**kw),
                                  compression=TC.CompressionCfg(kind=kind, topk_frac=0.2))
    jp, jb = jax.tree_util.tree_map(jnp.asarray, p), jax.tree_util.tree_map(jnp.asarray, c)
    tp, tb = T.tree_map(torch.from_numpy, p), T.tree_map(torch.from_numpy, c)
    jo, je = JT.train_state_init(jp, JO.OptCfg(**kw), with_err=True)
    to, te = TT.train_state_init(tp, TO.OptCfg(**kw), with_err=True)
    for _ in range(3):
        with mesh:
            jp, jo, je, jm = jstep(jp, jo, je, jb)
        tp, to, te, tm = tstep(tp, to, te, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-6)
        _assert_trees(tp, jp, 1e-7, "params")
        # under jit the reference divides by 127 as a product with its
        # reciprocal: the int8 scale moves by an ulp, the residual by up to
        # 127 of them (2^-23 of the largest |gradient| each side)
        _assert_trees(te, je, 2.0 ** -22 if kind == "int8" else 0.0, "residual")


def test_dp_step_world_one_lm_matches_reference():
    """The reference test's LM (llama3-405b SMOKE), int8 exchange: the
    loss, and the parameters moved."""
    jc, tc = JL.SMOKE, TL.SMOKE
    jp, tp, toks = _lm(jc, tc, batch=2, seq=16)
    jb, tb = _batches(toks)
    kw = dict(lr=1e-3, schedule="const", warmup_steps=0)
    mesh = jax.make_mesh((1,), ("data",))
    jstep = JT.make_dp_train_step(lambda p, b: jtr.loss_fn(jc, p, b), JO.OptCfg(**kw), mesh,
                                  JC.CompressionCfg(kind="int8"))
    with mesh:
        _, _, _, jm = jstep(jp, JO.init_state(jp), JC.init_error_state(jp), jb)
    step = TT.make_dp_train_step(lambda p, b: ttr.loss_fn(tc, p, b), TO.OptCfg(**kw),
                                 compression=TC.CompressionCfg(kind="int8"))
    p2, _, _, m = step(tp, TO.init_state(tp), TC.init_error_state(tp), tb)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=2e-5)
    assert max(float((a - b).abs().max()) for a, b in zip(T.leaves(p2), T.leaves(tp))) > 0


def test_dp_step_two_gloo_ranks_equal_the_one_process_mean():
    jp, tp, toks = _lm(JM.SMOKE, TM.SMOKE, seq=16)
    tree = _np(jp)
    shards = [dict(tokens=toks[r * 2:(r + 1) * 2, :-1].copy(),
                   labels=toks[r * 2:(r + 1) * 2, 1:].copy()) for r in range(2)]
    kinds = ("none", "int8", "topk")
    (got,) = torch_train_dist_leg.run_ranks(torch_train_dist_leg.dp_rank_main, 2, tree,
                                            shards, kinds)
    cfg = TO.OptCfg(lr=1e-3, schedule="const", warmup_steps=0)
    loss_fn = lambda p, b: ttr.loss_fn(TM.SMOKE, p, b)
    for kind in kinds:
        comp = TC.CompressionCfg(kind=kind, topk_frac=0.2)
        params = interop.transformer_params_from_arrays(TM.SMOKE, tree, device="cpu")
        losses, decoded, errs = [], [], []
        for sh in shards:
            loss, g = TT.value_and_grad(loss_fn, params,
                                        {k: torch.from_numpy(v) for k, v in sh.items()})
            losses.append(loss)
            payload, err = TC.compress(comp, g, TC.init_error_state(params))
            decoded.append(T.leaves(TC.decompress(comp, payload, g)))
            errs.append(err)
        mean = T.unflatten(params, [(a + b) / 2 for a, b in zip(*decoded)])
        want, _, _ = TO.apply_updates(cfg, params, mean, TO.init_state(params))
        assert got[kind]["loss"] == float((losses[0] + losses[1]) / 2)
        for a, b in zip(got[kind]["params"], T.leaves(want)):
            np.testing.assert_array_equal(a, b.numpy())
        for a, b in zip(got[kind]["err"], T.leaves(errs[1])):      # the last rank's residual
            np.testing.assert_array_equal(a, b.numpy())


# =========================================================================
# DLRM and the GNNs: the loss's gradients
# =========================================================================
def _draw_like(rng, shapes):
    """numpy Normal draws in a reference parameter tree's shapes, matrices
    scaled by 1 / sqrt(fan_in), vectors by 0.1."""
    return jax.tree_util.tree_map(
        lambda sd: jnp.asarray(rng.normal(size=sd.shape).astype(np.float32)
                               / (np.sqrt(sd.shape[0]) if len(sd.shape) == 2 else 10)), shapes)


def test_dlrm_loss_gradients_match_reference():
    rng = np.random.default_rng(4)
    jp = _draw_like(rng, jax.eval_shape(lambda k: jdm.init_params(JR.SMOKE, k),
                                        jax.random.PRNGKey(0)))
    tc = dataclasses.replace(TRD.SMOKE, impl="torch")
    tp = interop.dlrm_params_from_arrays(tc, _np(jp), device="cpu")
    B = 16
    batch = dict(dense=rng.normal(size=(B, JR.SMOKE.n_dense)).astype(np.float32),
                 sparse=rng.integers(0, 512, size=(B, JR.SMOKE.n_sparse,
                                                   JR.SMOKE.multi_hot)).astype(np.int32),
                 label=rng.integers(0, 2, size=(B,)).astype(np.float32))
    jl, jgr = jax.jit(jax.value_and_grad(lambda p, b: jdm.loss_fn(JR.SMOKE, p, b)))(
        jp, jax.tree_util.tree_map(jnp.asarray, batch))
    tl, tgr = TT.value_and_grad(lambda p, b: tdm.loss_fn(tc, p, b), tp,
                                {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    scale = max(float(np.abs(x).max()) for _, x in _leaves(jgr))
    _assert_trees(tgr, jgr, 1e-5 * scale, "gradient")


GNN_ARCHS = {"pna": (JP, TP, "n_layers"), "egnn": (JE, TE, "n_layers"),
             "meshgraphnet": (JMG, TMG, "n_layers"), "schnet": (JS, TS, "n_interactions")}


def _gnn_graph():
    """configs/common.py::gnn_smoke's graph (N 40, E 120, F 8, 4 graphs)."""
    rng = np.random.default_rng(0)
    N, E, F = 40, 120, 8
    return dict(node_feat=rng.normal(size=(N, F)).astype(np.float32),
                edge_src=rng.integers(0, N, E).astype(np.int32),
                edge_dst=rng.integers(0, N, E).astype(np.int32),
                coords=rng.normal(size=(N, 3)).astype(np.float32),
                graph_of=rng.integers(0, 4, N).astype(np.int32),
                targets=rng.normal(size=(N, 1)).astype(np.float32))


@pytest.mark.parametrize("arch", list(GNN_ARCHS))
def test_gnn_loss_gradients_match_reference(arch):
    jmod, tmod, depth = GNN_ARCHS[arch]
    jc = dataclasses.replace(jmod.CONFIG, **{depth: getattr(tmod.SMOKE, depth)})
    tc = dataclasses.replace(tmod.SMOKE, impl="torch")
    g = _gnn_graph()
    jp = _draw_like(np.random.default_rng(len(arch)),
                    jax.eval_shape(lambda k: jg.INIT[arch](jc, k, g["node_feat"].shape[1]),
                                   jax.random.PRNGKey(0)))
    jgb = jg.GraphBatch(**{k: jnp.asarray(v) for k, v in g.items()}, n_graphs=4)
    jl, jgr = jax.jit(jax.value_and_grad(lambda p: jg.gnn_loss(arch, jc, p, jgb)))(jp)
    tp = interop.gnn_params_from_arrays(arch, _np(jp), device="cpu")
    tgb = tg.GraphBatch(**{k: torch.from_numpy(v) for k, v in g.items()}, n_graphs=4)
    tl, tgr = TT.value_and_grad(lambda p, _: tg.gnn_loss(arch, tc, p, tgb), tp, None)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    scale = max(float(np.abs(x).max()) for _, x in _leaves(jgr))
    _assert_trees(tgr, jgr, 1e-4 * scale, "gradient")


# =========================================================================
# the kernel wrappers refuse a gradient they would drop
# =========================================================================
def _wrapper_calls():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.rand(*s, generator=g)
    ptr = torch.tensor([0, 2, 3, 5], dtype=torch.int64)
    src = torch.tensor([0, 1, 2, 0, 3], dtype=torch.int32)
    seg = torch.tensor([0, 0, 1, 2, 2])
    return {
        "B1 fused_hop_cols": (lambda x: HK.fused_hop_cols(x, src, r(2, 5, 3), ptr), (2, 4, 3)),
        "B2 fused_hop_interval": (lambda x: HK.fused_hop_interval(
            x, src, r(2, 5), torch.zeros(2, 5, dtype=torch.int32),
            torch.full((2, 5), 4, dtype=torch.int32), ptr), (2, 4, 4, 5)),
        "B3 scatter_cols": (lambda x: HK.scatter_cols(x, ptr), (2, 5, 3)),
        "B4 scatter_extremum": (lambda x: HK.scatter_extremum(x, r(2, 5), ptr, 1e30, True),
                                (2, 5)),
        "B5 bucket_scatter": (lambda x: BS.bucket_scatter(x, seg, 3, impl="cuda"), (5, 3)),
        "B6 interval_warp": (lambda x: IW.interval_warp(
            x, torch.tensor([[0, 5], [2, 9], [4, 7]], dtype=torch.int32),
            torch.tensor([0, 3, 6, 9], dtype=torch.int32), impl="cuda"), (3, 3)),
        "B7 flash_attention": (lambda x: FA.flash_attention(x, r(1, 2, 4, 8), r(1, 2, 4, 8),
                                                            impl="cuda"), (1, 2, 4, 8)),
        "B7 decode_attention": (lambda x: FA.decode_attention(x[:, :, :1], x, x, 3,
                                                              impl="cuda"), (1, 2, 4, 8)),
        "B8 embedding_bags": (lambda x: EB.embedding_bags(
            [x, r(6, 4)], torch.zeros(2, 2, 3, dtype=torch.int32), impl="cuda"), (6, 4)),
        "B8 embedding_bag": (lambda x: EB.embedding_bag(
            x, torch.zeros(2, 3, dtype=torch.int32), impl="cuda"), (6, 4)),
    }


@pytest.mark.parametrize("name", list(_wrapper_calls()))
def test_kernel_wrappers_refuse_an_input_that_requires_grad(name):
    call, shape = _wrapper_calls()[name]
    x = torch.rand(shape, generator=torch.Generator().manual_seed(1)).requires_grad_(True)
    with pytest.raises(RuntimeError, match="impl='torch'"):
        call(x)
    with torch.no_grad():                         # no gradient asked for: the kernel path
        call(x)
    call(x.detach())


def test_models_refuse_gradients_through_the_kernels():
    tc = dataclasses.replace(TRD.SMOKE, impl="cuda")
    tp = tdm.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    batch = dict(dense=torch.zeros(2, tc.n_dense), label=torch.ones(2),
                 sparse=torch.zeros(2, tc.n_sparse, 1, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="impl='torch'"):
        TT.value_and_grad(lambda p, b: tdm.loss_fn(tc, p, b), tp, batch)
    lm = dataclasses.replace(TM.SMOKE, impl="cuda")
    params = ttr.init_params(lm, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="impl='torch'"):
        TT.value_and_grad(lambda p, b: ttr.forward(lm, p, b).sum(), params,
                          torch.zeros(1, 4, dtype=torch.int32))
    # the training loss takes the chunked attention, never the kernel
    TT.value_and_grad(lambda p, b: ttr.loss_fn(lm, p, b), params,
                      dict(tokens=torch.zeros(1, 4, dtype=torch.int32),
                           labels=torch.zeros(1, 4, dtype=torch.int32)))
