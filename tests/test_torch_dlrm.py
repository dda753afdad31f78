"""The port's DLRM serve path and its EmbeddingBag against the JAX package,
on the CPU.

EmbeddingBag: the port's plain version and its kernel wrapper (which runs
the plain version on CPU tensors) against the reference's
``embedding_bag_ref`` and its Pallas kernel in interpret mode, at the sweep
shapes of ``tests/test_kernels.py``; the table-batched wrapper and its
plain version against both, table by table, at 1 and 26 tables.  Model: DLRM-RM2 ``SMOKE`` (every width
of RM2, 512 rows a table) with the reference's ``init_params(PRNGKey(0))``
carried across by ``interop``; ``forward``, ``serve_score`` and
``retrieval_score`` against the reference with ``ebag_impl=
'pallas_interpret'``.  Tolerances: atol 1e-5 for the bags (the kernel
sweep's), rtol 1e-5 for the model's scores (float32 products summed in
another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dlrm_rm2 as JR
from repro.kernels.embedding_bag import embedding_bag as embedding_bag_jax
from repro.kernels.embedding_bag import embedding_bag_ref
from repro.models import dlrm as jdm
from repro_torch import interop
from repro_torch.configs import dlrm_rm2 as TR
from repro_torch.kernels import embedding_bag as EB
from repro_torch.models import dlrm as tdm


# =========================================================================
# EmbeddingBag
# =========================================================================
@pytest.mark.parametrize("V,D,Bb,L", [(1000, 32, 64, 8), (257, 16, 33, 3),
                                      (4096, 64, 16, 1)])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_reference(V, D, Bb, L, mode):
    rng = np.random.default_rng(V + D + Bb + L)
    table = rng.normal(size=(V, D)).astype(np.float32)
    idx = rng.integers(-1, V, size=(Bb, L)).astype(np.int32)
    want = np.asarray(embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx), mode))
    kern = np.asarray(embedding_bag_jax(jnp.asarray(table), jnp.asarray(idx), mode=mode,
                                        impl="pallas", interpret=True, block_b=16))
    plain = EB.embedding_bag_plain(torch.from_numpy(table), torch.from_numpy(idx), mode)
    wrapped = EB.embedding_bag(torch.from_numpy(table), torch.from_numpy(idx), mode)
    assert plain.dtype == torch.float32 and tuple(plain.shape) == (Bb, D)
    np.testing.assert_allclose(plain.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(plain.numpy(), kern, atol=1e-5)
    assert torch.equal(wrapped, plain)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_all_padding(mode):
    table = torch.ones(10, 4)
    idx = torch.full((4, 3), -1, dtype=torch.int32)
    want = np.asarray(embedding_bag_jax(jnp.ones((10, 4)), jnp.asarray(idx.numpy()), mode=mode,
                                        impl="pallas", interpret=True, block_b=4))
    got = EB.embedding_bag(table, idx, mode)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, torch.zeros(4, 4))


def test_embedding_bag_skips_indices_past_the_table():
    """Padding (-1) is skipped; an index at or above V is not: it reads row
    V - 1 and is counted, as in the reference."""
    table = torch.arange(12, dtype=torch.float32).view(3, 4)
    idx = torch.tensor([[0, 3, -1], [2, 2, 7]], dtype=torch.int32)
    got = EB.embedding_bag(table, idx, "mean")
    assert torch.equal(got, torch.stack([(table[0] + table[2]) / 2, table[2]]))


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_past_the_table_departs_from_reference(mode):
    """An index at or above V: the port equals the reference and its Pallas
    kernel, which clamp it to row V - 1 and count it."""
    table = np.arange(12, dtype=np.float32).reshape(3, 4)
    idx = np.array([[0, 3, -1, 1], [2, 2, 7, -1]], np.int32)
    as_last = np.where(idx >= table.shape[0], table.shape[0] - 1, idx)
    ref = lambda i: np.asarray(embedding_bag_ref(jnp.asarray(table), jnp.asarray(i), mode))
    pallas = np.asarray(embedding_bag_jax(jnp.asarray(table), jnp.asarray(idx), mode=mode,
                                          impl="pallas", interpret=True, block_b=2))
    np.testing.assert_array_equal(ref(idx), ref(as_last))
    np.testing.assert_array_equal(pallas, ref(idx))
    for fn in (EB.embedding_bag, EB.embedding_bag_plain):
        got = fn(torch.from_numpy(table), torch.from_numpy(idx), mode).numpy()
        np.testing.assert_array_equal(got, ref(idx))


@pytest.mark.parametrize("F", [1, 26])
@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bags_match_reference_table_by_table(F, L, mode):
    """Every table its own V, indices up to 4 past each V (clamped to that
    table's last row and counted) and padding (-1; bag 0 all padding): each
    table's bags equal ``embedding_bag_ref`` and the Pallas kernel in
    interpret mode on that table; the wrapper equals the plain version, and
    with ``out=`` it fills a slice of a NaN-poisoned buffer and nothing
    else."""
    rng = np.random.default_rng(100 * F + L)
    D, Bb = 16, 24
    vocabs = rng.integers(1, 200, size=F)
    tables = [rng.normal(size=(v, D)).astype(np.float32) for v in vocabs]
    idx = np.stack([rng.integers(-1, v + 5, size=(Bb, L)) for v in vocabs], axis=1)
    idx = idx.astype(np.int32)
    idx[0] = -1
    tt = [torch.from_numpy(t) for t in tables]
    plain = EB.embedding_bags_plain(tt, torch.from_numpy(idx), mode)
    assert plain.dtype == torch.float32 and tuple(plain.shape) == (Bb, F, D)
    for f, table in enumerate(tables):
        want = np.asarray(embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx[:, f]), mode))
        kern = np.asarray(embedding_bag_jax(jnp.asarray(table), jnp.asarray(idx[:, f]),
                                            mode=mode, impl="pallas", interpret=True,
                                            block_b=8))
        np.testing.assert_allclose(plain[:, f].numpy(), want, atol=1e-5)
        np.testing.assert_allclose(plain[:, f].numpy(), kern, atol=1e-5)
        assert torch.equal(plain[:, f], EB.embedding_bag(tt[f], torch.from_numpy(idx[:, f])
                                                         .contiguous(), mode))
    assert torch.equal(EB.embedding_bags(tt, torch.from_numpy(idx), mode), plain)
    buf = torch.full((Bb, F + 2, D), float("nan"))
    got = EB.embedding_bags(tt, torch.from_numpy(idx), mode, out=buf[:, 1:F + 1])
    assert got.data_ptr() == buf[:, 1:].data_ptr() and torch.equal(got, plain)
    assert bool(torch.isnan(buf[:, 0]).all() and torch.isnan(buf[:, F + 1]).all())


def test_embedding_bags_want_one_table_a_column():
    tables = [torch.ones(3, 4)] * 2
    with pytest.raises(ValueError):
        EB.embedding_bags(tables, torch.zeros(2, 3, 1, dtype=torch.int32))
    with pytest.raises(ValueError):
        EB.embedding_bags(tables, torch.zeros(2, 2, 1, dtype=torch.int32), "max")


def test_embedding_bag_rejects_unknown_mode_and_impl():
    table, idx = torch.ones(3, 4), torch.zeros(2, 1, dtype=torch.int32)
    with pytest.raises(ValueError):
        EB.embedding_bag(table, idx, "max")
    with pytest.raises(ValueError):
        EB.embedding_bag(table, idx, impl="xla")


# =========================================================================
# the model
# =========================================================================
B = 16


@pytest.fixture(scope="module")
def model():
    jc = dataclasses.replace(JR.SMOKE, ebag_impl="pallas_interpret")
    jp = jdm.init_params(jc, jax.random.PRNGKey(0))
    tp = interop.dlrm_params_from_arrays(TR.SMOKE, jax.tree_util.tree_map(np.asarray, jp),
                                         device="cpu")
    rng = np.random.default_rng(4)
    dense = rng.normal(size=(B, jc.n_dense)).astype(np.float32)
    sparse = rng.integers(0, 512, size=(B, jc.n_sparse, jc.multi_hot)).astype(np.int32)
    cand = rng.normal(size=(4096, jc.embed_dim)).astype(np.float32)
    return dict(jc=jc, jp=jp, tc=TR.SMOKE, tp=tp, dense=dense, sparse=sparse, cand=cand)


def test_configs_match_reference():
    for jc, tc in ((JR.CONFIG, TR.CONFIG), (JR.SMOKE, TR.SMOKE)):
        assert tc.param_count() == jc.param_count()
        assert tc.vocabs() == jc.vocabs()
        assert tc.interaction_dim() == jc.interaction_dim()
        for f in ("n_dense", "n_sparse", "embed_dim", "bot_mlp", "top_mlp", "multi_hot"):
            assert tuple(np.atleast_1d(getattr(tc, f))) == tuple(np.atleast_1d(getattr(jc, f))), f
    assert TR.SHAPES == JR.SHAPES
    assert TR.CONFIG.vocabs() == [1_000_000] * 26


def test_forward_matches_reference(model):
    want = np.asarray(jdm.forward(model["jc"], model["jp"], jnp.asarray(model["dense"]),
                                  jnp.asarray(model["sparse"])))
    got = tdm.forward(model["tc"], model["tp"], torch.from_numpy(model["dense"]),
                      torch.from_numpy(model["sparse"]))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_serve_score_matches_reference(model):
    want = np.asarray(jdm.serve_score(model["jc"], model["jp"], jnp.asarray(model["dense"]),
                                      jnp.asarray(model["sparse"])))
    got = tdm.serve_score(model["tc"], model["tp"], torch.from_numpy(model["dense"]),
                          torch.from_numpy(model["sparse"]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("top_k", [1, 128])
def test_retrieval_score_matches_reference(model, top_k):
    args = (model["dense"][:1], model["sparse"][:1], model["cand"])
    wv, wi = jdm.retrieval_score(model["jc"], model["jp"], *map(jnp.asarray, args), top_k=top_k)
    gv, gi = tdm.retrieval_score(model["tc"], model["tp"], *map(torch.from_numpy, args),
                                 top_k=top_k)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_user_tower_matches_reference(model):
    want = np.asarray(jdm.forward_user_tower(model["jc"], model["jp"],
                                             jnp.asarray(model["dense"]),
                                             jnp.asarray(model["sparse"])))
    got = tdm.forward_user_tower(model["tc"], model["tp"], torch.from_numpy(model["dense"]),
                                 torch.from_numpy(model["sparse"]))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_multi_hot_bags_with_padding_match_reference():
    """Three lookups a field, a quarter of them padding: the bags' sums
    reach the interaction as in the reference."""
    jc = dataclasses.replace(JR.SMOKE, multi_hot=3, ebag_impl="pallas_interpret")
    tc = dataclasses.replace(TR.SMOKE, multi_hot=3)
    jp = jdm.init_params(jc, jax.random.PRNGKey(1))
    tp = interop.dlrm_params_from_arrays(tc, jax.tree_util.tree_map(np.asarray, jp),
                                         device="cpu")
    rng = np.random.default_rng(8)
    dense = rng.normal(size=(8, jc.n_dense)).astype(np.float32)
    sparse = rng.integers(0, 512, size=(8, jc.n_sparse, 3)).astype(np.int32)
    sparse[rng.random(sparse.shape) < 0.25] = -1
    want = np.asarray(jdm.serve_score(jc, jp, jnp.asarray(dense), jnp.asarray(sparse)))
    got = tdm.serve_score(tc, tp, torch.from_numpy(dense), torch.from_numpy(sparse))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_impls_agree_on_cpu(model):
    args = (torch.from_numpy(model["dense"]), torch.from_numpy(model["sparse"]))
    a = tdm.serve_score(model["tc"], model["tp"], *args)
    b = tdm.serve_score(dataclasses.replace(model["tc"], impl="torch"), model["tp"], *args)
    assert torch.equal(a, b)


def test_init_params_shapes_and_default_device():
    p = tdm.init_params(TR.SMOKE, torch.Generator().manual_seed(0), device="cpu")
    shapes = jax.eval_shape(lambda k: jdm.init_params(JR.SMOKE, k), jax.random.PRNGKey(0))
    assert [tuple(t.shape) for t in p["tables"]] == [s.shape for s in shapes["tables"]]
    for part in ("bot", "top"):
        for got, want in zip(p[part], shapes[part]):
            assert tuple(got["w"].shape) == want["w"].shape
            assert tuple(got["b"].shape) == want["b"].shape
    assert abs(float(p["tables"][0].std()) - 512 ** -0.25) < 0.05 * 512 ** -0.25
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdm.init_params(TR.SMOKE, torch.Generator())
