"""The port's GNN inference path and its kernels' plain versions against the
JAX package, on the CPU.

Segment-sum (B5): the port's ``bucket_scatter`` (its plain version; the
kernel wrapper runs it on CPU tensors) against the reference's
``bucket_scatter_ref`` and its Pallas kernel in interpret mode, at the
sweep of ``tests/test_kernels.py`` and its tolerances (1e-4 in float32,
5e-2 in bfloat16), plus C = 1, 3 and 75 and empty segments.  TimeWarp
(B6): ``interval_warp`` equal to the Pallas kernel in interpret mode
(``np.array_equal``), and to ``interval_warp_ref`` with NaN, infinities and
-0.0 among the counts.

Models: PNA, EGNN, MeshGraphNet and SchNet at ``SMOKE`` (every published
width, 2 layers) and at ``CONFIG``, with parameters in the tree of the
reference's ``INIT[arch]`` (drawn with numpy) carried across by ``interop``, on
``gnn_smoke``'s graph (40 nodes, 120 unsorted edges, 4 graphs) and on a
union graph sampled from a small CSR by the reference's sampler.  Tolerance
1e-5 of the largest |output| (float32 matrix products and sums in another
order; measured at most 5.7e-7), and 2e-4 for PNA (measured up to
5.7e-5): where a node's messages are all equal (a degree-0 node's
self-loops, one neighbour drawn every time) its std,
sqrt(max(E[x^2] - mean^2, 1e-8)), is the square root of a float32
cancellation, so the summation order moves it by up to ~3e-4 |x|.

Sampler: the port's own draws differ from threefry, so it is checked by
structure: local ids and ``block_shapes`` equal the reference's, every
sampled neighbour is a CSR neighbour, a degree-0 node loops to itself, and
the destinations come out sorted."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import egnn as JE
from repro.configs import meshgraphnet as JM
from repro.configs import pna as JP
from repro.configs import schnet as JS
from repro.configs.common import GNN_SHAPES
from repro.core.intervals import bucket_edges
from repro.graphdata import sampler as jsm
from repro.kernels.bucket_scatter import bucket_scatter as bucket_scatter_jax
from repro.kernels.bucket_scatter import bucket_scatter_ref
from repro.kernels.bucket_scatter.ops import build_layout as build_layout_jax
from repro.kernels.interval_warp import interval_warp as interval_warp_jax
from repro.kernels.interval_warp import interval_warp_ref
from repro.models import gnn as jg
from repro_torch import interop
from repro_torch.configs import egnn as TE
from repro_torch.configs import meshgraphnet as TM
from repro_torch.configs import pna as TP
from repro_torch.configs import schnet as TS
from repro_torch.graphdata import sampler as tsm
from repro_torch.kernels import bucket_scatter as BS
from repro_torch.kernels import interval_warp as IW
from repro_torch.models import gnn as tg

ARCHS = {"pna": (JP, TP), "egnn": (JE, TE), "meshgraphnet": (JM, TM), "schnet": (JS, TS)}
DEPTH = {"pna": "n_layers", "egnn": "n_layers", "meshgraphnet": "n_layers",
         "schnet": "n_interactions"}
TOL = {"pna": 2e-4, "egnn": 1e-5, "meshgraphnet": 1e-5, "schnet": 1e-5}


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


# =========================================================================
# B5 segment-sum
# =========================================================================
@pytest.mark.parametrize("E,V,C", [(1000, 100, 8), (5000, 700, 16), (300, 512, 4),
                                   (2000, 300, 1), (2000, 300, 3), (1500, 200, 75)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bucket_scatter_matches_reference(E, V, C, dtype):
    rng = np.random.default_rng(E + V + C)
    seg = np.sort(rng.integers(0, V, size=E)).astype(np.int32)
    vals = rng.normal(size=(E, C)).astype(np.float32)
    jc = jnp.asarray(vals).astype(dtype)
    want = _f32(bucket_scatter_ref(jc, jnp.asarray(seg), V))
    lay = build_layout_jax(seg, V, block_v=128, block_e_mult=128)
    kern = _f32(bucket_scatter_jax(jc, jnp.asarray(seg), V, layout=lay, impl="pallas",
                                   interpret=True))
    tc = torch.from_numpy(vals).to(getattr(torch, dtype))
    ts = torch.from_numpy(seg)
    plain = BS.bucket_scatter_plain(tc, ts, V)
    got = BS.bucket_scatter(tc, ts, V, layout=BS.build_layout(ts, V))
    assert plain.dtype == tc.dtype and tuple(plain.shape) == (V, C)
    assert torch.equal(got, plain)
    tol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(plain.float().numpy(), want, atol=tol, rtol=tol)
    np.testing.assert_allclose(plain.float().numpy(), kern, atol=tol, rtol=tol)


def test_bucket_scatter_empty_segments():
    seg = np.asarray([3, 3, 9], np.int32)
    want = np.asarray(bucket_scatter_jax(jnp.ones((3, 2)), jnp.asarray(seg), 16,
                                         layout=build_layout_jax(seg, 16, 8, 8),
                                         impl="pallas", interpret=True))
    got = BS.bucket_scatter(torch.ones(3, 2), torch.from_numpy(seg), 16)
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got[3, 0]) == 2 and float(got[9, 1]) == 1 and float(got.sum()) == 6


def test_build_layout_is_the_csr_pointer():
    seg = torch.tensor([0, 0, 2, 2, 2, 5], dtype=torch.int32)
    lay = BS.build_layout(seg, 7)
    assert lay.ptr.dtype == torch.int64 and (lay.n_edges, lay.num_segments) == (6, 7)
    assert lay.ptr.tolist() == [0, 2, 2, 5, 5, 5, 6, 6]
    assert BS.build_layout(seg[:0], 3).ptr.tolist() == [0, 0, 0, 0]
    with pytest.raises(ValueError):
        BS.build_layout(torch.tensor([1, 0], dtype=torch.int32), 3)
    with pytest.raises(ValueError):
        BS.build_layout(seg, 5)                    # an id past num_segments


def test_bucket_scatter_rejects_unknown_impl_and_leaves_counter_on_cpu():
    n0 = BS.LAUNCHES["bucket_scatter"]
    BS.bucket_scatter(torch.ones(2, 3), torch.zeros(2, dtype=torch.int32), 1)
    assert BS.LAUNCHES["bucket_scatter"] == n0
    with pytest.raises(ValueError):
        BS.bucket_scatter(torch.ones(2, 3), torch.zeros(2, dtype=torch.int32), 1, impl="xla")


# =========================================================================
# B6 TimeWarp
# =========================================================================
def _warp_inputs(rng, N, B):
    ivl = np.stack([rng.integers(0, 500, N), rng.integers(0, 1100, N)], 1).astype(np.int32)
    return ivl, np.asarray(bucket_edges(0, 1096, B), np.int32)


@pytest.mark.parametrize("N,B", [(512, 8), (3000, 16), (100, 32)])
def test_interval_warp_matches_pallas_kernel(N, B):
    rng = np.random.default_rng(N + B)
    cnts = rng.normal(size=(N, B)).astype(np.float32)
    ivl, be = _warp_inputs(rng, N, B)
    want = np.asarray(interval_warp_jax(jnp.asarray(cnts), jnp.asarray(ivl), jnp.asarray(be),
                                        impl="pallas", interpret=True, block_n=256))
    args = (torch.from_numpy(cnts), torch.from_numpy(ivl), torch.from_numpy(be))
    got = IW.interval_warp(*args)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, IW.interval_warp_plain(*args))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_interval_warp_special_values_match_reference(dtype):
    """A multiply, not a select, as ``interval_warp_ref``: 0 x inf is NaN,
    0 x -x is -0.0, NaN stays.  (The Pallas kernel in interpret mode gives
    0 there, as if it selected; on finite counts it equals both.)"""
    rng = np.random.default_rng(7)
    N, B = 64, 16
    cnts = rng.normal(size=(N, B)).astype(np.float32)
    cnts[rng.random((N, B)) < 0.1] = np.nan
    cnts[rng.random((N, B)) < 0.1] = np.inf
    cnts[rng.random((N, B)) < 0.1] = -np.inf
    cnts[rng.random((N, B)) < 0.1] = -0.0
    ivl, be = _warp_inputs(rng, N, B)
    jc = jnp.asarray(cnts).astype(dtype)
    want = _f32(interval_warp_ref(jc, jnp.asarray(ivl), jnp.asarray(be)))
    got = IW.interval_warp(torch.from_numpy(cnts).to(getattr(torch, dtype)),
                           torch.from_numpy(ivl), torch.from_numpy(be)).float().numpy()
    np.testing.assert_array_equal(got, want)                 # NaN where NaN
    num = ~np.isnan(want)
    np.testing.assert_array_equal(np.signbit(got[num]), np.signbit(want[num]))
    assert np.isnan(got).sum() > (np.isnan(cnts)).sum()     # some 0 x inf
    if dtype == "float32":
        kern = np.asarray(interval_warp_jax(jc, jnp.asarray(ivl), jnp.asarray(be),
                                            impl="pallas", interpret=True, block_n=64))
        fin = np.isfinite(cnts)
        np.testing.assert_array_equal(got[fin], kern[fin])


# =========================================================================
# the models
# =========================================================================
@functools.lru_cache(maxsize=None)
def _smoke_graph(edge_feat: bool = False):
    """configs/common.py::gnn_smoke's graph (N 40, E 120, F 8, 4 graphs)."""
    rng = np.random.default_rng(0)
    N, E, F = 40, 120, 8
    arrays = dict(node_feat=rng.normal(size=(N, F)).astype(np.float32),
                  edge_src=rng.integers(0, N, E).astype(np.int32),
                  edge_dst=rng.integers(0, N, E).astype(np.int32),
                  coords=rng.normal(size=(N, 3)).astype(np.float32),
                  graph_of=rng.integers(0, 4, N).astype(np.int32),
                  targets=rng.normal(size=(N, 1)).astype(np.float32))
    if edge_feat:
        arrays["edge_feat"] = rng.normal(size=(E, 4)).astype(np.float32)
    return arrays, 4


@functools.lru_cache(maxsize=None)
def _union_graph(n_nodes=60, n_edges=400, F=12, seeds=6, fanouts=(4, 3)):
    """A union graph from the reference's sampler over a small CSR with a
    few degree-0 nodes."""
    rng = np.random.default_rng(3)
    src = rng.integers(0, n_nodes - 5, n_edges)          # the last 5 nodes have no edge
    dst = rng.integers(0, n_nodes, n_edges)
    csr = jsm.CSR.from_edge_index(src, dst, n_nodes)
    seed_ids = jnp.asarray(np.r_[rng.choice(n_nodes - 5, seeds - 1, replace=False),
                                 n_nodes - 1].astype(np.int32))
    sample = jax.jit(lambda s, k: jsm.sample_union_graph(csr, s, fanouts, k))
    gids, s, d = (np.array(a) for a in sample(seed_ids, jax.random.PRNGKey(5)))
    feats = rng.normal(size=(n_nodes, F)).astype(np.float32)
    x = feats[gids]
    return dict(node_feat=x, edge_src=s, edge_dst=d, coords=x[:, :3].copy()), 1


GRAPHS = {"smoke": _smoke_graph, "union": _union_graph,
          "smoke_edge_feat": lambda: _smoke_graph(edge_feat=True)}


def _apply(mod, arch, cfg, params, g):
    fn = {"pna": mod.pna_apply, "egnn": mod.egnn_apply, "meshgraphnet": mod.mgn_apply,
          "schnet": mod.schnet_apply}[arch]
    out = fn(cfg, params, g)
    return out if isinstance(out, tuple) else (out,)


def _params(arch, cfg, in_dim):
    """Parameters in the tree of the reference's ``INIT[arch]``, drawn with
    numpy: weights Normal(0, 1) / sqrt(fan_in), biases and norm scales
    perturbed so that none is 0 or 1."""
    rng = np.random.default_rng(len(arch))
    shapes = jax.eval_shape(lambda k: jg.INIT[arch](cfg, k, in_dim), jax.random.PRNGKey(0))

    def draw(sd):
        x = rng.normal(size=sd.shape).astype(np.float32)
        return jnp.asarray(x / np.sqrt(sd.shape[0]) if len(sd.shape) == 2 else 0.1 * x)

    return jax.tree_util.tree_map(draw, shapes)


@functools.lru_cache(maxsize=None)
def _reference(arch, graph, smoke):
    """The reference's parameters (numpy), outputs and loss, under jit."""
    jmod, tmod = ARCHS[arch]
    jc = jmod.CONFIG
    if smoke:
        jc = dataclasses.replace(jc, **{DEPTH[arch]: getattr(tmod.SMOKE, DEPTH[arch])})
    arrays, n_graphs = GRAPHS[graph]()
    jp = _params(arch, jc, arrays["node_feat"].shape[1])

    def run(p, a):
        gb = jg.GraphBatch(**a, n_graphs=n_graphs)
        loss = jg.gnn_loss(arch, jc, p, gb) if "targets" in a else None
        return _apply(jg, arch, jc, p, gb), loss

    outs, loss = jax.jit(run)(jp, {k: jnp.asarray(v) for k, v in arrays.items()})
    return (jax.tree_util.tree_map(np.asarray, jp), [np.asarray(o) for o in outs],
            None if loss is None else float(loss))


def _check_arch(arch, graph, impl, smoke=True):
    _, tmod = ARCHS[arch]
    tc = dataclasses.replace(tmod.SMOKE if smoke else tmod.CONFIG, impl=impl)
    arrays, n_graphs = GRAPHS[graph]()
    tree, wants, loss = _reference(arch, graph, smoke)
    tp = interop.gnn_params_from_arrays(arch, tree, device="cpu")
    tgb = tg.GraphBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                        n_graphs=n_graphs)
    gots = _apply(tg, arch, tc, tp, tgb)
    for got, want in zip(gots, wants):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        assert np.isfinite(want).all()
        scale = max(float(np.abs(want).max()), 1.0)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL[arch] * scale, rtol=0)
    if loss is not None:
        np.testing.assert_allclose(float(tg.gnn_loss(arch, tc, tp, tgb)), loss, rtol=1e-5)
    return gots


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_smoke_graph_matches_reference(arch, impl):
    _check_arch(arch, "smoke", impl)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_union_graph_matches_reference(arch, impl):
    _check_arch(arch, "union", impl)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_published_config_matches_reference(arch):
    _check_arch(arch, "smoke", "cuda", smoke=False)


def test_meshgraphnet_edge_features_follow_the_sort():
    """Given edge features on unsorted edges, the port permutes them with
    the edges; the output equals the reference's."""
    _check_arch("meshgraphnet", "smoke_edge_feat", "cuda")


def test_impls_agree_on_cpu():
    for arch in ARCHS:
        a = _check_arch(arch, "union", "cuda")
        b = _check_arch(arch, "union", "torch")
        assert all(torch.equal(x, y) for x, y in zip(a, b)), arch


def test_graph_batch_sorts_edges_stably():
    arrays, _ = _smoke_graph(edge_feat=True)
    g = tg.GraphBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    order = np.argsort(arrays["edge_dst"], kind="stable")
    for f in ("edge_src", "edge_dst", "edge_feat"):
        np.testing.assert_array_equal(getattr(g, f).numpy(), arrays[f][order])
    counts = np.bincount(arrays["edge_dst"], minlength=40)
    np.testing.assert_array_equal(g.layout.ptr.numpy(), np.r_[0, np.cumsum(counts)])


def test_configs_match_reference():
    for arch, (jmod, tmod) in ARCHS.items():
        for f in dataclasses.fields(jmod.CONFIG):
            assert getattr(tmod.CONFIG, f.name) == getattr(jmod.CONFIG, f.name), (arch, f.name)
        assert tmod.SMOKE == dataclasses.replace(tmod.CONFIG, **{DEPTH[arch]: 2})
        assert tmod.SHAPES == GNN_SHAPES


@pytest.mark.parametrize("arch", list(ARCHS))
def test_init_shapes_and_default_device(arch):
    jmod, tmod = ARCHS[arch]
    shapes = jax.eval_shape(lambda k: jg.INIT[arch](jmod.CONFIG, k, 602), jax.random.PRNGKey(0))
    p = tg.INIT[arch](tmod.CONFIG, torch.Generator().manual_seed(0), 602, device="cpu")
    got = jax.tree_util.tree_map(lambda t: tuple(t.shape), p, is_leaf=torch.is_tensor)
    want = jax.tree_util.tree_map(lambda s: tuple(s.shape), shapes)
    assert got == want
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tg.INIT[arch](tmod.CONFIG, torch.Generator(), 602)


def test_gnn_params_from_arrays_checks_the_tree():
    tree = jax.tree_util.tree_map(np.asarray, _params("egnn", JE.CONFIG, 8))
    got = interop.gnn_params_from_arrays("egnn", tree, device="cpu")
    np.testing.assert_array_equal(got["layers"][1]["phi_x"][0]["w"].numpy(),
                                  tree["layers"][1]["phi_x"][0]["w"])
    with pytest.raises(ValueError):
        interop.gnn_params_from_arrays("pna", {"encoder": tree["encoder"]}, device="cpu")
    with pytest.raises(ValueError):
        interop.gnn_params_from_arrays("gcn", tree, device="cpu")


# =========================================================================
# the sampler
# =========================================================================
def _small_csr():
    rng = np.random.default_rng(11)
    n, e = 80, 600
    src = rng.integers(0, n - 6, e)                      # 6 nodes of degree 0
    dst = rng.integers(0, n, e)
    return src, dst, n


def test_csr_matches_reference():
    src, dst, n = _small_csr()
    want = jsm.CSR.from_edge_index(src, dst, n)
    got = tsm.CSR.from_edge_index(src, dst, n, device="cpu")
    assert got.indptr.dtype == torch.int32 and got.indices.dtype == torch.int32
    np.testing.assert_array_equal(got.indptr.numpy(), np.asarray(want.indptr))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsm.CSR.from_edge_index(src, dst, n)


def _neighbour_sets(csr):
    ptr, idx = csr.indptr.numpy(), csr.indices.numpy()
    return [set(idx[ptr[v]:ptr[v + 1]].tolist()) for v in range(len(ptr) - 1)]


@pytest.mark.parametrize("fanouts", [(15, 10), (4, 3, 2)])
def test_union_graph_structure_matches_reference(fanouts):
    src, dst, n = _small_csr()
    jcsr = jsm.CSR.from_edge_index(src, dst, n)
    csr = tsm.CSR.from_edge_index(src, dst, n, device="cpu")
    seeds = np.r_[np.arange(0, 70, 9), n - 1, n - 2].astype(np.int32)   # 2 of degree 0
    sample = jax.jit(lambda s, k: jsm.sample_union_graph(jcsr, s, fanouts, k))
    jg_ids, js, jd = sample(jnp.asarray(seeds), jax.random.PRNGKey(0))
    gids, s, d = tsm.sample_union_graph(csr, torch.from_numpy(seeds), fanouts,
                                        torch.Generator().manual_seed(0))
    assert gids.shape == jg_ids.shape and gids.dtype == torch.int32
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert bool((d[1:] >= d[:-1]).all())
    np.testing.assert_array_equal(gids[: len(seeds)].numpy(), seeds)
    nbrs = _neighbour_sets(csr)
    g = gids.numpy()
    for e_src, e_dst in zip(s.numpy(), d.numpy()):
        target, sampled = int(g[e_dst]), int(g[e_src])
        if nbrs[target]:
            assert sampled in nbrs[target]
        else:
            assert sampled == target                       # degree 0 loops to itself
    assert tsm.block_shapes(len(seeds), fanouts) == jsm.block_shapes(len(seeds), fanouts)
    assert tsm.block_shapes(1024, (15, 10)) == [(153600, 15360), (15360, 1024)]


def test_sample_neighbors_and_subgraph():
    src, dst, n = _small_csr()
    csr = tsm.CSR.from_edge_index(src, dst, n, device="cpu")
    gen = torch.Generator().manual_seed(1)
    frontier = torch.arange(n, dtype=torch.int32)
    nbr = tsm.sample_neighbors(csr, frontier, 8, gen)
    assert nbr.shape == (n, 8) and nbr.dtype == torch.int32
    nbrs = _neighbour_sets(csr)
    for v in range(n):
        want = nbrs[v] or {v}
        assert set(nbr[v].tolist()) <= want
    assert set(tsm.sample_neighbors(csr, frontier[:10], 200, gen)[0].tolist()) == nbrs[0]
    sub = tsm.sample_subgraph(csr, frontier[:5], (3, 2), gen)
    assert [tuple(b.src.shape) for b in sub.layers] == [(30,), (15,)]
    np.testing.assert_array_equal(sub.layers[1].dst.numpy(), np.repeat(np.arange(5), 3))
    assert sub.nodes.shape == (5 + 15 + 30,)
