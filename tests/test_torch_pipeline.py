"""The port's GPipe schedule against sequential layers and the JAX package,
on the CPU.

One stage (no process group): the schedule equals the layers applied in
order to each microbatch and the reference's ``make_pipelined_forward`` on
its one-device mesh (atol 1e-5, the reference test's).  The schedule's
length and bubble equal the reference's arithmetic (n_micro + n_stages − 1
ticks, (n_stages − 1) / ticks idle).  Two and four gloo ranks as stages
(``tests/torch_train_dist_leg.py``, ``tcp://localhost:<free port>``, 90 s
bound): the last stage's outputs equal the sequential forward, and every
rank returns the losses summed on the last stage.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_dist_leg
from repro.training.pipeline import PipelineCfg as JPipelineCfg
from repro.training.pipeline import make_pipelined_forward as jax_pipelined_forward
from repro_torch.training import pipeline as TPL


def _problem(L, D, n_micro, B=2, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(L, D, D)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(L, D)) * 0.1).astype(np.float32)
    x = rng.normal(size=(n_micro, B, D)).astype(np.float32)
    return w, b, x


def _sequential(w, b, x):
    h = torch.from_numpy(x)
    for i in range(w.shape[0]):
        h = torch.tanh(h @ torch.from_numpy(w[i]) + torch.from_numpy(b[i]))
    return h.numpy()


@pytest.mark.parametrize("L,n_micro", [(4, 3), (1, 1), (6, 5)])
def test_one_stage_equals_sequential_and_reference(L, n_micro):
    w, b, x = _problem(L, 8, n_micro)
    fwd = TPL.make_pipelined_forward(torch_train_dist_leg.tanh_layer, 1,
                                     TPL.PipelineCfg(n_microbatches=n_micro))
    got = fwd(dict(w=torch.from_numpy(w), b=torch.from_numpy(b)), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _sequential(w, b, x), atol=1e-6, rtol=0)
    mesh = jax.make_mesh((1,), ("data",))
    layer = lambda lp, h: jnp.tanh(h @ lp["w"] + lp["b"])
    with mesh:
        jfwd = jax_pipelined_forward(layer, 1, JPipelineCfg(axis="data", n_microbatches=n_micro),
                                     mesh)
        want = np.asarray(jfwd(dict(w=jnp.asarray(w), b=jnp.asarray(b)), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n_stages,n_micro", [(4, 8), (16, 32), (2, 3), (1, 8), (8, 1)])
def test_bubble_arithmetic_matches_reference(n_stages, n_micro):
    ticks = n_micro + n_stages - 1          # the reference's fori_loop length
    assert TPL.schedule_ticks(n_stages, n_micro) == ticks
    assert TPL.bubble_fraction(n_stages, n_micro) == (n_stages - 1) / ticks


def test_schedule_checks_its_shapes():
    w, b, x = _problem(3, 4, 2)
    params = dict(w=torch.from_numpy(w), b=torch.from_numpy(b))
    with pytest.raises(ValueError, match="stages"):
        TPL.make_pipelined_forward(torch_train_dist_leg.tanh_layer, 2,
                                   TPL.PipelineCfg(n_microbatches=2))(params, torch.from_numpy(x))
    with pytest.raises(ValueError, match="microbatches"):
        TPL.make_pipelined_forward(torch_train_dist_leg.tanh_layer, 1,
                                   TPL.PipelineCfg(n_microbatches=5))(params, torch.from_numpy(x))


def test_one_stage_loss_sums_the_microbatches():
    w, b, x = _problem(2, 4, 3)
    out = torch.from_numpy(_sequential(w, b, x))
    tgt = torch.zeros_like(out)
    loss = TPL.pipeline_loss(out, tgt, lambda y, t: ((y - t) ** 2).mean(), 1)
    torch.testing.assert_close(loss, sum(((out[m]) ** 2).mean() for m in range(3)))


@pytest.mark.parametrize("world,L,n_micro", [(2, 4, 3), (4, 8, 6)])
def test_gloo_stages_equal_the_sequential_forward(world, L, n_micro):
    w, b, x = _problem(L, 8, n_micro, seed=world)
    targets = np.zeros_like(x)
    answers = torch_train_dist_leg.run_ranks(torch_train_dist_leg.pipe_rank_main, world,
                                             w, b, x, targets, n_answers=world)
    by_rank = {a["rank"]: a for a in answers}
    want = _sequential(w, b, x)
    last = by_rank[world - 1]
    np.testing.assert_allclose(last["out"], want, atol=1e-6, rtol=0)
    want_loss = sum(float((want[m] ** 2).mean()) for m in range(n_micro))
    for a in answers:                        # psum'd: every stage has the last stage's sum
        assert a["loss"] == last["loss"]
        if a["rank"] != world - 1:
            assert not a["out"].any()        # only the last stage keeps outputs
    np.testing.assert_allclose(last["loss"], want_loss, rtol=1e-6)
