"""The port's checkpoints and fault recovery against the JAX package, on the
CPU.

Checkpoints: the cases of ``tests/test_checkpoint_fault.py`` (round trip,
corruption detected, retention, async) in the port; the same state written
by both packages gives the same manifest and the same ``.npy`` bytes, bf16
leaves included (raw 2-byte words under descr ``'<V2'``); a checkpoint the
JAX package wrote restores in the port bit for bit, and one the port wrote
restores in the JAX package.  Fault layer: heartbeats, stragglers,
``elastic_remesh`` and ``FaultTolerantRunner`` make the reference's
decisions on the same inputs.  ``launch/train.py`` prints the reference's
lines, fresh and resumed.
"""
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import minicpm_2b as JM
from repro.models import transformer as jtr
from repro.training import checkpoint as jck
from repro.training import fault as jfault
from repro.training import optimizer as JO
from repro_torch import interop
from repro_torch.configs import minicpm_2b as TM
from repro_torch.training import checkpoint as ck
from repro_torch.training import fault as tfault
from repro_torch.training import tree as T

ROOT = Path(__file__).resolve().parents[1]


def _state():
    return dict(w=torch.arange(12.0).reshape(3, 4), step=torch.tensor(7, dtype=torch.int32),
                nested=dict(b=torch.ones(5)))


def test_save_restore_roundtrip(tmp_path):
    s = _state()
    ck.save(s, 10, str(tmp_path))
    got, step = ck.restore(s, str(tmp_path), device="cpu")
    assert step == 10
    for (p, a), b in zip(T.leaves_with_paths(got), T.leaves(s)):
        assert a.dtype == b.dtype and torch.equal(a, b), p


def test_corruption_detected(tmp_path):
    s = _state()
    path = ck.save(s, 1, str(tmp_path))
    f = sorted(Path(path).glob("arr_*.npy"))[0]
    np.save(f, np.load(f) + 1000)
    with pytest.raises(IOError):
        ck.restore(s, str(tmp_path), device="cpu")


def test_gc_keeps_last(tmp_path):
    s = _state()
    for i in range(6):
        ck.save(s, i, str(tmp_path), keep_last=2)
    assert ck.latest_step(str(tmp_path)) == 5
    assert sorted(d for d in os.listdir(tmp_path) if d.startswith("step_")) == ["step_4",
                                                                                "step_5"]


def test_async_save_snapshots_the_state(tmp_path):
    s = _state()
    ck.save_async(s, 3, str(tmp_path))
    s["w"].add_(100)                       # an in-place update after the call
    ck.wait_pending()
    assert ck.latest_step(str(tmp_path)) == 3
    got, _ = ck.restore(s, str(tmp_path), device="cpu")
    assert torch.equal(got["w"], torch.arange(12.0).reshape(3, 4))


def test_async_save_error_raises_in_wait_pending(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck.save_async(_state(), 1, str(blocker))
    with pytest.raises(OSError):
        ck.wait_pending()
    ck.wait_pending()                      # nothing left pending


def test_restore_checks_the_tree_and_places_leaves(tmp_path):
    s = _state()
    ck.save(s, 2, str(tmp_path))
    with pytest.raises(ValueError, match="other leaves"):
        ck.restore(dict(w=s["w"], step=s["step"]), str(tmp_path), device="cpu")
    like = T.tree_map(lambda t: t.numpy(), s)          # any leaves: the structure counts
    got, step = ck.restore(like, str(tmp_path), device="cpu")
    assert step == 2 and got["w"].device.type == "cpu" and torch.equal(got["w"], s["w"])
    if not torch.cuda.is_available():                  # no GPU: the default device raises
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ck.restore(s, str(tmp_path))
    with pytest.raises(FileNotFoundError):
        ck.restore(s, str(tmp_path / "empty"), device="cpu")


# =========================================================================
# one format for both packages
# =========================================================================
@pytest.fixture(scope="module")
def train_state():
    """minicpm-2b SMOKE in bf16 and an AdamW state one step in, as the JAX
    tree and the port's tree of the same values."""
    jc = dataclasses.replace(JM.SMOKE, dtype=jnp.bfloat16)
    tc = dataclasses.replace(TM.SMOKE, dtype=torch.bfloat16)
    jp = jax.jit(lambda k: jtr.init_params(jc, k))(jax.random.PRNGKey(0))
    grads = jax.tree_util.tree_map(lambda p: (p * 0.5).astype(p.dtype), jp)
    jp, js, _ = jax.jit(JO.apply_updates, static_argnums=0)(JO.OptCfg(), jp, grads,
                                                            JO.init_state(jp))
    host = jax.tree_util.tree_map(np.asarray, (jp, js))
    tp = interop.transformer_params_from_arrays(tc, host[0], device="cpu")
    ts = interop.optimizer_state_from_arrays(host[1], device="cpu")
    return (jp, js), (tp, ts)


def _words(x) -> np.ndarray:
    """A leaf's raw bytes, as uint8."""
    if torch.is_tensor(x):
        x = x.view(torch.uint16) if x.dtype == torch.bfloat16 else x
        x = x.numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8).ravel()


def test_both_packages_write_the_same_bytes(train_state, tmp_path):
    (jstate, tstate) = train_state
    a = jck.save(jstate, 5, str(tmp_path / "jax"))
    b = ck.save(tstate, 5, str(tmp_path / "port"))
    ma, mb = (json.loads((Path(d) / "manifest.json").read_text()) for d in (a, b))
    assert ma == mb
    assert {m["dtype"] for m in ma["leaves"]} == {"bfloat16", "float32", "int32"}
    for m in ma["leaves"]:
        assert (Path(a) / m["file"]).read_bytes() == (Path(b) / m["file"]).read_bytes(), m


def test_jax_checkpoint_restores_in_the_port(train_state, tmp_path):
    (jstate, tstate) = train_state
    jck.save(jstate, 4, str(tmp_path))
    got, step = ck.restore(tstate, str(tmp_path), device="cpu")
    assert step == 4
    for (p, a), (_, b) in zip(T.leaves_with_paths(got),
                              [(jax.tree_util.keystr(k), v) for k, v in
                               jax.tree_util.tree_flatten_with_path(jstate)[0]]):
        assert a.dtype == dict(bfloat16=torch.bfloat16, float32=torch.float32,
                               int32=torch.int32)[str(b.dtype)], p
        np.testing.assert_array_equal(_words(a), _words(b), err_msg=p)


def test_port_checkpoint_restores_in_jax(train_state, tmp_path):
    (jstate, tstate) = train_state
    ck.save(tstate, 6, str(tmp_path))
    got, step = jck.restore(jstate, str(tmp_path))
    assert step == 6
    for a, b in zip(jax.tree_util.tree_leaves(got), T.leaves(tstate)):
        np.testing.assert_array_equal(_words(a), _words(b))


def test_optimizer_state_interop_round_trips(train_state):
    (_, js), (_, ts) = train_state
    back = interop.optimizer_state_to_arrays(ts)
    assert back["step"].dtype == np.int32 and int(back["step"]) == int(js["step"])
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(np.asarray, js))):
        np.testing.assert_array_equal(a, b)


# =========================================================================
# the fault layer's decisions
# =========================================================================
def test_heartbeat_failure_detection():
    now = time.time()
    found = []
    for mod in (jfault, tfault):
        mon = mod.HeartbeatMonitor(4, timeout_s=0.05)
        mon.beat(0, now)
        mon.beat(1, now)
        mon.last_beat[2] = now - 1.0   # silent worker
        mon.kill(3)
        found.append((sorted(mon.check(now)), sorted(mon.alive())))
    assert found[0] == found[1] and 2 in found[1][0] and 3 in found[1][0]


def test_straggler_mitigation():
    times = np.asarray([10.0, 11.0, 12.0, 95.0, 9.0, 10.0])
    workers = np.asarray([0, 1, 2, 3, 0, 1])
    got = [mod.mitigate_stragglers(times, workers, mod.StragglerPolicy(slowdown_factor=3.0))
           for mod in (jfault, tfault)]
    assert got[0] == got[1] and 3 in got[1] and got[1][3] != 3


@pytest.mark.parametrize("n_alive", [512, 400, 256, 100, 9, 1])
def test_elastic_remesh(n_alive):
    for shape in ((2, 16, 16), (4, 8), (8,)):
        assert tfault.elastic_remesh(n_alive, shape) == jfault.elastic_remesh(n_alive, shape)


@pytest.mark.parametrize("fail_at", [{}, {7: "died"}, {7: "died", 18: "again"}, {3: "early"}],
                         ids=["none", "one", "two", "before-first-checkpoint"])
def test_fault_tolerant_runner_matches_reference(tmp_path, fail_at):
    """The reference test's run in both packages: the same metrics, the
    same recoveries and the same final state (a step before the first
    checkpoint restarts from the beginning)."""
    def run(mod, state, add, value, where):
        def step_fn(st, b):
            new = dict(x=add(st["x"], b))
            return new, dict(x=value(new["x"]))
        r = mod.FaultTolerantRunner(step_fn, state, str(tmp_path / where), ckpt_every=5)
        m = r.run(batches[where], fail_at={k: RuntimeError(v) for k, v in fail_at.items()},
                  **({} if mod is jfault else dict(device="cpu")))
        return r, m

    batches = dict(jax=[jnp.asarray(float(i + 1)) for i in range(25)],
                   port=[torch.tensor(float(i + 1)) for i in range(25)])
    rj, mj = run(jfault, dict(x=jnp.asarray(0.0)), lambda a, b: a + b, float, "jax")
    rt, mt = run(tfault, dict(x=torch.tensor(0.0)), lambda a, b: a + b, float, "port")
    assert mt == mj and rt.recoveries == rj.recoveries == len(fail_at)
    assert rt.step == rj.step == 25 and float(rt.state["x"]) == float(rj.state["x"])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


# =========================================================================
# launch/train.py
# =========================================================================
def _shape(text: str) -> list:
    """The lines with every number replaced by N."""
    return [re.sub(r"-?\d+(\.\d+)?(e[-+]\d+)?", "N", ln) for ln in text.strip().splitlines()]


def test_train_cli_prints_the_reference_lines(tmp_path, capsys):
    """The CLI fresh for 3 steps; then both packages resume from its step-3
    checkpoint (the reference reads the port's files) and run to step 11
    on the same draws: the same lines, and the same losses to 1e-4."""
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--steps", "3",
         "--ckpt-dir", str(tmp_path / "port")], capture_output=True, text=True, env=env,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    want = jtrain.train("minicpm-2b", steps=11, ckpt_dir=str(tmp_path / "jax"))
    ref = capsys.readouterr().out
    got = ttrain.train("minicpm-2b", steps=11, ckpt_dir=str(tmp_path / "port"), device="cpu")
    port = capsys.readouterr().out
    assert _shape(port) == _shape(ref), (port, ref)
    assert _shape(proc.stdout) == _shape(ref)[-1:]          # "final loss N (start N)"
    assert port.startswith("resumed from step 3") and "step 10: loss=" in port
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert ck.latest_step(str(tmp_path / "port")) == 11


def test_train_cli_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.launch import train as ttrain

    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrain.train(steps=1)
