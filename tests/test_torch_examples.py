"""The port's examples (``examples/torch_*.py``) against the JAX package's,
on the CPU.

quickstart: both examples' ``main()`` in one process; the printed lines must
be equal, from the graph's stats through the three bucket rows.
serve_decode: the example's greedy loop on the reference's ``init_params(
SMOKE, PRNGKey(0))`` (carried by ``interop``) and the reference's prompts,
against the reference example's flow (``prefill`` and 31 ``decode_step``s):
float32 logits at atol 2e-5 at every step where the tokens so far agree, and
the same greedy tokens on every sequence, a token allowed to differ only
where the reference's top-2 gap is below that bound (counted).  train_lm:
three steps to a checkpoint, then a re-run resumes from it.  Without
``--device cpu`` each example raises on a host with no GPU."""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gemma3_4b import SMOKE as JC
from repro.models import transformer as jtr
from repro_torch import interop

ROOT = Path(__file__).resolve().parents[1]
ATOL = 2e-5


def _load(rel: str):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_prints_the_reference_lines(capsys):
    _load("examples/quickstart.py").main()
    want = capsys.readouterr().out.splitlines()
    _load("examples/torch_quickstart.py").main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert len(want) == 6 and want[0].startswith("graph: ")   # stats, EQ1, EQ2, 3 rows
    assert want[1].startswith("EQ1 matches: 2 structurally, 0 with")
    assert want[2].startswith("EQ2 (liked before): 1 path(s)")


def _reference_greedy(params, prompts, gen_len):
    """``serve_decode.py``'s flow, keeping each token's logits."""
    prompt_len = prompts.shape[1]
    logits, cache = jtr.prefill(JC, params, prompts, max_len=prompt_len + gen_len)
    decode = jax.jit(lambda p, c, t, n: jtr.decode_step(JC, p, c, t, n))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    toks, steps = [tok], [logits]
    for i in range(gen_len - 1):
        logits, cache = decode(params, cache, tok, prompt_len + i + 1)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(tok)
        steps.append(logits)
    return np.asarray(jnp.stack(toks, 1)), np.asarray(jnp.stack(steps), np.float32)


def test_serve_decode_greedy_matches_reference():
    ex = _load("examples/torch_serve_decode.py")
    batch, prompt_len, gen_len = 8, 16, 32
    jp = jtr.init_params(JC, jax.random.PRNGKey(0))
    prompts = jax.random.randint(jax.random.PRNGKey(1), (batch, prompt_len), 0, JC.vocab)
    want_tok, want_logits = _reference_greedy(jp, prompts, gen_len)

    tp = interop.transformer_params_from_arrays(
        ex.CFG, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    got_tok, got_logits, t_prefill, t_decode = ex.greedy(
        ex.CFG, tp, torch.from_numpy(np.array(prompts, np.int32)), gen_len)
    assert got_tok.shape == (batch, gen_len) and got_tok.dtype == torch.int32
    assert got_logits.dtype == torch.float32 and t_prefill > 0 and t_decode > 0
    got_tok, got_logits = got_tok.numpy(), got_logits.numpy()

    near_ties = 0
    for b in range(batch):
        for t in range(gen_len):
            # the logits of step t follow the tokens before it: equal so far
            np.testing.assert_allclose(got_logits[t, b], want_logits[t, b], atol=ATOL, rtol=0)
            if got_tok[b, t] != want_tok[b, t]:
                top2 = np.sort(want_logits[t, b])[-2:]
                assert top2[1] - top2[0] < ATOL, (b, t, got_tok[b, t], want_tok[b, t])
                near_ties += 1
                break          # the rest of this sequence follows another token
    print(f"greedy tokens that differ at a near tie: {near_ties} of {batch} sequences")


def test_train_lm_resumes_from_its_checkpoint(tmp_path, capsys):
    ex = _load("examples/torch_train_lm.py")
    ex.main(["--device", "cpu", "--steps", "3", "--ckpt-dir", str(tmp_path)])
    first = capsys.readouterr().out
    assert "resumed" not in first and "final loss" in first
    ex.main(["--device", "cpu", "--steps", "5", "--ckpt-dir", str(tmp_path)])
    again = capsys.readouterr().out.splitlines()
    assert again[0] == "resumed from step 3"
    assert again[-1].startswith("final loss")


@pytest.mark.parametrize("example,argv", [
    ("torch_quickstart.py", []),
    ("torch_temporal_queries.py", ["--persons", "50"]),
    ("torch_serve_decode.py", []),
    ("torch_train_lm.py", ["--steps", "1"]),
])
def test_example_raises_without_a_gpu(example, argv, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("the check is of a host with no GPU")
    if example == "torch_train_lm.py":
        argv = argv + ["--ckpt-dir", str(tmp_path)]
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / example)] + argv,
                          capture_output=True, text=True, timeout=120, cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr, proc.stderr[-1000:]
    assert not any(tmp_path.iterdir())
