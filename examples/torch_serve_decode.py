"""Serve batched decode requests from a (reduced) gemma3-style model on the
PyTorch port: prefill the prompt batch, then stream tokens with the KV
cache.  The counterpart of ``serve_decode.py``, with the same printed lines.

    PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]

Runs on the card unless ``--device cpu`` is given; with no GPU and no
``--device cpu`` it raises.  Weights come from ``torch.Generator`` seed 0 and
the prompts from seed 1, so the tokens are the port's own, not the JAX
example's.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs.gemma3_4b import SMOKE as CFG
from repro_torch.kernels.common import resolve_device
from repro_torch.models import transformer as tr


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


@torch.no_grad()
def greedy(cfg, params, prompts: torch.Tensor, gen_len: int):
    """Prefill ``prompts`` [B, S], then ``gen_len - 1`` greedy decode steps.
    Returns (tokens [B, gen_len] int32, the float32 logits each token was
    taken from [gen_len, B, vocab], prefill seconds, decode seconds)."""
    prompt_len = prompts.shape[1]
    t0 = time.perf_counter()
    logits, cache = tr.prefill(cfg, params, prompts, max_len=prompt_len + gen_len)
    _sync(logits)
    t_prefill = time.perf_counter() - t0

    tok = logits.argmax(-1).to(torch.int32)
    toks, steps = [tok], [logits]
    t0 = time.perf_counter()
    for i in range(gen_len - 1):
        logits, cache = tr.decode_step(cfg, params, cache, tok, prompt_len + i + 1)
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok)
        steps.append(logits)
    _sync(tok)
    return torch.stack(toks, 1), torch.stack(steps), t_prefill, time.perf_counter() - t0


def main(argv=None, batch=8, prompt_len=16, gen_len=32):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (the card, the default) or 'cpu'")
    dev = resolve_device(ap.parse_args(argv).device)

    params = tr.init_params(CFG, torch.Generator().manual_seed(0), device=dev)
    prompts = torch.randint(0, CFG.vocab, (batch, prompt_len), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1)).to(dev)
    out, _, t_prefill, dt = greedy(CFG, params, prompts, gen_len)
    print(f"prefill[{batch}x{prompt_len}]: {t_prefill*1e3:.1f} ms")
    print(f"decode: {gen_len-1} steps × {batch} seqs in {dt*1e3:.1f} ms "
          f"({dt/(gen_len-1)*1e3:.2f} ms/token, greedy)")
    print("sampled token ids (first seq):", out[0][:16].tolist())


if __name__ == "__main__":
    main()
