"""``roofline.analysis`` on hand-counted programs, on the CPU (``meta``).

``count_program`` exact on a bf16 matrix product (2mkn FLOPs under bf16,
(mk + kn + mn)·2 bytes), a float32 add, views (nothing moved) and a gather
(the rows it gathers, not its source); one B7 prefill call, one decode call
and one int8 decode call counted by the kernel's formulas
(``attention_work``, ``attention_int8_work``), not by the plain version's
float32 scores, which ``impl='torch'`` does count; one B8 call by
``embedding_bags_work``.  In a whole cell (gemma3-4b ``prefill_32k``) B7's
calls count less than one [B, H, S, S] float32 score tensor.  A report's terms,
bottleneck, blocks and modelled collectives, worked out by hand for small
cells on a 2 × 2 mesh.
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs import common, load_arch
from repro_torch.kernels.embedding_bag import ops as EB
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.launch.mesh import Mesh, P, make_production_mesh
from repro_torch.roofline import analysis as A


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_matmul_bf16_is_2mkn_and_each_operand_once():
    m, k, n = 96, 160, 224
    a, b = meta(m, k, dtype=torch.bfloat16), meta(k, n, dtype=torch.bfloat16)
    c = A.count_program(lambda x, y: x @ y, (a, b))
    assert c.flops == {"bf16": 2.0 * m * k * n, "f32": 0.0}
    assert c.bytes == (m * k + k * n + m * n) * 2
    assert c.ops == 1 and c.kernels == {}


def test_float32_add_and_views():
    x, y = meta(1000, 3), meta(1000, 3)
    c = A.count_program(lambda x, y: x + y, (x, y))
    assert c.flops == {"bf16": 0.0, "f32": 0.0}
    assert c.bytes == 3 * 3000 * 4
    c = A.count_program(lambda x: x.t().reshape(3, 10, 100)[1].unsqueeze(0), (x,))
    assert c.bytes == 0
    # an expanded operand counts its storage once
    c = A.count_program(lambda x, r: x + r.expand(1000, 3), (x, meta(1, 3)))
    assert c.bytes == (3000 + 3 + 3000) * 4


def test_gather_reads_the_rows_it_gathers():
    table, idx = meta(1_000_000, 64), torch.empty(512, dtype=torch.long, device="meta")
    c = A.count_program(lambda t, i: t[i], (table, idx))
    assert c.bytes == 512 * 8 + 2 * 512 * 64 * 4


@pytest.mark.parametrize("window", [None, 1024])
def test_b7_prefill_counts_the_kernel_not_the_scores(window):
    B, Hq, Hkv, S, D = 2, 8, 4, 2048, 256
    q = meta(B, Hq, S, D, dtype=torch.bfloat16)
    k, v = meta(B, Hkv, S, D, dtype=torch.bfloat16), meta(B, Hkv, S, D, dtype=torch.bfloat16)
    run = lambda impl: A.count_program(
        lambda q, k, v: FA.flash_attention(q, k, v, causal=True, window=window, impl=impl),
        (q, k, v))
    c = run("cuda")
    nbytes, pairs = A.attention_work(q, k, dict(causal=True, window=window))
    w = S if window is None else window
    assert pairs == B * Hq * sum(min(i + 1, w) for i in range(S))
    assert nbytes == 2 * (2 * B * Hq * S * D + 2 * B * Hkv * S * D)
    assert c.bytes == nbytes
    assert c.flops == {"bf16": 4.0 * D * pairs, "f32": 0.0}
    assert c.kernels == {"flash_attention": dict(calls=1, bytes=float(nbytes),
                                                 flops=4.0 * D * pairs)}
    scores = B * Hq * S * S * 4
    assert c.bytes < scores
    plain = run("torch")           # the plain version on the card: its scores are counted
    assert plain.kernels == {} and plain.bytes > 3 * scores


def test_b7_decode_counts_the_visible_rows():
    B, Hq, Hkv, Smax, D, n = 4, 8, 4, 4096, 128, 3000
    q = meta(B, Hq, 1, D, dtype=torch.bfloat16)
    kc = meta(B, Hkv, Smax, D, dtype=torch.bfloat16)
    vc = meta(B, Hkv, Smax, D, dtype=torch.bfloat16)
    c = A.count_program(lambda q, k, v: FA.decode_attention(q, k, v, n, window=None),
                        (q, kc, vc))
    assert c.bytes == 2 * (2 * B * Hq * D + 2 * B * Hkv * n * D)
    assert c.flops["bf16"] == 4.0 * D * B * Hq * n
    # int8 cache: int8 rows and bf16 scales, float32 operations
    k8 = meta(B, Hkv, Smax, D, dtype=torch.int8)
    sc = meta(B, Hkv, Smax, dtype=torch.bfloat16)
    c = A.count_program(lambda q, k, v, s: FA.decode_attention(q, k, v, n, window=512,
                                                               scales=(s, s)),
                        (q, k8, k8, sc))
    rows = 512
    assert c.bytes == 2 * B * Hq * D * 2 + 2 * B * Hkv * rows * (D + 2)
    assert c.flops == {"bf16": 0.0, "f32": 4.0 * D * B * Hq * rows + 2.0 * B * Hkv * rows * D}
    assert c.kernels["flash_attention"]["calls"] == 1


def test_b8_counts_each_lookup_row_once():
    n_bags, F, L, D = 512, 3, 2, 64
    tables = [meta(v, D) for v in (1_000_000, 300, 1_000_000)]
    idx = torch.empty((n_bags, F, L), dtype=torch.int32, device="meta")
    c = A.count_program(lambda t, i: EB.embedding_bags(t, i, "sum"), (tables, idx))
    uniq = [n_bags * L, 300, n_bags * L]
    assert c.bytes == sum(4.0 * (n_bags * L + u * D + n_bags * D) for u in uniq)
    assert c.flops == {"bf16": 0.0, "f32": float(n_bags * F * L * D)}
    assert A.embedding_bags_work(n_bags, L, D, uniq) == (c.bytes, c.flops["f32"])


def test_no_cell_counts_a_score_tensor():
    """gemma3-4b's prefill_32k: B7's 34 calls together move less than one
    [B, Hq, S, S] float32 score tensor; the same cell with the plain
    attention (impl='torch') counts more than one such tensor a layer on
    top."""
    from repro_torch.configs.gemma3_4b import CONFIG

    cell = load_arch("gemma3-4b").shapes["prefill_32k"](make_production_mesh())
    c = A.count_program(cell.fn, cell.args)
    B, S = cell.args[1].shape
    scores = B * CONFIG.n_heads * S * S * 4
    assert c.kernels["flash_attention"]["calls"] == 34
    assert c.kernels["flash_attention"]["bytes"] < scores
    layers_n = CONFIG.param_count() - CONFIG.vocab * CONFIG.d_model
    assert c.flops["bf16"] > 2.0 * layers_n * B * S      # at least 2 N D over the layers
    plain = common.lm_cell(dataclasses.replace(CONFIG, impl="torch"), "prefill_32k",
                           make_production_mesh())
    p = A.count_program(plain.fn, plain.args)
    assert p.kernels == {} and p.bytes - c.bytes > CONFIG.n_layers * scores


def test_report_terms_by_hand():
    mesh = Mesh(("data", "model"), (2, 2))
    m, k, n = 4096, 1024, 2048
    w = meta(k, n, dtype=torch.bfloat16)
    x = meta(m, k, dtype=torch.bfloat16)
    cell = common.ShapeCell(lambda p, x: x @ p["w"], ({"w": w}, x),
                            ({"w": P(None, "model")}, P("data", None)), P("data", "model"),
                            "serve")
    counts, out = A.count_program(cell.fn, cell.args, return_output=True)
    rep = A.analyze_counts(counts, cell, mesh, "toy", "mm", "2x2", model_flops=2.0 * m * k * n,
                           output=out)
    flops = 2.0 * m * k * n / 4
    byts = (m * k + k * n + m * n) * 2 / 4
    assert rep.hlo_flops == flops and rep.hlo_bytes == byts
    assert rep.t_compute == flops / 989e12 and rep.t_memory == byts / 3.35e12
    assert rep.collective_bytes == 0 and rep.t_collective == 0
    assert rep.bottleneck == "compute" and rep.useful_flops_frac == 1.0
    assert rep.memory_per_device == dict(argument_bytes=(k * n // 2 + m * k // 2) * 2,
                                         output_bytes=m * n // 4 * 2, temp_bytes=None,
                                         code_bytes=None)
    assert A.roofline_terms(rep)["bottleneck"] == "compute"
    assert rep.scan_scale == 1.0 and rep.count_source == A.COUNT_SOURCE


def test_collective_model_by_hand():
    mesh = Mesh(("data", "model"), (2, 4))
    w = meta(64, 128, dtype=torch.bfloat16)        # FSDP x TP: block 32 x 32
    b = meta(128)                                  # replicated: all-reduced in train
    params, specs = {"w": w, "b": b}, {"w": P("data", "model"), "b": P(None)}
    for kind, want in (("train", {"all-gather": 2 * 64 * 32 * 2, "reduce-scatter": 64 * 32 * 2,
                                  "all-reduce": 2.0 * 128 * 4}),
                       ("serve", {"all-gather": 64 * 32 * 2})):
        cell = common.ShapeCell(None, (params,), (specs,), P(), kind)
        got = A.collective_bytes(cell, mesh)
        assert {kk: v for kk, v in got.items() if v} == want
    assert sum(A.collective_bytes(common.ShapeCell(None, (params,), (specs,), P(), "query"),
                                  mesh).values()) == 0


def test_lm_tp_all_reduce_by_hand():
    """An LM train cell: the activations after wo and wd all-reduced (2x)
    forward and backward in every layer."""
    spec = load_arch("minicpm-2b")
    mesh = make_production_mesh()
    cell = spec.shapes["train_4k"](mesh)
    got = A.collective_bytes(cell, mesh)
    from repro_torch.configs.minicpm_2b import CONFIG as C
    tokens = 256 * 4096 / 16
    act = tokens * C.d_model * 2
    params = [(t, s) for t, s in A.paired(cell.args[0], cell.in_shardings[0])]
    rep = sum(2.0 * A.block_bytes(t, s, mesh) for t, s in params
              if not any(a == "data" for a in A._spec_axes(s)))
    # wo splits Hq·Dh = 2304 over 16; wd splits d_ff = 5760 over 16
    assert math.isclose(got["all-reduce"], 2.0 * act * 2 * C.n_layers * 2 + rep)
    fsdp = sum(A.block_bytes(t, s, mesh) * 16 for t, s in params
               if any(a == "data" for a in A._spec_axes(s)))
    assert math.isclose(got["all-gather"], 2 * fsdp)
    assert math.isclose(got["reduce-scatter"], fsdp)
