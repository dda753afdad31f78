"""The port's architecture registry against the JAX package's, on the CPU.

``ARCH_IDS`` in the reference's order; for every id, ``load_arch``'s family,
skipped shapes and their reasons, shape names and ``meta`` (parameter and
active-parameter counts, the ``OptCfg`` compared field by field) equal to
the reference's (the shape cells themselves: ``test_torch_dryrun.py``).
Every smoke ``ok`` with a finite loss on the CPU, as
``tests/test_arch_smoke.py`` checks the reference's.  Granite: the shapes'
split, mode and aggregation and both queries' ``query_params`` rows, the
analytic operation counts (equal as floats), the ``GRANITE_DRYRUN_SCALE=small``
scale in a subprocess for each package, and the smoke's counts equal to
the reference's engine and oracle on the same graph and queries.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import load_arch as j_load_arch
from repro.configs import granite_ldbc as JGR
from repro.core import query as JQ
from repro_torch.configs import ARCH_IDS, load_arch
from repro_torch.configs import common
from repro_torch.configs import granite_ldbc as TGR
from repro_torch.core import query as TQ

ROOT = Path(__file__).resolve().parents[1]


def _meta(meta: dict) -> dict:
    """``meta`` with dataclass values (the ``OptCfg``s) as dictionaries."""
    return {k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
            for k, v in meta.items()}


def test_arch_ids_equal_the_reference():
    assert ARCH_IDS == J_ARCH_IDS


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_arch_spec_matches_the_reference(arch_id):
    got, want = load_arch(arch_id), j_load_arch(arch_id)
    assert isinstance(got, common.ArchSpec)
    assert (got.arch_id, got.family) == (want.arch_id, want.family)
    assert got.skip == want.skip
    assert list(got.shapes) == list(want.shapes)
    assert _meta(got.meta) == _meta(want.meta)
    if got.family.startswith("lm"):   # every LM declares the four shapes, run or skipped
        assert set(got.shapes) | set(got.skip) == set(common.LM_SHAPES)


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_arch_smoke(arch_id):
    out = load_arch(arch_id).smoke(device="cpu")
    assert out.get("ok"), (arch_id, out)
    if "loss" in out:
        assert np.isfinite(out["loss"])
    if load_arch(arch_id).family.startswith("lm"):
        assert out["logits_shape"] == (2, 16, 512)


def test_shared_shapes_equal_the_reference():
    from repro.configs import common as jcommon

    assert common.LM_SHAPES == jcommon.LM_SHAPES
    assert common.GNN_SHAPES == jcommon.GNN_SHAPES
    assert TGR._pad512 is common.pad512
    for n in (0, 1, 511, 512, 513, 114_615_892):
        assert common.pad512(n) == jcommon.pad512(n) == JGR._pad512(n)


# =========================================================================
# granite-ldbc
# =========================================================================
def test_granite_constants_and_shapes():
    assert (TGR.V_FULL, TGR.E_FULL, TGR.N_VTYPES, TGR.T_LIFE) == \
        (JGR.V_FULL, JGR.E_FULL, JGR.N_VTYPES, JGR.T_LIFE)
    assert list(TGR.SHAPES) == list(JGR.SHAPES)
    for name, info in TGR.SHAPES.items():
        want = JGR.SHAPES[name]
        assert (info["split"], info["mode"], info["agg"]) == \
            (want["split"], want["mode"], want["agg"])
        np.testing.assert_array_equal(TQ.query_params(info["qf"]()),
                                      JQ.query_params(want["qf"]()))


@pytest.mark.parametrize("shape", list(JGR.SHAPES))
def test_granite_analytic_flops(shape):
    assert TGR.analytic_flops(shape) == JGR.analytic_flops(shape)
    for V, E, B in ((1000, 5000, 16), (52_000_000, 218_000_000, 8), (77, 3, 1)):
        got = TGR.analytic_flops(shape, n_vertices=V, n_edges=E, n_buckets=B)
        assert isinstance(got, float)
        assert got == JGR.analytic_flops(shape, n_vertices=V, n_edges=E, n_buckets=B)


def test_granite_small_scale_in_each_package():
    """``GRANITE_DRYRUN_SCALE=small`` is read at import: each package's
    module imported afresh in a subprocess with it set."""
    env = dict(os.environ, GRANITE_DRYRUN_SCALE="small", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    out = {}
    for pkg in ("repro", "repro_torch"):
        code = (f"from {pkg}.configs import granite_ldbc as g; "
                "print(g.V_FULL, g.E_FULL, g.get_arch().meta['V'])")
        res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                             text=True, timeout=120, check=True)
        out[pkg] = res.stdout.split()
    assert out["repro"] == out["repro_torch"] == ["100352", "400384", "100352"]


def test_granite_smoke_counts_equal_the_reference():
    from repro.core import engine as JE
    from repro.core.ref_engine import RefEngine
    from repro.graphdata.ldbc import LdbcParams, generate_ldbc
    from repro.graphdata.queries import make_workload

    g = generate_ldbc(LdbcParams(n_persons=50, seed=11))
    wl = make_workload(g, templates=("Q2", "Q4"), n_per_template=1, seed=3)
    ref = RefEngine(g)
    want = [(JE.count_results(g, inst.qry, mode=JE.MODE_STATIC),
             ref.count(inst.qry, mode=JE.MODE_STATIC)) for inst in wl]
    got = TGR._smoke(device="cpu")
    assert got["ok"] and got["counts"] == want
    assert any(c[0] > 0 for c in want)      # a query that finds paths
