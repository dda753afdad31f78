"""The port's dry run against the JAX package's, on the CPU.

Every (architecture × shape) cell on both production meshes, the port's
built on ``launch/mesh.py``'s ``Mesh`` and the reference's on
``jax.sharding.AbstractMesh`` (no devices, nothing compiled): the same
``kind``, the same argument tree paths, equal shape and dtype for each
leaf, and equal input and output partition specs as tuples; the same
skipped shapes with the same reasons.  Granite's device graph has two
port-only leaves, ``t_src_l`` and ``t_dst_l`` (the int64 index copies that
torch indexing reads), listed here by name.  ``param_specs`` and
``cache_specs`` equal the reference's for every LM config, at ``mesh=None``
(the reference with its axes off) and on both meshes; the production
meshes' shapes and names equal; ``model_flops_for`` and the granite cells'
``analytic_flops`` equal as floats.  The CLI on one cell writes the
reference's keys; a cell made to fail writes ``status: error`` and exits 1.
"""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import common as jcommon
from repro.configs import load_arch as j_load_arch
from repro.models import transformer as jtr
from repro_torch.configs import ARCH_IDS, common, load_arch
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as ttr
from repro_torch.training import tree as T

MESHES = {"single": (False, AbstractMesh((16, 16), ("data", "model"))),
          "multi": (True, AbstractMesh((2, 16, 16), ("pod", "data", "model")))}
LM_IDS = ("llama3-405b", "minicpm-2b", "gemma3-4b", "olmoe-1b-7b", "mixtral-8x22b")
#: leaves of the port's cells that the reference's do not have, by arch and path
PORT_ONLY = {"granite-ldbc": {"[0]['t_src_l']", "[0]['t_dst_l']"}}
#: the reference's cells (and specs) by (arch, shape, mesh), built once
_REF: dict = {}


def _cells():
    for arch_id in ARCH_IDS:
        spec = j_load_arch(arch_id)
        for name in list(spec.shapes) + list(spec.skip):
            yield arch_id, name


def _ref_cell(arch_id, shape, mesh_kind):
    key = (arch_id, shape, mesh_kind)
    if key not in _REF:
        cell = j_load_arch(arch_id).shapes[shape](MESHES[mesh_kind][1])
        is_sh = lambda x: isinstance(x, jax.sharding.NamedSharding)
        _REF[key] = dict(
            kind=cell.kind, note=cell.note, analytic=cell.analytic_flops,
            args={jax.tree_util.keystr(p): (tuple(x.shape), str(np.dtype(x.dtype)))
                  for p, x in jax.tree_util.tree_leaves_with_path(cell.args)},
            ins=[tuple(s.spec) for s in jax.tree_util.tree_leaves(cell.in_shardings,
                                                                  is_leaf=is_sh)],
            outs=[tuple(s.spec) for s in jax.tree_util.tree_leaves(cell.out_shardings,
                                                                   is_leaf=is_sh)])
    return _REF[key]


def _ref_model_flops_for():
    """The reference's ``model_flops_for``.  Its module sets XLA_FLAGS to 512
    host devices when imported; the flag is put back at once, before any
    backend reads it, so the tests around this one keep one CPU device."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import model_flops_for
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return model_flops_for


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch_id,shape", list(_cells()))
def test_cell_equals_the_reference(arch_id, shape, mesh_kind):
    got_spec, want_spec = load_arch(arch_id), j_load_arch(arch_id)
    if shape in want_spec.skip:
        assert got_spec.skip[shape] == want_spec.skip[shape]
        assert shape not in got_spec.shapes
        return
    want = _ref_cell(arch_id, shape, mesh_kind)
    cell = got_spec.shapes[shape](make_production_mesh(multi_pod=MESHES[mesh_kind][0]))
    assert isinstance(cell, common.ShapeCell)
    assert cell.kind == want["kind"]
    assert cell.analytic_flops == want["analytic"]
    got = {}
    for path, x in T.leaves_with_paths(cell.args):
        assert x.is_meta, path
        got[path] = (tuple(x.shape), _dtype(x))
    extra = PORT_ONLY.get(arch_id, set())
    assert set(got) - set(want["args"]) == extra
    assert {p: v for p, v in got.items() if p not in extra} == want["args"]
    # the specs in the order of the argument leaves: the port-only leaves' out
    ins = [tuple(s) for s in common.spec_leaves(cell.in_shardings)]
    paths = [p for p, _ in T.leaves_with_paths(cell.args)]
    assert len(ins) == len(paths)
    assert [s for p, s in zip(paths, ins) if p not in extra] == want["ins"]
    assert [tuple(s) for s in common.spec_leaves(cell.out_shardings)] == want["outs"]


@pytest.mark.parametrize("arch_id", LM_IDS)
def test_lm_param_and_cache_specs_equal_the_reference(arch_id):
    mod = __import__(f"repro.configs.{arch_id.replace('-', '_')}", fromlist=["CONFIG"])
    tmod = __import__(f"repro_torch.configs.{arch_id.replace('-', '_')}", fromlist=["CONFIG"])
    jcfg, tcfg = mod.CONFIG, tmod.CONFIG
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)

    def ref_specs(cfg, mesh):
        flat = jax.tree_util.tree_leaves_with_path(jtr.param_specs(cfg, mesh), is_leaf=is_p)
        return {jax.tree_util.keystr(p): tuple(s) for p, s in flat}

    def port_specs(mesh):
        specs = ttr.param_specs(tcfg, mesh)
        shapes = ttr.init_shapes(tcfg)
        return {p: tuple(s) for (p, _), s in zip(T.leaves_with_paths(shapes),
                                                  common.spec_leaves(specs))}

    off = dataclasses.replace(jcfg, data_axes=None, model_axis=None)
    assert port_specs(None) == ref_specs(off, None)
    assert tuple(ttr.cache_specs(tcfg, None)) == tuple(jtr.cache_specs(off, None))
    # init_shapes: the reference's tree, shapes and dtypes
    want = {jax.tree_util.keystr(p): (tuple(x.shape), str(np.dtype(x.dtype)))
            for p, x in jax.tree_util.tree_leaves_with_path(jtr.init_shapes(jcfg))}
    assert {p: (tuple(x.shape), _dtype(x))
            for p, x in T.leaves_with_paths(ttr.init_shapes(tcfg))} == want
    # and the port's own init_params at a reduced width has init_shapes' tree
    small = dataclasses.replace(tcfg, n_layers=2, d_model=32, d_ff=48, vocab=64)
    drawn = ttr.init_params(small, torch.Generator().manual_seed(0), device="cpu")
    assert [(p, tuple(x.shape), x.dtype) for p, x in T.leaves_with_paths(drawn)] == \
        [(p, tuple(x.shape), x.dtype) for p, x in T.leaves_with_paths(ttr.init_shapes(small))]
    for multi, amesh in MESHES.values():
        cfg = jcommon.lm_cfg_for_mesh(jcfg, amesh)
        mesh = make_production_mesh(multi_pod=multi)
        assert port_specs(mesh) == ref_specs(cfg, amesh)
        assert tuple(ttr.cache_specs(tcfg, mesh)) == tuple(jtr.cache_specs(cfg, amesh))
        assert tuple(common._cache_spec_b1(tcfg, mesh)) == \
            tuple(jcommon._cache_spec_b1(cfg, amesh))


def test_dlrm_init_shapes_are_init_params_tree():
    from repro_torch.configs.dlrm_rm2 import SMOKE
    from repro_torch.models import dlrm as tdm

    drawn = tdm.init_params(SMOKE, torch.Generator().manual_seed(0), device="cpu")
    got = tdm.init_shapes(SMOKE)
    assert [(p, tuple(x.shape), x.dtype) for p, x in T.leaves_with_paths(drawn)] == \
        [(p, tuple(x.shape), x.dtype) for p, x in T.leaves_with_paths(got)]
    assert all(x.is_meta for x in T.leaves(got))
    assert len(common.spec_leaves(tdm.param_specs(SMOKE))) == len(T.leaves(got))


def test_production_meshes_equal_the_reference():
    for multi, amesh in MESHES.values():
        got = make_production_mesh(multi_pod=multi)
        assert got.axis_names == tuple(amesh.axis_names)
        assert got.shape == dict(amesh.shape)
        assert got.size == amesh.size


def test_shard_shape_divides_with_ceil():
    mesh = make_production_mesh(multi_pod=True)
    assert common.shard_shape((1000, 7, 64), common.P(("pod", "data"), None, "model"),
                              mesh) == (32, 7, 4)
    assert common.shard_shape((5,), common.P(), mesh) == (5,)
    assert common.P(("data",), None) == ("data", None)


@pytest.mark.parametrize("arch_id,shape", list(_cells()))
def test_model_flops_equal_the_reference(arch_id, shape):
    got = dryrun.model_flops_for(arch_id, shape, load_arch(arch_id))
    want = _ref_model_flops_for()(arch_id, shape, j_load_arch(arch_id))
    assert got == want and type(got) is type(want)


def test_cli_writes_the_reference_keys(tmp_path):
    rc = dryrun.main(["--arch", "gemma3-4b", "--shape", "decode_32k", "--mesh", "both",
                      "--out", str(tmp_path)])
    assert rc == 0
    keys = {"arch", "shape", "mesh", "chips", "hlo_flops", "hlo_bytes", "collective_bytes",
            "coll_by_kind", "t_compute", "t_memory", "t_collective", "bottleneck",
            "model_flops", "useful_flops_frac", "memory_per_device", "scan_scale",
            "status", "t_lower_s", "t_compile_s", "kind", "note"}
    for mk, chips in (("single", 256), ("multi", 512)):
        rec = json.loads((tmp_path / f"gemma3-4b__decode_32k__{mk}.json").read_text())
        assert keys <= set(rec), keys - set(rec)
        assert rec["status"] == "ok" and rec["chips"] == chips and rec["kind"] == "decode"
        assert rec["count_source"] and rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0


def test_cli_jobs_write_the_same_records(tmp_path):
    """``--jobs 2`` (spawned workers) writes what one process writes, but
    the seconds."""
    argv = ["--arch", "dlrm-rm2", "--shape", "serve_bulk", "--mesh", "both"]
    assert dryrun.main(argv + ["--out", str(tmp_path / "a")]) == 0
    assert dryrun.main(argv + ["--out", str(tmp_path / "b"), "--jobs", "2"]) == 0
    for mk in ("single", "multi"):
        a, b = (json.loads((tmp_path / d / f"dlrm-rm2__serve_bulk__{mk}.json").read_text())
                for d in ("a", "b"))
        for rec in (a, b):
            for k in ("t_lower_s", "t_trace_s"):
                rec.pop(k)
        assert a == b and a["status"] == "ok"


def test_cli_records_a_failing_cell(tmp_path, monkeypatch, capsys):
    def broken(mesh):
        raise RuntimeError("made to fail")

    spec = load_arch("dlrm-rm2")
    spec.shapes["serve_p99"] = broken
    monkeypatch.setattr(dryrun, "load_arch", lambda arch_id: spec)
    rc = dryrun.main(["--arch", "dlrm-rm2", "--shape", "serve_p99", "--out", str(tmp_path)])
    assert rc == 1
    rec = json.loads((tmp_path / "dlrm-rm2__serve_p99__single.json").read_text())
    assert rec["status"] == "error" and "made to fail" in rec["error"] and rec["trace"]
    assert "DRYRUN SUMMARY: ok=0 skipped=0 errors=1" in capsys.readouterr().out
