"""The torch port stands alone: it imports neither JAX nor the reference
package, and ``chip_smoke.py`` and the port's scripts (``scripts/torch_*.py``)
neither."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "scripts").glob("torch_*.py")))


def _port_modules():
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def test_no_import_names_jax_or_the_reference():
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path.name, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                if _forbidden(node.module):
                    bad.append((path.name, node.module))
    assert not bad, bad


def test_every_module_imports_with_jax_and_the_reference_blocked():
    modules = _port_modules()
    assert len(modules) > 10
    for m in ("repro_torch.core.engine", "repro_torch.models.transformer",
              "repro_torch.models.dlrm", "repro_torch.kernels.flash_attention.ops",
              "repro_torch.kernels.embedding_bag.ops", "repro_torch.configs.gemma3_4b",
              "repro_torch.configs.dlrm_rm2", "repro_torch.core.planner",
              "repro_torch.serving.scheduler", "repro_torch.obs.trace",
              "repro_torch.launch.query", "repro_torch.core.engine_partitioned",
              "repro_torch.graphdata.partitioner"):
        assert m in modules, m
    code = f"""
import importlib, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
for m in {modules!r}:
    importlib.import_module(m)
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not leaked, leaked
print("OK", len({modules!r}))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("OK")
