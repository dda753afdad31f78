"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ``ctypes``.  Nothing here runs when the
module is imported: ``load()`` builds on the first call (the first kernel
launch) and caches the library for the process.  Outputs go to ``build/`` at
the root of the checkout (git ignores it), under a name that carries a hash
of the source and flags, so an edited source never loads a stale library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

#: C signature of every entry point, by source
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "hop_scatter": {
        "hop_fused_cols": (_P, _L, _L, _I, _I, _P, _P, _L, _P, _I, _I, _I, _I, _P,
                           _L, _L, _F, _I, _P, _P, _P),
        "hop_fused_interval": (_P, _L, _I, _I, _P, _P, _L, _P, _L, _P, _L, _P,
                               _I, _I, _P, _L, _F, _I, _P, _P, _P),
        "hop_scatter_cols": (_P, _L, _I, _P, _I, _I, _I, _I, _P, _P),
        "hop_scatter_extremum": (_P, _L, _P, _L, _P, _I, _I, _I, _I, _F, _I, _P, _I, _P,
                                 _P),
    },
    "flash_attention": {
        "flash_attention_fwd": (_P, _P, _P, _P, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                                _L, _L, _L, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                                _I, _P),
    },
    "flash_attention_sm90": {
        "flash_attention_tc_fwd": (_P, _P, _P, _P, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                                   _L, _L, _L, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P),
        "flash_attention_tc_encode_ns": (_P, _P, _P, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                                         _I, _I, _I, _I, _I, _I, _I, _I, _I),
    },
    "flash_decode": {
        "flash_decode_fwd": (_P, _P, _P, _P, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                             _L, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I,
                             _I, _P, _P),
    },
    "flash_decode_int8": {
        "flash_decode_int8_fwd": (_P, _P, _P, _P, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                                  _L, _L, _P, _P, _L, _L, _L, _L, _L, _L, _I, _I, _I, _I,
                                  _I, _I, _F, _I, _I, _I, _I, _I, _I, _I, _P, _P),
    },
    "embedding_bag": {
        "embedding_bags_fwd": (_P, _P, _I, _I, _P, _L, _I, _I, _P, _L, _P),
    },
    "bucket_scatter": {
        "bucket_scatter_fwd": (_P, _I, _L, _P, _L, _I, _P, _P),
    },
    "interval_warp": {
        "interval_warp_fwd": (_P, _I, _P, _P, _L, _I, _P, _P),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from the CUDA toolkit PyTorch finds (CUDA_HOME, PATH, or the
    toolkit's standard install location)."""
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [shutil.which("nvcc")]
    if CUDA_HOME:
        cand.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source, of
    every header of ``csrc/`` (a source may include one) and of the flags."""
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def compile_source(name: str) -> Tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns (path,
    seconds spent compiling, compiler messages)."""
    out = library_path(name)
    if out.exists():
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    return out, dt, proc.stderr


def load(name: str = "hop_scatter") -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path, _, _ = compile_source(name)
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (a ``cudaError_t``)."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")
