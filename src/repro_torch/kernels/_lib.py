"""Build and load the port's CUDA kernels.

The sources in ``repro_torch/csrc/`` are compiled for Hopper (``sm_90a``)
at first use: one ``nvcc -c`` per ``.cu`` file, all started together, then
one link into a shared library with a plain C interface, loaded with
``ctypes``.  The library lands in ``build/`` at the repository root, named
by a hash of the sources and flags, so an unchanged tree reuses it and a
changed one rebuilds.  Each object's ``ptxas -v`` report (registers, shared
memory, spills) is kept beside it in ``build/``.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("dfx_quant.cu", "bfp_matmul.cu", "int_norm.cu",
           "int_attention.cu", "int_attention_bwd.cu")
HEADERS = ("dfx_common.cuh",)
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

#: C entry point -> argument types (every pointer and the stream are
#: ``c_void_p``; each returns a ``cudaError_t`` as int)
SIGNATURES = {
    "dfx_quantize_launch": [_P, _P, _P, _P, _LL, _I, _I, _I, _P],
    "bfp_matmul_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "int_rmsnorm_fwd_launch": [_P, _I, _P, _P, _P, _P, _I, _I, _F, _P],
    "int_layernorm_fwd_launch": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _F,
                                 _P],
    "int_layernorm_bwd_launch": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _I, _I, _P],
    "int_layernorm_bwd_rows": [],
    "int_rmsnorm_bwd_launch": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _P],
    "int_attn_fwd_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _F, _P],
    "int_attn_bwd_dq_launch": [_P] * 9 + [_I] * 13 + [_F, _P],
    "int_attn_bwd_dkv_launch": [_P] * 10 + [_I] * 15 + [_F, _P],
}

_loaded: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"repro_torch_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the kernels (if this tree's library is not built yet) and
    return the library's path.  Raises with the compiler output on error."""
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    obj_dir = BUILD_DIR / f"obj_{so.stem.rsplit('_', 1)[-1]}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in SOURCES:
        obj = obj_dir / (name + ".o")
        cmd = [nvcc, *FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c",
               str(CSRC / name), "-o", str(obj)]
        jobs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, obj, proc in jobs:
        out, _ = proc.communicate()
        (obj_dir / (name + ".log")).write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- {name} ---\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-Xcompiler", "-fPIC",
         *[str(obj) for _, obj, _ in jobs], "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, so)
    return so


def ptxas_report() -> str:
    """The ``ptxas -v`` lines of the current build (empty before a build)."""
    obj_dir = BUILD_DIR / f"obj_{library_path().stem.rsplit('_', 1)[-1]}"
    return "\n".join(p.read_text() for p in sorted(obj_dir.glob("*.log")))


def load() -> ctypes.CDLL:
    """The kernel library with typed entry points (built on first use,
    loaded once per process)."""
    if "lib" not in _loaded:
        lib = ctypes.CDLL(str(build()))
        for fn, argtypes in SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _loaded["lib"] = lib
    return _loaded["lib"]


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_of(t) -> int:
    """Handle of PyTorch's current CUDA stream on ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream

