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

Every wrapper enters one boundary, ``kernel_call``, on every device: a
CPU tensor runs the plain version inside it, a CUDA tensor the launch.
A wrapper given ``meta`` tensors (the dry-run, ``launch/dryrun.py``) takes
the shape-only path: it allocates on ``meta`` the outputs and any
workspace its CUDA launch allocates, launches nothing, and counts the call
and its integer products' flops in ``DRY_CALLS`` / ``DRY_FLOPS`` (a CUDA
launch counts in the wrapper's ``.launches``, a CPU call in
``PLAIN_CALLS``).  A trace recorder (``analysis/walker.py``) set as
``observer`` is told of each call, and marks the ops run inside it as the
kernel's.
"""
from __future__ import annotations

import collections
import contextlib
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
HEADERS = ("dfx_common.cuh", "sm90_ptx.cuh", "sm90_wgmma.cuh", "iapprox.cuh",
           "attn_mma.cuh")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

#: C entry point -> argument types (every pointer and the stream are
#: ``c_void_p``; each returns a ``cudaError_t`` as int)
SIGNATURES = {
    "dfx_quantize_launch": [_P, _P, _P, _P, _I, _LL, _I, _I, _I, _P],
    "bfp_matmul_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "int_rmsnorm_fwd_launch": [_P, _I, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I,
                               _I, _P],
    "int_layernorm_fwd_launch": [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _F,
                                 _I, _I, _I, _I, _P],
    "int_layernorm_bwd_launch": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _I, _I, _I, _I, _P],
    "int_rmsnorm_bwd_launch": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _P],
    "int_norm_bwd_resident": [_I, _I, _I, _I, _I],
    "int_attn_fwd_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _F, _I, _P],
    "int_attn_bwd_dq_launch": [_P] * 9 + [_I] * 13 + [_F, _I, _P],
    "int_attn_bwd_dkv_launch": [_P] * 10 + [_I] * 15 + [_F, _I, _P],
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
    return the library's path.  Raises with the compiler output on error.
    Processes that start together (the ranks of a distributed run) take
    a file lock, so one of them builds and the others load its library."""
    import fcntl
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so
        return _build(so)


def _build(so: Path) -> Path:
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



#: wrapper name -> calls on meta tensors (the shape-only path)
DRY_CALLS: collections.Counter = collections.Counter()
#: wrapper name -> the integer products' flops of those calls: 2 x output
#: elements x contraction a product, once whatever its limb count
DRY_FLOPS: collections.Counter = collections.Counter()


def reset_dry() -> None:
    DRY_CALLS.clear()
    DRY_FLOPS.clear()
    PLAIN_CALLS.clear()


def launcher(t) -> tuple:
    """``(library, stream)`` of a launch on ``t``'s device, or ``(None,
    0)`` for a meta tensor: the shape-only path, whose launch functions
    allocate what the launch would and call nothing."""
    if t.device.type == "meta":
        return None, 0
    return load(), stream_of(t)


#: wrapper name -> calls on CPU tensors (the plain version ran)
PLAIN_CALLS: collections.Counter = collections.Counter()

#: the active trace recorder (``analysis/walker.py``'s ``Recorder``), told
#: of every kernel call; None when nothing records
observer = None


@contextlib.contextmanager
def kernel_call(wrapper, kind: str, operands, *, flops: int = 0, **static):
    """One call of ``wrapper`` on a ``kind`` device (``device_kind``); its
    body runs inside: the plain version (``cpu``), the launch (``cuda``)
    or the shape-only allocations (``meta``).  A call that returns is
    counted: a CUDA launch in ``wrapper.launches``, a meta call and its
    integer products' ``flops`` in ``DRY_CALLS`` / ``DRY_FLOPS``, a CPU
    call in ``PLAIN_CALLS``.  An active ``observer`` is told the wrapper's
    name, its ``operands`` (tensors, None where absent) and ``static``
    (bits, limb counts, contraction extents), and sees the body's ops as
    the kernel's."""
    name = wrapper.__name__
    obs = observer
    if obs is None:
        yield
    else:
        with obs.kernel(name, operands, static):
            yield
    if kind == "meta":
        DRY_CALLS[name] += 1
        DRY_FLOPS[name] += int(flops)
    elif kind == "cuda":
        wrapper.launches += 1
    else:
        PLAIN_CALLS[name] += 1


def device_kind(name: str, *ts) -> str:
    """``"cpu"`` (the plain version runs), ``"cuda"`` or ``"meta"`` for
    tensors that share one device; any other device, or a mix, raises."""
    devs = {t.device for t in ts}
    kind = next(iter(devs)).type
    if len(devs) != 1 or kind not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: unsupported devices {devs}")
    return kind
