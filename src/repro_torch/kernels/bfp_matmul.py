"""Block-floating-point integer matmul over int8 limb planes: the forward
product (NN) and the two backward products (NT for dX, TN for dW).

Counterpart of ``repro/kernels/bfp_matmul.py::bfp_matmul``,
``bfp_matmul_nt`` and ``bfp_matmul_tn`` and of their batched (expert-axis)
twins ``bfp_matmul_batched{,_nt,_tn}``; one CUDA kernel source,
``csrc/bfp_matmul.cu``, serves all six (the batched ones put the expert on
the grid and scale expert ``e`` by its own ``out_exp[e]``).

    acc[ja, jb] = A[ja] · B[jb]                      exact int32 per limb pair
    out = Σ_{ja outer, jb inner} (f32(acc) · 2^exp) · 2^(7(ja+jb))

in the fixed order of the reference's ``_combine_partials``, where
(A, B) is (X, W) for NN, (G, Wᵀ) for NT and (Xᵀ, G) for TN.  Every operand
keeps the layout its producer wrote: the transposes happen while the
kernel stages its tiles into shared memory.  NN's ``wm`` is ``(Lw, K, N)``;
its storage may be N-contiguous (a linear layer's weight) or K-contiguous
(``wm.transpose(1, 2)`` contiguous: the tied LM head's planes, quantized in
the embedding table's own layout).  The batched operands are plane-major
``(L, E, rows, cols)``, as the grouped quantize writes them.
"""
from __future__ import annotations

import torch

from repro_torch.core.dfx import pow2
from repro_torch.kernels import _lib
from repro_torch.kernels.dfx_quant import LIMB_BITS

#: ``layout`` codes of ``bfp_matmul_launch`` (csrc/bfp_matmul.cu)
_NN, _B_KMAJOR, _TN = 0, 1, 2


def _combine_plain(a: torch.Tensor, b: torch.Tensor, out_exp: torch.Tensor,
                   product) -> torch.Tensor:
    """Each limb-pair product ``product(a[ja], b[jb])`` in float64, which is
    exact for int8 planes (|acc| < 2^53), then the ordered f32 combine."""
    scale0 = pow2(out_exp)
    out = None
    for ja in range(a.shape[0]):
        for jb in range(b.shape[0]):
            acc = product(a[ja].to(torch.float64), b[jb].to(torch.float64))
            part = (acc.to(torch.float32) * scale0) * float(
                2 ** (LIMB_BITS * (ja + jb)))
            out = part if out is None else out + part
    return out


def bfp_matmul_plain(xm: torch.Tensor, wm: torch.Tensor,
                     out_exp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the NN kernel (same arithmetic)."""
    return _combine_plain(xm, wm, out_exp, lambda x, w: x @ w)


def bfp_matmul_nt_plain(gm: torch.Tensor, wm: torch.Tensor,
                        out_exp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the NT kernel: ``g @ wᵀ``."""
    return _combine_plain(gm, wm, out_exp, lambda g, w: g @ w.t())


def bfp_matmul_tn_plain(xm: torch.Tensor, gm: torch.Tensor,
                        out_exp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the TN kernel: ``xᵀ @ g``."""
    return _combine_plain(xm, gm, out_exp, lambda x, g: x.t() @ g)


def _w_kmajor(wm: torch.Tensor) -> bool:
    """True when the (Lw, K, N) planes are stored as contiguous (Lw, N, K)."""
    return not wm.is_contiguous() and wm.transpose(1, 2).is_contiguous()


def _launch(lib, a: torch.Tensor, b: torch.Tensor, out_exp: torch.Tensor,
            M: int, N: int, K: int, layout: int, stream: int,
            E: int = 0) -> torch.Tensor:
    """out (M, N) = A (M, K) · B (K, N), A and B stored as ``layout`` says
    (see ``bfp_matmul_launch``); with ``E`` experts out (E, M, N), out[e] =
    A[e] · B[e] at exponent ``out_exp[e]`` over plane-major (L, E, ...)
    operands.  Allocates the output (``lib`` None: only that,
    ``_lib.launcher``)."""
    out = torch.empty((E, M, N) if E else (M, N), dtype=torch.float32,
                      device=a.device)
    if lib is None:                  # meta: the shape-only path
        return out
    err = lib.bfp_matmul_launch(a.data_ptr(), b.data_ptr(),
                                out_exp.data_ptr(), out.data_ptr(), M, N, K,
                                max(E, 1), a.shape[0], b.shape[0], layout,
                                stream)
    _lib.check(err, "bfp_matmul")
    return out


def _check(name: str, a: torch.Tensor, b: torch.Tensor, contract: tuple):
    """Shared argument checks; the operands' device kind (``cpu`` runs the
    plain version, ``cuda`` launches the kernel, ``meta`` takes the
    shape-only path)."""
    if a.dim() != 3 or b.dim() != 3 or (a.shape[contract[0]]
                                        != b.shape[contract[1]]):
        raise ValueError(f"{name} shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"{name} takes int8 limb planes")
    if not (1 <= a.shape[0] <= 3 and 1 <= b.shape[0] <= 3):
        raise ValueError(f"{name} supports 1..3 limb planes per operand")
    return _lib.device_kind(name, a, b)


def _exp(out_exp: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return out_exp.to(device=like.device, dtype=torch.int32).reshape(())


def bfp_matmul(xm: torch.Tensor, wm: torch.Tensor,
               out_exp: torch.Tensor) -> torch.Tensor:
    """NN: ``(x @ w) * 2**out_exp`` -> (M, N) f32, all limb pairs in one
    launch — the forward product.

    xm: (Lx, M, K) int8 planes; wm: (Lw, K, N) int8 planes; out_exp: int32
    0-d tensor (x_exp + w_exp).  CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.
    """
    kind = _check("bfp_matmul", xm, wm, (2, 1))
    M, K, N = xm.shape[1], xm.shape[2], wm.shape[2]
    with _lib.kernel_call(bfp_matmul, kind, (xm, wm, out_exp),
                          flops=2 * M * N * K,
                          limbs=(xm.shape[0], wm.shape[0]), K=K):
        if kind == "cpu":
            return bfp_matmul_plain(xm, wm, out_exp)
        xm = xm.contiguous()
        kmajor = _w_kmajor(wm)
        if not kmajor:
            wm = wm.contiguous()
        lib, stream = _lib.launcher(xm)
        return _launch(lib, xm, wm, _exp(out_exp, xm), M, N, K,
                       _B_KMAJOR if kmajor else _NN, stream)


def bfp_matmul_nt(gm: torch.Tensor, wm: torch.Tensor,
                  out_exp: torch.Tensor) -> torch.Tensor:
    """NT: ``(g @ wᵀ) * 2**out_exp`` -> (M, K) f32 — the dX product.

    gm: (Lg, M, N) gradient planes; wm: (Lw, K, N) weight planes in their
    forward layout (N-contiguous, so the contraction axis is contiguous in
    both operands and the kernel stages W as it is).  out_exp: g_exp +
    w_exp.  CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    """
    kind = _check("bfp_matmul_nt", gm, wm, (2, 2))
    M, K, N = gm.shape[1], wm.shape[1], gm.shape[2]
    with _lib.kernel_call(bfp_matmul_nt, kind, (gm, wm, out_exp),
                          flops=2 * M * N * K,
                          limbs=(gm.shape[0], wm.shape[0]), K=N):
        if kind == "cpu":
            return bfp_matmul_nt_plain(gm, wm, out_exp)
        gm, wm = gm.contiguous(), wm.contiguous()
        lib, stream = _lib.launcher(gm)
        return _launch(lib, gm, wm, _exp(out_exp, gm), M, K, N, _B_KMAJOR,
                       stream)


def bfp_matmul_tn(xm: torch.Tensor, gm: torch.Tensor,
                  out_exp: torch.Tensor) -> torch.Tensor:
    """TN: ``(xᵀ @ g) * 2**out_exp`` -> (K, N) f32 — the dW product.

    xm: (Lx, M, K) activation planes saved by the forward; gm: (Lg, M, N)
    gradient planes; the contraction runs over the token axis M, and the
    kernel stages both operands transposed.  out_exp: x_exp + g_exp.  CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.
    """
    kind = _check("bfp_matmul_tn", xm, gm, (1, 1))
    M, K, N = xm.shape[1], xm.shape[2], gm.shape[2]
    with _lib.kernel_call(bfp_matmul_tn, kind, (xm, gm, out_exp),
                          flops=2 * M * N * K,
                          limbs=(xm.shape[0], gm.shape[0]), K=M):
        if kind == "cpu":
            return bfp_matmul_tn_plain(xm, gm, out_exp)
        xm, gm = xm.contiguous(), gm.contiguous()
        lib, stream = _lib.launcher(xm)
        return _launch(lib, xm, gm, _exp(out_exp, xm), K, N, M, _TN, stream)


bfp_matmul.launches = 0
bfp_matmul_nt.launches = 0
bfp_matmul_tn.launches = 0


# =========================================================================
# Batched (expert-axis) products: one launch for every expert and limb pair
# =========================================================================

#: longest contraction the int32 limb-pair sums hold exactly: |product| <=
#: 127 * 127 < 2^14 for two 8-bit planes, so 2^17 terms stay below 2^31
MAX_CONTRACTION = 1 << 17


def bfp_matmul_batched_plain(xm: torch.Tensor, wm: torch.Tensor,
                             out_exp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the batched NN kernel (same arithmetic)."""
    return _combine_plain(xm, wm, out_exp.reshape(-1, 1, 1), torch.bmm)


def bfp_matmul_batched_nt_plain(gm: torch.Tensor, wm: torch.Tensor,
                                out_exp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the batched NT kernel: ``g[e] @ w[e]ᵀ``."""
    return _combine_plain(gm, wm, out_exp.reshape(-1, 1, 1),
                          lambda g, w: torch.bmm(g, w.transpose(1, 2)))


def bfp_matmul_batched_tn_plain(xm: torch.Tensor, gm: torch.Tensor,
                                out_exp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the batched TN kernel: ``x[e]ᵀ @ g[e]``."""
    return _combine_plain(xm, gm, out_exp.reshape(-1, 1, 1),
                          lambda x, g: torch.bmm(x.transpose(1, 2), g))


def _check_batched(name: str, a: torch.Tensor, b: torch.Tensor,
                   contract: tuple, out_exp: torch.Tensor) -> bool:
    """Argument checks of the batched wrappers; the operands' device kind
    (as ``_check``)."""
    if (a.dim() != 4 or b.dim() != 4 or a.shape[1] != b.shape[1]
            or a.shape[contract[0]] != b.shape[contract[1]]
            or out_exp.numel() != a.shape[1]):
        raise ValueError(f"{name} shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}, out_exp {tuple(out_exp.shape)}")
    if a.shape[contract[0]] > MAX_CONTRACTION:
        raise ValueError(f"{name}: contraction of {a.shape[contract[0]]} "
                         f"terms overflows the int32 limb-pair sums")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"{name} takes int8 limb planes")
    if not (1 <= a.shape[0] <= 3 and 1 <= b.shape[0] <= 3):
        raise ValueError(f"{name} supports 1..3 limb planes per operand")
    return _lib.device_kind(name, a, b)


def _call_batched(wrapper, plain, a: torch.Tensor, b: torch.Tensor,
                  out_exp: torch.Tensor, contract: tuple, M: int, N: int,
                  K: int, layout: int) -> torch.Tensor:
    """One call of a batched wrapper: the plain version for CPU operands,
    else the launch over every expert."""
    kind = _check_batched(wrapper.__name__, a, b, contract, out_exp)
    with _lib.kernel_call(wrapper, kind, (a, b, out_exp),
                          flops=2 * a.shape[1] * M * N * K,
                          limbs=(a.shape[0], b.shape[0]), K=K):
        if kind == "cpu":
            return plain(a, b, out_exp)
        a, b = a.contiguous(), b.contiguous()
        exp = out_exp.to(device=a.device, dtype=torch.int32).reshape(-1)
        lib, stream = _lib.launcher(a)
        return _launch(lib, a, b, exp.contiguous(), M, N, K, layout, stream,
                       E=a.shape[1])


def bfp_matmul_batched(xm: torch.Tensor, wm: torch.Tensor,
                       out_exp: torch.Tensor) -> torch.Tensor:
    """Batched NN: ``(x[e] @ w[e]) * 2**out_exp[e]`` -> (E, M, N) f32, every
    expert and limb pair in one launch — the MoE experts' forward.

    xm: (Lx, E, M, K) int8 planes; wm: (Lw, E, K, N); out_exp: (E,) int32
    (x_exp[e] + w_exp[e]).  CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    return _call_batched(bfp_matmul_batched, bfp_matmul_batched_plain, xm, wm,
                         out_exp, (3, 2), xm.shape[2], wm.shape[3],
                         xm.shape[3], _NN)


def bfp_matmul_batched_nt(gm: torch.Tensor, wm: torch.Tensor,
                          out_exp: torch.Tensor) -> torch.Tensor:
    """Batched NT: ``(g[e] @ w[e]ᵀ) * 2**out_exp[e]`` -> (E, M, K) f32 — the
    MoE experts' dX.

    gm: (Lg, E, M, N) gradient planes; wm: (Lw, E, K, N) weight planes in
    their forward layout (the contraction axis N contiguous in both, W
    staged as it is).  out_exp: (E,) g_exp + w_exp."""
    return _call_batched(bfp_matmul_batched_nt, bfp_matmul_batched_nt_plain,
                         gm, wm, out_exp, (3, 3), gm.shape[2], wm.shape[2],
                         gm.shape[3], _B_KMAJOR)


def bfp_matmul_batched_tn(xm: torch.Tensor, gm: torch.Tensor,
                          out_exp: torch.Tensor) -> torch.Tensor:
    """Batched TN: ``(x[e]ᵀ @ g[e]) * 2**out_exp[e]`` -> (E, K, N) f32 — the
    MoE experts' dW, contracting each expert's capacity rows M.

    xm: (Lx, E, M, K) activation planes saved by the forward; gm: (Lg, E,
    M, N) gradient planes; both staged transposed.  out_exp: (E,) x_exp +
    g_exp."""
    return _call_batched(bfp_matmul_batched_tn, bfp_matmul_batched_tn_plain,
                         xm, gm, out_exp, (2, 2), xm.shape[3], gm.shape[3],
                         xm.shape[2], _TN)


bfp_matmul_batched.launches = 0
bfp_matmul_batched_nt.launches = 0
bfp_matmul_batched_tn.launches = 0
