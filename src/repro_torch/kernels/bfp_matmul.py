"""Block-floating-point integer matmul over int8 limb planes: the forward
product (NN) and the two backward products (NT for dX, TN for dW).

Counterpart of ``repro/kernels/bfp_matmul.py::bfp_matmul``,
``bfp_matmul_nt`` and ``bfp_matmul_tn``; one CUDA kernel source,
``csrc/bfp_matmul.cu``, serves all three layouts.

    acc[ja, jb] = A[ja] · B[jb]                      exact int32 per limb pair
    out = Σ_{ja outer, jb inner} (f32(acc) · 2^exp) · 2^(7(ja+jb))

in the fixed order of the reference's ``_combine_partials``, where
(A, B) is (X, W) for NN, (G, Wᵀ) for NT and (Xᵀ, G) for TN.  Every operand
keeps the layout its producer wrote: the transposes happen while the
kernel stages its tiles into shared memory.  NN's ``wm`` is ``(Lw, K, N)``;
its storage may be N-contiguous (a linear layer's weight) or K-contiguous
(``wm.transpose(1, 2)`` contiguous: the tied LM head's planes, quantized in
the embedding table's own layout).
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
            M: int, N: int, K: int, layout: int, stream: int) -> torch.Tensor:
    """out (M, N) = A (M, K) · B (K, N), A and B stored as ``layout`` says
    (see ``bfp_matmul_launch``); allocates the output."""
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    err = lib.bfp_matmul_launch(a.data_ptr(), b.data_ptr(),
                                out_exp.data_ptr(), out.data_ptr(), M, N, K,
                                a.shape[0], b.shape[0], layout, stream)
    _lib.check(err, "bfp_matmul")
    return out


def _check(name: str, a: torch.Tensor, b: torch.Tensor, contract: tuple):
    """Shared argument checks; True when the plain version should run."""
    if a.dim() != 3 or b.dim() != 3 or (a.shape[contract[0]]
                                        != b.shape[contract[1]]):
        raise ValueError(f"{name} shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"{name} takes int8 limb planes")
    if not (1 <= a.shape[0] <= 3 and 1 <= b.shape[0] <= 3):
        raise ValueError(f"{name} supports 1..3 limb planes per operand")
    if a.device.type == "cpu":
        return True
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"{name}: unsupported devices {a.device}, "
                         f"{b.device}")
    return False


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
    if _check("bfp_matmul", xm, wm, (2, 1)):
        return bfp_matmul_plain(xm, wm, out_exp)
    xm = xm.contiguous()
    kmajor = _w_kmajor(wm)
    if not kmajor:
        wm = wm.contiguous()
    out = _launch(_lib.load(), xm, wm, _exp(out_exp, xm), xm.shape[1],
                  wm.shape[2], xm.shape[2], _B_KMAJOR if kmajor else _NN,
                  _lib.stream_of(xm))
    bfp_matmul.launches += 1
    return out


def bfp_matmul_nt(gm: torch.Tensor, wm: torch.Tensor,
                  out_exp: torch.Tensor) -> torch.Tensor:
    """NT: ``(g @ wᵀ) * 2**out_exp`` -> (M, K) f32 — the dX product.

    gm: (Lg, M, N) gradient planes; wm: (Lw, K, N) weight planes in their
    forward layout (N-contiguous, so the contraction axis is contiguous in
    both operands and the kernel stages W as it is).  out_exp: g_exp +
    w_exp.  CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    """
    if _check("bfp_matmul_nt", gm, wm, (2, 2)):
        return bfp_matmul_nt_plain(gm, wm, out_exp)
    gm, wm = gm.contiguous(), wm.contiguous()
    out = _launch(_lib.load(), gm, wm, _exp(out_exp, gm), gm.shape[1],
                  wm.shape[1], gm.shape[2], _B_KMAJOR, _lib.stream_of(gm))
    bfp_matmul_nt.launches += 1
    return out


def bfp_matmul_tn(xm: torch.Tensor, gm: torch.Tensor,
                  out_exp: torch.Tensor) -> torch.Tensor:
    """TN: ``(xᵀ @ g) * 2**out_exp`` -> (K, N) f32 — the dW product.

    xm: (Lx, M, K) activation planes saved by the forward; gm: (Lg, M, N)
    gradient planes; the contraction runs over the token axis M, and the
    kernel stages both operands transposed.  out_exp: x_exp + g_exp.  CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.
    """
    if _check("bfp_matmul_tn", xm, gm, (1, 1)):
        return bfp_matmul_tn_plain(xm, gm, out_exp)
    xm, gm = xm.contiguous(), gm.contiguous()
    out = _launch(_lib.load(), xm, gm, _exp(out_exp, xm), xm.shape[2],
                  gm.shape[2], xm.shape[1], _TN, _lib.stream_of(xm))
    bfp_matmul_tn.launches += 1
    return out


bfp_matmul.launches = 0
bfp_matmul_nt.launches = 0
bfp_matmul_tn.launches = 0
