"""Block-floating-point integer matmul over int8 limb planes (NN layout).

Counterpart of ``repro/kernels/bfp_matmul.py::bfp_matmul``; the CUDA kernel
is ``csrc/bfp_matmul.cu``.

    acc[jx, jw] = X[jx] · W[jw]                      exact int32 per limb pair
    out = Σ_{jx outer, jw inner} (f32(acc) · 2^exp) · 2^(7(jx+jw))

in the fixed order of the reference's ``_combine_partials``.  ``wm`` is
``(Lw, K, N)``; its storage may be N-contiguous (a linear layer's weight)
or K-contiguous (``wm.transpose(1, 2)`` contiguous: the tied LM head's
planes, quantized in the embedding table's own layout).
"""
from __future__ import annotations

import torch

from repro_torch.core.dfx import pow2
from repro_torch.kernels import _lib
from repro_torch.kernels.dfx_quant import LIMB_BITS


def bfp_matmul_plain(xm: torch.Tensor, wm: torch.Tensor,
                     out_exp: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: each limb-pair product in float64, which is
    exact for int8 planes (|acc| < 2^53), then the ordered f32 combine."""
    scale0 = pow2(out_exp)
    out = None
    for jx in range(xm.shape[0]):
        for jw in range(wm.shape[0]):
            acc = (xm[jx].to(torch.float64) @ wm[jw].to(torch.float64))
            part = (acc.to(torch.float32) * scale0) * float(
                2 ** (LIMB_BITS * (jx + jw)))
            out = part if out is None else out + part
    return out


def _w_kmajor(wm: torch.Tensor) -> bool:
    """True when the (Lw, K, N) planes are stored as contiguous (Lw, N, K)."""
    return not wm.is_contiguous() and wm.transpose(1, 2).is_contiguous()


def _launch(lib, xm: torch.Tensor, wm: torch.Tensor, out_exp: torch.Tensor,
            stream: int) -> torch.Tensor:
    lx, M, K = xm.shape
    lw, _, N = wm.shape
    out = torch.empty((M, N), dtype=torch.float32, device=xm.device)
    err = lib.bfp_matmul_launch(xm.data_ptr(), wm.data_ptr(),
                                out_exp.data_ptr(), out.data_ptr(), M, N, K,
                                lx, lw, int(_w_kmajor(wm)), stream)
    _lib.check(err, "bfp_matmul")
    bfp_matmul.launches += 1
    return out


def bfp_matmul(xm: torch.Tensor, wm: torch.Tensor,
               out_exp: torch.Tensor) -> torch.Tensor:
    """``(x @ w) * 2**out_exp`` -> (M, N) f32, all limb pairs in one launch.

    xm: (Lx, M, K) int8 planes; wm: (Lw, K, N) int8 planes; out_exp: int32
    0-d tensor (x_exp + w_exp).  CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.
    """
    if xm.dim() != 3 or wm.dim() != 3 or xm.shape[2] != wm.shape[1]:
        raise ValueError(f"bfp_matmul shapes {tuple(xm.shape)} x "
                         f"{tuple(wm.shape)}")
    if xm.dtype != torch.int8 or wm.dtype != torch.int8:
        raise TypeError("bfp_matmul takes int8 limb planes")
    if not (1 <= xm.shape[0] <= 3 and 1 <= wm.shape[0] <= 3):
        raise ValueError("bfp_matmul supports 1..3 limb planes per operand")
    if xm.device.type == "cpu":
        return bfp_matmul_plain(xm, wm, out_exp)
    if xm.device.type != "cuda" or wm.device != xm.device:
        raise ValueError(f"bfp_matmul: unsupported devices {xm.device}, "
                         f"{wm.device}")
    xm = xm.contiguous()
    if not _w_kmajor(wm):
        wm = wm.contiguous()
    out_exp = out_exp.to(device=xm.device, dtype=torch.int32).reshape(())
    return _launch(_lib.load(), xm, wm, out_exp, _lib.stream_of(xm))


bfp_matmul.launches = 0
