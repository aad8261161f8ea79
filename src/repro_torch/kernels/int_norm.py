"""Integer RMS-norm forward over DFX mantissas.

Counterpart of ``repro/kernels/int_norm.py::int_rmsnorm_fwd``; the CUDA
kernel is ``csrc/int_norm.cu``.  Σx² is exact: the mantissa is split into
balanced base-2⁸ digits ``x = hi·2⁸ + lo`` and the three int32 digit sums
recombine in f32 as ``a·65536 + b·512 + c`` (the reference's
``_exact_moments``).  The rsqrt is ``1 / sqrt`` with IEEE sqrt and division.
Returns ``(y, rstd)``: y (R, D) f32 and rstd (R, 1) f32.
"""
from __future__ import annotations

import torch

from repro_torch.core.dfx import pow2
from repro_torch.kernels import _lib


def exact_sq_sum(xm: torch.Tensor) -> torch.Tensor:
    """Row sums of x² over integer mantissas, f32 (R, 1), via the base-2⁸
    digit split (exact int sums, one f32 recombination)."""
    xi = xm.to(torch.int32)
    lo = ((xi + 128) & 255) - 128
    hi = (xi - lo) >> 8
    a = (hi * hi).sum(-1, keepdim=True).to(torch.float32)
    b = (hi * lo).sum(-1, keepdim=True).to(torch.float32)
    c = (lo * lo).sum(-1, keepdim=True).to(torch.float32)
    return a * 65536.0 + b * 512.0 + c


def int_rmsnorm_fwd_plain(xm: torch.Tensor, x_exp: torch.Tensor,
                          gamma: torch.Tensor, *, eps: float = 1e-6):
    """Plain PyTorch version of the kernel (same arithmetic)."""
    d = xm.shape[-1]
    scale = pow2(x_exp)
    ms = (exact_sq_sum(xm) / d) * (scale * scale)
    rstd = 1.0 / torch.sqrt(ms + eps)
    y = ((xm.to(torch.float32) * scale) * rstd) * gamma
    return y, rstd


def _launch(lib, xm: torch.Tensor, x_exp: torch.Tensor, gamma: torch.Tensor,
            eps: float, stream: int):
    R, D = xm.shape
    y = torch.empty((R, D), dtype=torch.float32, device=xm.device)
    rstd = torch.empty((R, 1), dtype=torch.float32, device=xm.device)
    err = lib.int_rmsnorm_fwd_launch(xm.data_ptr(), xm.element_size(),
                                     x_exp.data_ptr(), gamma.data_ptr(),
                                     y.data_ptr(), rstd.data_ptr(), R, D,
                                     float(eps), stream)
    _lib.check(err, "int_rmsnorm_fwd")
    int_rmsnorm_fwd.launches += 1
    return y, rstd


def int_rmsnorm_fwd(xm: torch.Tensor, x_exp: torch.Tensor,
                    gamma: torch.Tensor, *, eps: float = 1e-6):
    """Fused RMS-norm forward over (R, D) int8/int16 mantissas.  CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if xm.dim() != 2 or gamma.shape != (xm.shape[1],):
        raise ValueError(f"int_rmsnorm_fwd shapes {tuple(xm.shape)}, "
                         f"{tuple(gamma.shape)}")
    if xm.dtype not in (torch.int8, torch.int16):
        raise TypeError(f"int_rmsnorm_fwd takes int8/int16 mantissas, got "
                        f"{xm.dtype}")
    if xm.device.type == "cpu":
        return int_rmsnorm_fwd_plain(xm, x_exp, gamma, eps=eps)
    if xm.device.type != "cuda":
        raise ValueError(f"int_rmsnorm_fwd: unsupported device {xm.device}")
    x_exp = x_exp.to(device=xm.device, dtype=torch.int32).reshape(())
    gamma = gamma.to(device=xm.device, dtype=torch.float32).contiguous()
    return _launch(_lib.load(), xm.contiguous(), x_exp, gamma, eps,
                   _lib.stream_of(xm))


int_rmsnorm_fwd.launches = 0
