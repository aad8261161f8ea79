"""Integer layer-norm and RMS-norm, forward and backward, over DFX
mantissas.

Counterpart of ``repro/kernels/int_norm.py::int_layernorm_fwd``,
``int_layernorm_bwd``, ``int_rmsnorm_fwd`` and ``int_rmsnorm_bwd``; the
CUDA kernels are in
``csrc/int_norm.cu``.  Σx is an exact int sum and Σx² is exact too: the
mantissa is split into balanced base-2⁸ digits ``x = hi·2⁸ + lo`` and the
three int32 digit sums recombine in f32 as ``a·65536 + b·512 + c`` (the
reference's ``_exact_moments``).  The rsqrt is ``1 / sqrt`` with IEEE sqrt
and division.  The forwards return the per-row statistics they normalised
with; the backwards take them back as their residuals.
"""
from __future__ import annotations

import torch

from repro_torch.core.dfx import pow2
from repro_torch.kernels import _lib


def exact_sum(xm: torch.Tensor) -> torch.Tensor:
    """Row sums of integer mantissas, exact, cast once to f32 (R, 1)."""
    return xm.to(torch.int64).sum(-1, keepdim=True).to(torch.float32)


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


def _div(a: torch.Tensor, d: int) -> torch.Tensor:
    """``a / d`` as an IEEE division on every device (PyTorch turns a
    division by a Python number on the card into a reciprocal multiply,
    which the kernels do not do)."""
    return a / torch.full((), float(d), dtype=a.dtype, device=a.device)


def int_layernorm_fwd_plain(xm: torch.Tensor, x_exp: torch.Tensor,
                            gamma: torch.Tensor, beta: torch.Tensor, *,
                            eps: float = 1e-5):
    """Plain PyTorch version of the layer-norm forward kernel (same
    arithmetic).  Returns ``(y, mu, rstd)``."""
    d = xm.shape[-1]
    scale = pow2(x_exp)
    mu_m = _div(exact_sum(xm), d)
    var_m = torch.clamp(_div(exact_sq_sum(xm), d) - mu_m * mu_m, min=0.0)
    mu = mu_m * scale
    rstd = 1.0 / torch.sqrt(var_m * (scale * scale) + eps)
    y = ((xm.to(torch.float32) * scale - mu) * rstd) * gamma + beta
    return y, mu, rstd


def int_layernorm_bwd_plain(xm: torch.Tensor, gm: torch.Tensor,
                            x_exp: torch.Tensor, g_exp: torch.Tensor,
                            gamma: torch.Tensor, mu: torch.Tensor,
                            rstd: torch.Tensor):
    """Plain PyTorch version of the layer-norm backward kernel.  Returns
    ``(dx, dgamma, dbeta)``; dbeta is the exact int sum of the gradient
    mantissas, scaled once."""
    d = xm.shape[-1]
    xn = (xm.to(torch.float32) * pow2(x_exp) - mu) * rstd
    gs = pow2(g_exp)
    gq = gm.to(torch.float32) * gs
    gg = gq * gamma
    mean_gg = _div(gg.sum(-1, keepdim=True), d)
    mean_ggxn = _div((gg * xn).sum(-1, keepdim=True), d)
    dx = rstd * ((gg - mean_gg) - xn * mean_ggxn)
    dbeta = gm.to(torch.int64).sum(0).to(torch.float32) * gs
    return dx, (gq * xn).sum(0), dbeta


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


def _check_ln(name: str, xm: torch.Tensor, *rows: torch.Tensor) -> bool:
    """Shared argument checks; True when the plain version should run."""
    if xm.dim() != 2 or any(r.shape != xm.shape for r in rows):
        raise ValueError(f"{name} shapes {tuple(xm.shape)}, "
                         f"{[tuple(r.shape) for r in rows]}")
    for t in (xm,) + rows:
        if t.dtype not in (torch.int8, torch.int16):
            raise TypeError(f"{name} takes int8/int16 mantissas, got "
                            f"{t.dtype}")
    if xm.device.type == "cpu":
        return True
    if xm.device.type != "cuda" or any(r.device != xm.device for r in rows):
        raise ValueError(f"{name}: unsupported device {xm.device}")
    return False


def _vec(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(device=like.device, dtype=torch.float32).contiguous()


def _exp(e: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return e.to(device=like.device, dtype=torch.int32).reshape(())


def _launch_ln_fwd(lib, xm, x_exp, gamma, beta, eps, stream):
    R, D = xm.shape
    y = torch.empty((R, D), dtype=torch.float32, device=xm.device)
    mu = torch.empty((R, 1), dtype=torch.float32, device=xm.device)
    rstd = torch.empty((R, 1), dtype=torch.float32, device=xm.device)
    err = lib.int_layernorm_fwd_launch(
        xm.data_ptr(), xm.element_size(), x_exp.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), y.data_ptr(), mu.data_ptr(), rstd.data_ptr(), R, D,
        float(eps), stream)
    _lib.check(err, "int_layernorm_fwd")
    return y, mu, rstd


def int_layernorm_fwd(xm: torch.Tensor, x_exp: torch.Tensor,
                      gamma: torch.Tensor, beta: torch.Tensor, *,
                      eps: float = 1e-5):
    """Fused layer-norm forward over (R, D) int8/int16 mantissas ->
    ``(y, mu, rstd)``: y (R, D) f32 and the (R, 1) value-domain statistics
    it normalised with.  CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor."""
    D = xm.shape[-1]
    if gamma.shape != (D,) or beta.shape != (D,):
        raise ValueError(f"int_layernorm_fwd gamma/beta {tuple(gamma.shape)}"
                         f", {tuple(beta.shape)} for D={D}")
    if _check_ln("int_layernorm_fwd", xm):
        return int_layernorm_fwd_plain(xm, x_exp, gamma, beta, eps=eps)
    out = _launch_ln_fwd(_lib.load(), xm.contiguous(), _exp(x_exp, xm),
                         _vec(gamma, xm), _vec(beta, xm), eps,
                         _lib.stream_of(xm))
    int_layernorm_fwd.launches += 1
    return out


def _launch_ln_bwd(lib, xm, gm, x_exp, g_exp, gamma, mu, rstd, stream):
    R, D = xm.shape
    nb = -(-R // lib.int_layernorm_bwd_rows())
    dev = xm.device
    dx = torch.empty((R, D), dtype=torch.float32, device=dev)
    dgamma = torch.empty((D,), dtype=torch.float32, device=dev)
    dbeta = torch.empty((D,), dtype=torch.float32, device=dev)
    dg_part = torch.empty((nb, D), dtype=torch.float32, device=dev)
    db_part = torch.empty((nb, D), dtype=torch.int32, device=dev)
    err = lib.int_layernorm_bwd_launch(
        xm.data_ptr(), xm.element_size(), gm.data_ptr(), gm.element_size(),
        x_exp.data_ptr(), g_exp.data_ptr(), gamma.data_ptr(), mu.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
        dg_part.data_ptr(), db_part.data_ptr(), R, D, stream)
    _lib.check(err, "int_layernorm_bwd")
    return dx, dgamma, dbeta


def int_layernorm_bwd(xm: torch.Tensor, gm: torch.Tensor,
                      x_exp: torch.Tensor, g_exp: torch.Tensor,
                      gamma: torch.Tensor, mu: torch.Tensor,
                      rstd: torch.Tensor):
    """Fused layer-norm backward -> ``(dx, dgamma, dbeta)``.

    xm: (R, D) activation mantissas (the forward's residual); gm: (R, D)
    quantized upstream-gradient mantissas; mu, rstd: (R, 1) forward-saved
    statistics; gamma: (D,) the dequantized weight.  The column sums come
    out whole (the kernel's per-block partials are summed on the card in a
    second, ordered pass).  CUDA kernels for CUDA tensors, the plain version
    for CPU tensors.
    """
    R, D = xm.shape
    if gamma.shape != (D,) or mu.shape != (R, 1) or rstd.shape != (R, 1):
        raise ValueError("int_layernorm_bwd: gamma (D,), mu and rstd (R, 1) "
                         "expected")
    if _check_ln("int_layernorm_bwd", xm, gm):
        return int_layernorm_bwd_plain(xm, gm, x_exp, g_exp, gamma, mu, rstd)
    out = _launch_ln_bwd(_lib.load(), xm.contiguous(), gm.contiguous(),
                         _exp(x_exp, xm), _exp(g_exp, xm), _vec(gamma, xm),
                         _vec(mu, xm), _vec(rstd, xm), _lib.stream_of(xm))
    int_layernorm_bwd.launches += 1
    return out


def int_rmsnorm_bwd_plain(xm: torch.Tensor, gm: torch.Tensor,
                          x_exp: torch.Tensor, g_exp: torch.Tensor,
                          gamma: torch.Tensor, rstd: torch.Tensor):
    """Plain PyTorch version of the RMS-norm backward kernel.  Returns
    ``(dx, dgamma)``."""
    d = xm.shape[-1]
    xn = (xm.to(torch.float32) * pow2(x_exp)) * rstd
    gq = gm.to(torch.float32) * pow2(g_exp)
    gg = gq * gamma
    mean_ggxn = _div((gg * xn).sum(-1, keepdim=True), d)
    dx = rstd * (gg - xn * mean_ggxn)
    return dx, (gq * xn).sum(0)


def _launch_rms_bwd(lib, xm, gm, x_exp, g_exp, gamma, rstd, stream):
    R, D = xm.shape
    nb = -(-R // lib.int_layernorm_bwd_rows())
    dev = xm.device
    dx = torch.empty((R, D), dtype=torch.float32, device=dev)
    dgamma = torch.empty((D,), dtype=torch.float32, device=dev)
    dg_part = torch.empty((nb, D), dtype=torch.float32, device=dev)
    err = lib.int_rmsnorm_bwd_launch(
        xm.data_ptr(), xm.element_size(), gm.data_ptr(), gm.element_size(),
        x_exp.data_ptr(), g_exp.data_ptr(), gamma.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
        dg_part.data_ptr(), R, D, stream)
    _lib.check(err, "int_rmsnorm_bwd")
    return dx, dgamma


def int_rmsnorm_bwd(xm: torch.Tensor, gm: torch.Tensor, x_exp: torch.Tensor,
                    g_exp: torch.Tensor, gamma: torch.Tensor,
                    rstd: torch.Tensor):
    """Fused RMS-norm backward -> ``(dx, dgamma)``.

    xm: (R, D) activation mantissas (the forward's residual); gm: (R, D)
    quantized upstream-gradient mantissas; rstd: (R, 1) the forward's
    statistic; gamma: (D,) the dequantized weight.  dgamma comes out whole
    (per-block partials summed on the card in block order).  CUDA kernels
    for CUDA tensors, the plain version for CPU tensors."""
    R, D = xm.shape
    if gamma.shape != (D,) or rstd.shape != (R, 1):
        raise ValueError("int_rmsnorm_bwd: gamma (D,) and rstd (R, 1) "
                         "expected")
    if _check_ln("int_rmsnorm_bwd", xm, gm):
        return int_rmsnorm_bwd_plain(xm, gm, x_exp, g_exp, gamma, rstd)
    out = _launch_rms_bwd(_lib.load(), xm.contiguous(), gm.contiguous(),
                          _exp(x_exp, xm), _exp(g_exp, xm), _vec(gamma, xm),
                          _vec(rstd, xm), _lib.stream_of(xm))
    int_rmsnorm_bwd.launches += 1
    return out


int_layernorm_fwd.launches = 0
int_layernorm_bwd.launches = 0
int_rmsnorm_bwd.launches = 0
