"""Integer layer-norm and RMS-norm, forward and backward, over DFX
mantissas.

Counterpart of ``repro/kernels/int_norm.py::int_layernorm_fwd``,
``int_layernorm_bwd``, ``int_rmsnorm_fwd`` and ``int_rmsnorm_bwd``; the
CUDA kernels are in
``csrc/int_norm.cu``.  Σx is an exact int sum and Σx² is exact too: the
mantissa is split into balanced base-2⁸ digits ``x = hi·2⁸ + lo`` and the
three int32 digit sums recombine in f32 as ``a·65536 + b·512 + c`` (the
reference's ``_exact_moments``).  The rsqrt is ``1 / sqrt`` with IEEE sqrt
and division, or under ``integer_rsqrt`` (``kept_ops="integer"``, the
reference's ``_rstd``) the Q.14 Newton form ``core/iapprox.py::i_rsqrt``:
the same launch with another body.  The forwards return the per-row
statistics they normalised with; the backwards take them back as their
residuals, so they need no flag.
"""
from __future__ import annotations

import torch

from repro_torch.core.dfx import pow2
from repro_torch.core.iapprox import i_rsqrt
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


def _rstd(ms: torch.Tensor, eps: float, integer_rsqrt: bool):
    """``1 / sqrt(ms + eps)``, or ``i_rsqrt(ms + eps)``."""
    if integer_rsqrt:
        return i_rsqrt(ms + eps)
    return 1.0 / torch.sqrt(ms + eps)


def int_layernorm_fwd_plain(xm: torch.Tensor, x_exp: torch.Tensor,
                            gamma: torch.Tensor, beta: torch.Tensor, *,
                            eps: float = 1e-5, integer_rsqrt: bool = False):
    """Plain PyTorch version of the layer-norm forward kernel (same
    arithmetic).  Returns ``(y, mu, rstd)``."""
    d = xm.shape[-1]
    scale = pow2(x_exp)
    mu_m = _div(exact_sum(xm), d)
    var_m = torch.clamp(_div(exact_sq_sum(xm), d) - mu_m * mu_m, min=0.0)
    mu = mu_m * scale
    rstd = _rstd(var_m * (scale * scale), eps, integer_rsqrt)
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
                          gamma: torch.Tensor, *, eps: float = 1e-6,
                          integer_rsqrt: bool = False):
    """Plain PyTorch version of the kernel (same arithmetic)."""
    d = xm.shape[-1]
    scale = pow2(x_exp)
    ms = _div(exact_sq_sum(xm), d) * (scale * scale)
    rstd = _rstd(ms, eps, integer_rsqrt)
    y = ((xm.to(torch.float32) * scale) * rstd) * gamma
    return y, rstd


def _launch(lib, xm: torch.Tensor, x_exp: torch.Tensor, gamma: torch.Tensor,
            eps: float, integer_rsqrt: bool, stream: int, wr=None):
    """One launch of the RMS-norm forward -> ``(y, rstd)``; ``wr`` None takes
    the plan's path, 0 the any-shape body."""
    R, D = xm.shape
    y = torch.empty((R, D), dtype=torch.float32, device=xm.device)
    rstd = torch.empty((R, 1), dtype=torch.float32, device=xm.device)
    if lib is None:                  # meta: the shape-only path
        return y, rstd
    wr, gpb, nb = _fwd_plan(xm, (gamma, y), wr)
    err = lib.int_rmsnorm_fwd_launch(xm.data_ptr(), xm.element_size(),
                                     x_exp.data_ptr(), gamma.data_ptr(),
                                     y.data_ptr(), rstd.data_ptr(), R, D,
                                     float(eps), int(integer_rsqrt), wr, gpb,
                                     nb, stream)
    _lib.check(err, "int_rmsnorm_fwd")
    return y, rstd


def int_rmsnorm_fwd(xm: torch.Tensor, x_exp: torch.Tensor,
                    gamma: torch.Tensor, *, eps: float = 1e-6,
                    integer_rsqrt: bool = False):
    """Fused RMS-norm forward over (R, D) int8/int16 mantissas ->
    ``(y, rstd)``; ``integer_rsqrt`` takes the rsqrt's Q.14 Newton body.
    CUDA kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if xm.dim() != 2 or gamma.shape != (xm.shape[1],):
        raise ValueError(f"int_rmsnorm_fwd shapes {tuple(xm.shape)}, "
                         f"{tuple(gamma.shape)}")
    if xm.dtype not in (torch.int8, torch.int16):
        raise TypeError(f"int_rmsnorm_fwd takes int8/int16 mantissas, got "
                        f"{xm.dtype}")
    kind = _lib.device_kind("int_rmsnorm_fwd", xm)
    with _lib.kernel_call(int_rmsnorm_fwd, kind, (xm, x_exp, gamma),
                          bits=_bits(xm), D=xm.shape[1], R=xm.shape[0]):
        if kind == "cpu":
            return int_rmsnorm_fwd_plain(xm, x_exp, gamma, eps=eps,
                                         integer_rsqrt=integer_rsqrt)
        x_exp = x_exp.to(device=xm.device, dtype=torch.int32).reshape(())
        gamma = gamma.to(device=xm.device, dtype=torch.float32).contiguous()
        lib, stream = _lib.launcher(xm)
        return _launch(lib, xm.contiguous(), x_exp, gamma, eps,
                       integer_rsqrt, stream)


int_rmsnorm_fwd.launches = 0


def _check_ln(name: str, xm: torch.Tensor, *rows: torch.Tensor) -> bool:
    """Shared argument checks; the operands' device kind (``cpu`` runs the
    plain version, ``cuda`` launches the kernel, ``meta`` takes the
    shape-only path)."""
    if xm.dim() != 2 or any(r.shape != xm.shape for r in rows):
        raise ValueError(f"{name} shapes {tuple(xm.shape)}, "
                         f"{[tuple(r.shape) for r in rows]}")
    for t in (xm,) + rows:
        if t.dtype not in (torch.int8, torch.int16):
            raise TypeError(f"{name} takes int8/int16 mantissas, got "
                            f"{t.dtype}")
    return _lib.device_kind(name, xm, *rows)


def _bits(xm: torch.Tensor) -> int:
    """Storage bits of a norm kernel's mantissas (8 or 16)."""
    return 8 * xm.element_size()


def _vec(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.to(device=like.device, dtype=torch.float32).contiguous()


def _exp(e: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return e.to(device=like.device, dtype=torch.int32).reshape(())


def _launch_ln_fwd(lib, xm, x_exp, gamma, beta, eps, integer_rsqrt, stream,
                   wr=None):
    """One launch of the layer-norm forward -> ``(y, mu, rstd)``; ``wr`` as
    in ``_launch``."""
    R, D = xm.shape
    y = torch.empty((R, D), dtype=torch.float32, device=xm.device)
    mu = torch.empty((R, 1), dtype=torch.float32, device=xm.device)
    rstd = torch.empty((R, 1), dtype=torch.float32, device=xm.device)
    if lib is None:                  # meta: the shape-only path
        return y, mu, rstd
    wr, gpb, nb = _fwd_plan(xm, (gamma, beta, y), wr)
    err = lib.int_layernorm_fwd_launch(
        xm.data_ptr(), xm.element_size(), x_exp.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), y.data_ptr(), mu.data_ptr(), rstd.data_ptr(), R, D,
        float(eps), int(integer_rsqrt), wr, gpb, nb, stream)
    _lib.check(err, "int_layernorm_fwd")
    return y, mu, rstd


def int_layernorm_fwd(xm: torch.Tensor, x_exp: torch.Tensor,
                      gamma: torch.Tensor, beta: torch.Tensor, *,
                      eps: float = 1e-5, integer_rsqrt: bool = False):
    """Fused layer-norm forward over (R, D) int8/int16 mantissas ->
    ``(y, mu, rstd)``: y (R, D) f32 and the (R, 1) value-domain statistics
    it normalised with; ``integer_rsqrt`` takes the rsqrt's Q.14 Newton
    body.  CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    D = xm.shape[-1]
    if gamma.shape != (D,) or beta.shape != (D,):
        raise ValueError(f"int_layernorm_fwd gamma/beta {tuple(gamma.shape)}"
                         f", {tuple(beta.shape)} for D={D}")
    kind = _check_ln("int_layernorm_fwd", xm)
    with _lib.kernel_call(int_layernorm_fwd, kind, (xm, x_exp, gamma, beta),
                          bits=_bits(xm), D=D, R=xm.shape[0]):
        if kind == "cpu":
            return int_layernorm_fwd_plain(xm, x_exp, gamma, beta, eps=eps,
                                           integer_rsqrt=integer_rsqrt)
        lib, stream = _lib.launcher(xm)
        return _launch_ln_fwd(lib, xm.contiguous(), _exp(x_exp, xm),
                              _vec(gamma, xm), _vec(beta, xm), eps,
                              integer_rsqrt, stream)


#: the register paths' plan (``csrc/int_norm.cu``, forwards and
#: backwards): warps per block, columns per unit (the backwards' 8- or
#: 16-byte load of a lane; the forwards load half a unit at a time, under
#: the same alignment), columns a warp keeps in registers, warps per row at
#: most
BWD_WARPS, BWD_VEC, BWD_WARP_COLS, BWD_MAX_WR = 8, 8, 512, 8

_resident: dict = {}

#: co-resident blocks the shape-only (meta) path assumes for the backward's
#: cooperative grid, which sizes its (blocks, D) partial sums: an H100's
#: 132 SMs at 4 blocks of 8 warps (the card asks the occupancy API)
DRY_RESIDENT = 4 * 132


def fwd_warps_per_row(D: int, aligned: bool) -> int:
    """Warps per row of the register path (1, 2, 4 or 8: the fewest whose
    512 columns each cover D), or 0 for the any-shape path: D not a
    multiple of 8, a base not aligned for the unit loads, or D > 4096.  The
    forwards and the backwards share the rule."""
    if not aligned or D % BWD_VEC:
        return 0
    wr = 1
    while wr * BWD_WARP_COLS < D:
        wr *= 2
    return wr if wr <= BWD_MAX_WR else 0


bwd_warps_per_row = fwd_warps_per_row


#: resident warps a streaming multiprocessor the forward's grid aims at
#: (gpb * wr * nb = 16 * SMs): among the fastest grids on the H100 at
#: every main shape (``tools/norm_fwd_grid.py``); more groups leave each
#: fewer rows to load ahead, fewer leave bytes out of flight
FWD_WARPS_PER_SM = 16


def fwd_blocks(R: int, wr: int, sms: int) -> tuple:
    """``(gpb, nb)`` of the forward's register path: gpb rows a block at a
    time (8 / wr, halved while the blocks would not fill the sms SMs) and
    nb blocks (one for each gpb rows, at most FWD_WARPS_PER_SM warps a
    SM); the groups stride over the rows."""
    gpb = BWD_WARPS // wr
    while gpb > 1 and -(-R // gpb) < sms:
        gpb //= 2
    cap = -(-FWD_WARPS_PER_SM * sms // (wr * gpb))
    return gpb, max(1, min(-(-R // gpb), cap))


_sms: dict = {}


def _fwd_plan(xm: torch.Tensor, f32: tuple, wr) -> tuple:
    """``(wr, gpb, nb)`` of a forward launch: the register path when D and
    every base allow it (``wr`` None), or the any-shape body (``wr`` 0)."""
    R, D = xm.shape
    if wr is None:
        wr = fwd_warps_per_row(D, xm.data_ptr() % (BWD_VEC * xm.element_size())
                               == 0 and all(t.data_ptr() % 16 == 0
                                            for t in f32))
    if not wr:
        return 0, 0, 0
    dev = xm.device
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    return (wr,) + fwd_blocks(R, wr, _sms[dev])


def bwd_blocks(R: int, wr: int, resident: int) -> int:
    """Blocks of the cooperative launch: as many as the rows need (8 / wr
    rows at a time a block, one on the any-shape path), at most the
    co-resident count, at least one (R = 0 still writes zero sums)."""
    per_block = BWD_WARPS // wr if wr else 1
    return max(1, min(resident, -(-R // per_block)))


def _launch_bwd(lib, ln, xm, gm, x_exp, g_exp, gamma, mu, rstd, stream):
    """One cooperative launch of the layer-norm (``ln``) or RMS-norm
    backward -> ``(dx, dgamma, dbeta or None)``."""
    R, D = xm.shape
    dev = xm.device
    dx = torch.empty((R, D), dtype=torch.float32, device=dev)
    dgamma = torch.empty((D,), dtype=torch.float32, device=dev)
    xp, gp, gap = xm.data_ptr(), gm.data_ptr(), gamma.data_ptr()
    xb, gb = xm.element_size(), gm.element_size()
    wr = bwd_warps_per_row(D, xp % (BWD_VEC * xb) == 0
                           and gp % (BWD_VEC * gb) == 0 and gap % 16 == 0
                           and dx.data_ptr() % 16 == 0)
    key = (dev, xb, gb, ln, wr > 0)
    if key not in _resident:
        n = DRY_RESIDENT if lib is None else lib.int_norm_bwd_resident(
            dev.index or 0, xb, gb, int(ln), int(wr > 0))
        if n < 1:
            raise RuntimeError(f"int_norm_bwd_resident: {n} co-resident "
                               "blocks (a negative CUDA error)")
        _resident[key] = n
    nb = bwd_blocks(R, wr, _resident[key])
    dg_part = torch.empty((nb, D), dtype=torch.float32, device=dev)
    if ln:
        dbeta = torch.empty((D,), dtype=torch.float32, device=dev)
        db_part = torch.empty((nb, D), dtype=torch.int32, device=dev)
        if lib is None:
            return dx, dgamma, dbeta
        err = lib.int_layernorm_bwd_launch(
            xp, xb, gp, gb, x_exp.data_ptr(), g_exp.data_ptr(), gap,
            mu.data_ptr(), rstd.data_ptr(), dx.data_ptr(), dgamma.data_ptr(),
            dbeta.data_ptr(), dg_part.data_ptr(), db_part.data_ptr(), R, D,
            wr, nb, stream)
        _lib.check(err, "int_layernorm_bwd")
        return dx, dgamma, dbeta
    if lib is None:
        return dx, dgamma, None
    err = lib.int_rmsnorm_bwd_launch(
        xp, xb, gp, gb, x_exp.data_ptr(), g_exp.data_ptr(), gap,
        rstd.data_ptr(), dx.data_ptr(), dgamma.data_ptr(), dg_part.data_ptr(),
        R, D, wr, nb, stream)
    _lib.check(err, "int_rmsnorm_bwd")
    return dx, dgamma, None


def int_layernorm_bwd(xm: torch.Tensor, gm: torch.Tensor,
                      x_exp: torch.Tensor, g_exp: torch.Tensor,
                      gamma: torch.Tensor, mu: torch.Tensor,
                      rstd: torch.Tensor):
    """Fused layer-norm backward -> ``(dx, dgamma, dbeta)``.

    xm: (R, D) activation mantissas (the forward's residual); gm: (R, D)
    quantized upstream-gradient mantissas; mu, rstd: (R, 1) forward-saved
    statistics; gamma: (D,) the dequantized weight.  The column sums come
    out whole (the kernel's per-block partials are summed after a grid
    barrier in the same launch, in a fixed order).  CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.
    """
    R, D = xm.shape
    if gamma.shape != (D,) or mu.shape != (R, 1) or rstd.shape != (R, 1):
        raise ValueError("int_layernorm_bwd: gamma (D,), mu and rstd (R, 1) "
                         "expected")
    kind = _check_ln("int_layernorm_bwd", xm, gm)
    with _lib.kernel_call(int_layernorm_bwd, kind,
                          (xm, gm, x_exp, g_exp, gamma, mu, rstd),
                          bits=_bits(xm), D=D, R=R):
        if kind == "cpu":
            return int_layernorm_bwd_plain(xm, gm, x_exp, g_exp, gamma, mu,
                                           rstd)
        lib, stream = _lib.launcher(xm)
        return _launch_bwd(lib, True, xm.contiguous(), gm.contiguous(),
                           _exp(x_exp, xm), _exp(g_exp, xm), _vec(gamma, xm),
                           _vec(mu, xm), _vec(rstd, xm), stream)


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


def int_rmsnorm_bwd(xm: torch.Tensor, gm: torch.Tensor, x_exp: torch.Tensor,
                    g_exp: torch.Tensor, gamma: torch.Tensor,
                    rstd: torch.Tensor):
    """Fused RMS-norm backward -> ``(dx, dgamma)``.

    xm: (R, D) activation mantissas (the forward's residual); gm: (R, D)
    quantized upstream-gradient mantissas; rstd: (R, 1) the forward's
    statistic; gamma: (D,) the dequantized weight.  dgamma comes out whole
    (per-block partials summed in a fixed order in the same launch).  CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    R, D = xm.shape
    if gamma.shape != (D,) or rstd.shape != (R, 1):
        raise ValueError("int_rmsnorm_bwd: gamma (D,) and rstd (R, 1) "
                         "expected")
    kind = _check_ln("int_rmsnorm_bwd", xm, gm)
    with _lib.kernel_call(int_rmsnorm_bwd, kind,
                          (xm, gm, x_exp, g_exp, gamma, rstd),
                          bits=_bits(xm), D=D, R=R):
        if kind == "cpu":
            return int_rmsnorm_bwd_plain(xm, gm, x_exp, g_exp, gamma, rstd)
        lib, stream = _lib.launcher(xm)
        return _launch_bwd(lib, False, xm.contiguous(), gm.contiguous(),
                           _exp(x_exp, xm), _exp(g_exp, xm), _vec(gamma, xm),
                           None, _vec(rstd, xm), stream)[:2]


int_layernorm_fwd.launches = 0
int_layernorm_bwd.launches = 0
int_rmsnorm_bwd.launches = 0
