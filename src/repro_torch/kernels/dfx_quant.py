"""DFX quantize: shift-round-clip, optionally fused with the limb split.

Counterpart of ``repro/kernels/dfx_quant.py::dfx_quantize`` and
``dfx_quantize_grouped``; the CUDA kernels are in ``csrc/dfx_quant.cu``.

    m = clip(round(x * 2^-exp), ±(2^(b-1)-1))          (half to even)
    m = clip(floor(x * 2^-exp + u), ±(2^(b-1)-1))      (noise u given)

``limb_planes=True`` returns the ``(L, M, N)`` int8 stack of balanced
base-2⁷ digits ``m = Σ_j plane_j · 2^(7j)`` (non-final digits in
[-64, 63], the final plane the raw carry), which the matmul and attention
kernels take.  The scale exponent is an int32 0-d tensor on ``x``'s device.
The grouped form takes an (E, M, N) stack and one exponent per leading
slice (the MoE experts' per-expert scales) and writes plane-major
``(L, E, M, N)`` limb planes.
"""
from __future__ import annotations

import torch

from repro_torch.core.dfx import pow2, storage_dtype
from repro_torch.kernels import _lib

#: balanced-digit radix of the limb planes; must match ``kLimbBits`` in
#: csrc/dfx_common.cuh.
LIMB_BITS = 7


def n_limbs(bits: int) -> int:
    """Number of int8 limb planes of a ``bits``-bit mantissa."""
    return 1 if bits <= 8 else -(-bits // LIMB_BITS)


def split_planes(m: torch.Tensor, n: int) -> list:
    """Balanced base-2⁷ digit planes of an integer-valued tensor (any
    integer or integer-valued float dtype), as a list of ``n`` int32
    tensors; the final plane keeps the raw carry."""
    m = m.to(torch.int32)
    planes = []
    for _ in range(n - 1):
        carry = (m + 64) >> LIMB_BITS          # floor((m + 64) / 128)
        planes.append(m - carry * (1 << LIMB_BITS))
        m = carry
    planes.append(m)
    return planes


def split_limbs_stacked(m: torch.Tensor, bits: int) -> torch.Tensor:
    """Stacked balanced base-2⁷ int8 limb planes ``(L,) + m.shape`` of a
    logical integer mantissa — the digits the kernel's fused split emits."""
    return torch.stack([p.to(torch.int8)
                        for p in split_planes(m, n_limbs(bits))])


def dfx_quantize_plain(x: torch.Tensor, exp: torch.Tensor, *, bits: int,
                       u: torch.Tensor | None = None,
                       limb_planes: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same arithmetic)."""
    y = x.to(torch.float32) * pow2(-exp)
    y = torch.floor(y + u) if u is not None else torch.round(y)
    lim = float(2 ** (bits - 1) - 1)
    m = torch.clamp(y, -lim, lim)
    if limb_planes:
        return split_limbs_stacked(m, bits)
    return m.to(storage_dtype(bits))


def _launch(lib, x: torch.Tensor, exp: torch.Tensor, bits: int,
            u: torch.Tensor | None, limb_planes: bool, stream: int):
    """Launch the kernel on a contiguous f32 ``x`` whose ``exp.numel()``
    leading slices take one exponent each (one for the per-tensor form);
    allocates the output (``lib`` None: only that, ``_lib.launcher``)."""
    if limb_planes:
        out = torch.empty((n_limbs(bits),) + tuple(x.shape), dtype=torch.int8,
                          device=x.device)
        kind = 3
    else:
        out = torch.empty(x.shape, dtype=storage_dtype(bits), device=x.device)
        kind = {torch.int8: 0, torch.int16: 1, torch.int32: 2}[out.dtype]
    groups = exp.numel()
    if lib is None:                  # meta: the shape-only path
        return out
    err = lib.dfx_quantize_launch(
        x.data_ptr(), exp.data_ptr(), u.data_ptr() if u is not None else None,
        out.data_ptr(), groups, x.numel() // groups, bits, kind,
        n_limbs(bits), stream)
    _lib.check(err, "dfx_quantize")
    return out


def dfx_quantize(x: torch.Tensor, exp: torch.Tensor, *, bits: int,
                 u: torch.Tensor | None = None,
                 limb_planes: bool = False) -> torch.Tensor:
    """Shift-round-clip pass: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor.  Returns the ``x.shape`` int8/int16/int32
    mantissa, or with ``limb_planes`` the ``(L,) + x.shape`` int8 planes."""
    if not 1 <= bits <= 24:
        raise ValueError(f"bits={bits} outside [1, 24]")
    kind = _lib.device_kind("dfx_quantize", x)
    with _lib.kernel_call(dfx_quantize, kind, (x, exp, u), bits=bits,
                          limbs=n_limbs(bits) if limb_planes else 0):
        if kind == "cpu":
            return dfx_quantize_plain(x, exp, bits=bits, u=u,
                                      limb_planes=limb_planes)
        if x.dtype != torch.float32:
            raise TypeError(f"dfx_quantize takes float32, got {x.dtype}")
        exp = exp.to(device=x.device, dtype=torch.int32).reshape(())
        if u is not None:
            if u.shape != x.shape or u.dtype != torch.float32:
                raise ValueError("u must be float32 of x's shape")
            u = u.to(x.device)
        x = x.contiguous()
        if u is not None:
            u = u.contiguous()
        lib, stream = _lib.launcher(x)
        return _launch(lib, x, exp, bits, u, limb_planes, stream)


dfx_quantize.launches = 0


def dfx_quantize_grouped_plain(x: torch.Tensor, exp: torch.Tensor, *,
                               bits: int, u: torch.Tensor | None = None,
                               limb_planes: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the grouped kernel: slice ``e`` of the
    (E, M, N) ``x`` at exponent ``exp[e]`` (same arithmetic)."""
    return dfx_quantize_plain(x, exp.reshape(-1, 1, 1), bits=bits, u=u,
                              limb_planes=limb_planes)


def dfx_quantize_grouped(x: torch.Tensor, exp: torch.Tensor, *, bits: int,
                         u: torch.Tensor | None = None,
                         limb_planes: bool = False) -> torch.Tensor:
    """Grouped-scale shift-round-clip over an (E, M, N) f32 stack with an
    (E,) int32 exponent vector: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor.  Returns the (E, M, N) int8/int16/int32
    mantissa, or with ``limb_planes`` the plane-major ``(L, E, M, N)`` int8
    planes.  ``u``: optional (E, M, N) noise in [0, 1)."""
    if not 1 <= bits <= 24:
        raise ValueError(f"bits={bits} outside [1, 24]")
    if x.dim() != 3 or exp.numel() != x.shape[0]:
        raise ValueError(f"dfx_quantize_grouped takes (E, M, N) and (E,) "
                         f"exponents, got {tuple(x.shape)} and "
                         f"{tuple(exp.shape)}")
    if u is not None and u.shape != x.shape:
        raise ValueError("u must have x's shape")
    kind = _lib.device_kind("dfx_quantize_grouped", x)
    with _lib.kernel_call(dfx_quantize_grouped, kind, (x, exp, u), bits=bits,
                          limbs=n_limbs(bits) if limb_planes else 0):
        if kind == "cpu":
            return dfx_quantize_grouped_plain(x, exp, bits=bits, u=u,
                                              limb_planes=limb_planes)
        if x.dtype != torch.float32 or (u is not None
                                        and u.dtype != torch.float32):
            raise TypeError("dfx_quantize_grouped takes float32 x and u")
        exp = exp.to(device=x.device, dtype=torch.int32).reshape(-1)
        x = x.contiguous()
        if u is not None:
            u = u.to(x.device).contiguous()
        lib, stream = _lib.launcher(x)
        return _launch(lib, x, exp.contiguous(), bits, u, limb_planes,
                       stream)


dfx_quantize_grouped.launches = 0
