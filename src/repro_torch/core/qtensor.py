"""QTensor — the DFX int8 container of the state plane.

Counterpart of ``repro/core/qtensor.py``.  A ``QTensor`` holds

* ``m``   — int8 limb planes ``(L,) + shape``, the logical mantissa
  ``Σ_j m[j] · 2^(7j)`` (``L = n_limbs(bits)``; one plane holds the raw
  mantissa for ``bits <= 8``): non-final digits in [-64, 63], the final
  plane the raw carry — the digit set the quantize kernel's fused split
  writes (``kernels/dfx_quant.py``), so the planes feed the matmul
  kernels as they are;
* ``exp`` — the int32 step exponent (``value = mantissa · 2^exp``): 0-d
  for one scale, or keep-dims with one exponent per slice along
  ``group_axis`` (the ``(E, 1, ..., 1)`` layout of
  ``dfx.quantize_stacked``);
* ``bits`` — the mantissa width.

``quantize`` of a tensor is one launch of the existing quantize kernels:
``dfx_quantize`` with ``limb_planes=True`` for one exponent,
``dfx_quantize_grouped`` on the ``(E, M, N)`` view for one exponent per
leading slice (``group_axis=0``; no caller groups along another axis, and
asking for one raises).  The reference's pytree registration has no
counterpart: the optimizer's ``tree_map`` / ``tree_leaves`` recurse into
dicts only, so a ``QTensor`` is a leaf there.

Rounding: round-half-to-even by default; stochastic is ``floor(y + u)``
with ``u`` in [0, 1) drawn from ``key`` (``dfx.uniform``: a
``torch.Generator`` or a callable handing in the noise), which is unbiased
and keeps the quantized EMA of the optimizer moments mean-preserving
(``ema_update``).  Scales are exact powers of two (``dfx.pow2``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import dfx
from repro_torch.kernels.dfx_quant import LIMB_BITS, n_limbs

__all__ = ["QTensor", "quantize", "dequantize", "int_mantissa", "zeros",
           "ema_update", "fake_quant_ste", "is_qtensor", "wire_bytes",
           "step_exponent"]


@dataclasses.dataclass(frozen=True)
class QTensor:
    """DFX int8 state container: ``value = (Σ_j m[j]·2^(7j)) · 2^exp``."""

    m: torch.Tensor              # int8 (L, *shape) stacked limb planes
    exp: torch.Tensor            # int32 0-d or keep-dims per-group exponent
    bits: int = 8

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.m.shape[1:])

    @property
    def n_limbs(self) -> int:
        return self.m.shape[0]

    @property
    def group_axis(self) -> Optional[int]:
        """Axis the exponent varies along (None = one scale)."""
        for ax, s in enumerate(self.exp.shape):
            if s != 1:
                return ax
        return None

    @property
    def nbytes(self) -> int:
        """Resident bytes: the int8 planes and the int32 exponent(s)."""
        return self.m.numel() + 4 * self.exp.numel()


def is_qtensor(x) -> bool:
    return isinstance(x, QTensor)


def _check_axis(group_axis: Optional[int]) -> None:
    if group_axis not in (None, 0):
        raise NotImplementedError(
            f"group_axis={group_axis}: only one exponent per tensor or per "
            "leading slice (group_axis=0) is ported")


def step_exponent(x: torch.Tensor, bits: int,
                  group_axis: Optional[int] = None) -> torch.Tensor:
    """Step exponent ``e_max - (bits-1)`` per scale group (keep-dims): the
    frexp convention (``max|x| <= 2^e_max``), an all-zero group at
    ``-(bits-1)``."""
    _check_axis(group_axis)
    x = x.to(torch.float32)
    if group_axis is None:
        return dfx.scale_exponent(x) - (bits - 1)
    e = dfx.slice_exponents(x.reshape(x.shape[0], -1)) - (bits - 1)
    return e.reshape((x.shape[0],) + (1,) * (x.dim() - 1))


def quantize(x: torch.Tensor, bits: int, *,
             group_axis: Optional[int] = None, stochastic: bool = False,
             key=None, exp: Optional[torch.Tensor] = None) -> QTensor:
    """DFX linear mapping of ``x`` into a QTensor: one quantize launch for
    a CUDA tensor (its plain version for a CPU tensor).  ``group_axis``: None
    (one exponent) or 0 (one per leading slice).  ``exp`` overrides the
    derived step exponent (``step_exponent``'s shape): the collectives
    quantize against a scale shared over ranks (``grad_compress``), the
    optimizer its sharded moments against the logical tensor's."""
    if stochastic and key is None:
        raise ValueError("stochastic rounding requires a key")
    _check_axis(group_axis)
    from repro_torch.kernels import ops       # the kernels import dfx
    x = x.to(torch.float32)
    if exp is None:
        exp = step_exponent(x, bits, group_axis)
    else:
        exp = torch.as_tensor(exp, dtype=torch.int32, device=x.device)
    u = dfx.uniform(key, tuple(x.shape), x.device) if stochastic else None
    if group_axis is None:
        x2 = x.reshape(-1, x.shape[-1]) if x.dim() else x.reshape(1, 1)
        m = ops.quantize(x2, exp, bits, u=None if u is None else
                         u.reshape(x2.shape), limb_planes=True)
    else:
        x3 = x.reshape(x.shape[0], -1, x.shape[-1] if x.dim() > 1 else 1)
        m = ops.quantize_batched(x3, exp, bits, u=None if u is None else
                                 u.reshape(x3.shape), limb_planes=True)
    return QTensor(m=m.reshape((m.shape[0],) + tuple(x.shape)), exp=exp,
                   bits=bits)


def _combine_planes(m: torch.Tensor, dtype) -> torch.Tensor:
    """Logical mantissa ``Σ_j m[j]·2^(7j)`` (exact in f32 for b <= 16)."""
    out = m[0].to(dtype)
    for j in range(1, m.shape[0]):
        out = out + m[j].to(dtype) * (1 << (LIMB_BITS * j))
    return out


def int_mantissa(t: QTensor) -> torch.Tensor:
    """Logical int32 mantissa."""
    return _combine_planes(t.m, torch.int32)


def dequantize(t: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Inverse mapping: the plane sum (exact in f32), times ``2^exp``."""
    return (_combine_planes(t.m, torch.float32) * dfx.pow2(t.exp)).to(dtype)


def zeros(shape: Tuple[int, ...], bits: int,
          group_axis: Optional[int] = None, device="cpu") -> QTensor:
    """All-zero QTensor (mantissas 0, exponents at the zero-group value)."""
    _check_axis(group_axis)
    shape = tuple(shape)
    eshape = () if group_axis is None else (
        (shape[0],) + (1,) * (len(shape) - 1))
    return QTensor(m=torch.zeros((n_limbs(bits),) + shape, dtype=torch.int8,
                                 device=device),
                   exp=torch.full(eshape, -(bits - 1), dtype=torch.int32,
                                  device=device),
                   bits=bits)


def ema_update(t: QTensor, x: torch.Tensor, decay: float, key,
               exp_fn=None) -> QTensor:
    """Stochastic-rounding EMA: ``t ← Q_sr(decay·deq(t) + (1-decay)·x)``,
    the EMA in FP32 and re-quantized at ``t``'s width and grouping; the
    stored exponent keeps its shape.  ``exp_fn(e)`` maps the EMA's own
    step exponents (keep-dims) to the ones it is quantized at (a sharded
    moment: the logical tensor's)."""
    new = decay * dequantize(t) + (1.0 - decay) * x.to(torch.float32)
    ga, exp = t.group_axis, None
    if exp_fn is not None:
        e = step_exponent(new, t.bits, ga).reshape(t.exp.shape)
        exp = exp_fn(e).reshape(() if ga is None else t.exp.shape)
    q = quantize(new, t.bits, group_axis=ga, stochastic=True, key=key,
                 exp=exp)
    if q.exp.shape != t.exp.shape:
        # keep-dims groups of size 1 re-derive as one exponent
        q = QTensor(m=q.m, exp=q.exp.reshape(t.exp.shape), bits=t.bits)
    return q


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits):
        return dequantize(quantize(x.detach(), bits))

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quant_ste(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Quantize→dequantize (per tensor, round to nearest) with a
    straight-through gradient: the forward sees the b-bit DFX image of
    ``x``, the gradient reaches the FP32 master unchanged."""
    return _FakeQuant.apply(x, bits)


def wire_bytes(n_elems: int, bits: int, n_groups: int = 1) -> int:
    """Bytes of a QTensor of ``n_elems``: ``L`` int8 planes and one int32
    exponent per scale group."""
    return n_limbs(bits) * n_elems + 4 * n_groups
