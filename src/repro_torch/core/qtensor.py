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
slice along ``group_axis`` (an axis other than 0 is moved to the front for
the launch and back after it; the exponent keeps the reference's keep-dims
shape, its size along ``group_axis``, 1 elsewhere).  As in the reference, a
``group_axis`` outside ``[0, ndim)`` (a negative one included) names no
axis: its keep-dims reduction runs over every axis, so it gives one
exponent in the ``(1, ..., 1)`` shape.  The reference's pytree registration has no
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


def _axis(group_axis: Optional[int], ndim: int) -> Optional[int]:
    """The axis the exponents vary along: ``group_axis`` where it is one of
    ``x``'s axes, else None (the reference reduces over every axis ``a !=
    group_axis``, so a negative or out-of-range one leaves one group)."""
    if group_axis is None or not 0 <= group_axis < ndim:
        return None
    return group_axis


def _eshape(shape: Tuple[int, ...], group_axis: Optional[int]
            ) -> Tuple[int, ...]:
    """The exponent's keep-dims shape: () for None, else the size along
    the group axis and 1 elsewhere (all 1 where it names no axis)."""
    if group_axis is None:
        return ()
    return tuple(s if a == group_axis else 1 for a, s in enumerate(shape))


def step_exponent(x: torch.Tensor, bits: int,
                  group_axis: Optional[int] = None) -> torch.Tensor:
    """Step exponent ``e_max - (bits-1)`` per scale group (keep-dims): the
    frexp convention (``max|x| <= 2^e_max``), an all-zero group at
    ``-(bits-1)``."""
    x = x.to(torch.float32)
    ax = _axis(group_axis, x.dim())
    if ax is None:
        e = dfx.scale_exponent(x) - (bits - 1)
        return e.reshape(_eshape(tuple(x.shape), group_axis))
    xt = x.movedim(ax, 0)
    e = dfx.slice_exponents(xt.reshape(xt.shape[0], -1)) - (bits - 1)
    return e.reshape(_eshape(tuple(x.shape), ax))


def quantize(x: torch.Tensor, bits: int, *,
             group_axis: Optional[int] = None, stochastic: bool = False,
             key=None, exp: Optional[torch.Tensor] = None) -> QTensor:
    """DFX linear mapping of ``x`` into a QTensor: one quantize launch for
    a CUDA tensor (its plain version for a CPU tensor).  ``group_axis``: None
    (one exponent) or the axis with one exponent per slice (the module
    docstring).  ``exp`` overrides the derived step exponent
    (``step_exponent``'s shape): the collectives quantize against a scale
    shared over ranks (``grad_compress``), the optimizer its sharded
    moments against the logical tensor's."""
    if stochastic and key is None:
        raise ValueError("stochastic rounding requires a key")
    from repro_torch.kernels import ops       # the kernels import dfx
    x = x.to(torch.float32)
    if exp is None:
        exp = step_exponent(x, bits, group_axis)
    else:
        exp = torch.as_tensor(exp, dtype=torch.int32, device=x.device)
    u = dfx.uniform(key, tuple(x.shape), x.device) if stochastic else None
    ax = _axis(group_axis, x.dim())
    if ax is None:
        x2 = x.reshape(-1, x.shape[-1]) if x.dim() else x.reshape(1, 1)
        m = ops.quantize(x2, exp.reshape(()), bits, u=None if u is None else
                         u.reshape(x2.shape), limb_planes=True)
        return QTensor(m=m.reshape((m.shape[0],) + tuple(x.shape)), exp=exp,
                       bits=bits)
    # the group axis in front: one exponent per leading slice of the view
    xt = x.movedim(ax, 0)
    ut = None if u is None else u.movedim(ax, 0)
    x3 = xt.reshape(xt.shape[0], -1, xt.shape[-1] if xt.dim() > 1 else 1)
    m = ops.quantize_batched(x3, exp, bits, u=None if ut is None else
                             ut.reshape(x3.shape), limb_planes=True)
    m = m.reshape((m.shape[0],) + tuple(xt.shape)).movedim(1, 1 + ax)
    return QTensor(m=m.contiguous(), exp=exp, bits=bits)


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
    shape = tuple(shape)
    eshape = _eshape(shape, group_axis)
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
