"""Integer approximations of the paper's kept FP32 ops: exp, reciprocal,
rsqrt, sqrt, sigmoid, tanh, GELU, SiLU and softmax, in Q.14 fixed point.

Counterpart of ``repro/core/iapprox.py`` (the ``kept_ops="integer"``
extension, I-BERT style).  Every transcendental is int32 arithmetic: range
reduction by arithmetic shifts, low-degree Horner polynomials and
division-free Newton steps in Q.14 (``F = 14`` fraction bits), with
operands bounded so every product stays inside int32.  The only float
operations are IEEE multiplies and adds, round-half-to-even conversions
(``torch.round``, as ``jnp.round``) and exact powers of two.

Powers of two are built exactly (``core/dfx.py::pow2`` writes the exponent
bits); the reference's ``jnp.exp2`` of an integer is exact on XLA:CPU only
in about [-12, 12], so its ``i_exp`` / ``i_recip`` / ``i_rsqrt`` results
are a few ulps off there for most inputs, and the port does not copy that
error.  The integer intermediates (``ti``, ``q``, the Horner sum, the
Newton iterate) are the reference's bit for bit.  Every float constant is
the reference's f32 value and the expressions keep its order, e.g.
``(x · log2 e) · 2^14`` and ``c · (x + a · x · x · x)``.

``csrc/iapprox.cuh`` holds the same ``i_exp``, ``i_recip`` and
``i_rsqrt`` for the attention and norm kernels.  Error bounds (the
reference's sweeps, DESIGN.md §10): i_exp, i_recip, i_rsqrt, i_sqrt
relative 3-4e-4; i_sigmoid, i_tanh absolute 1e-3; i_gelu 2e-3 on |x| <= 10;
i_silu 4e-3 on |x| <= 30; i_softmax rows sum to 1 within 1e-3.  The ``d_*``
derivatives are built from the same integer forms.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dfx import pow2

__all__ = ["F", "EXP_CLAMP", "i_exp", "i_recip", "i_rsqrt", "i_sqrt",
           "i_sigmoid", "i_tanh", "i_gelu", "i_silu", "i_softmax", "d_tanh",
           "d_sigmoid", "d_gelu", "d_silu"]

#: Q.14 fixed point: fraction bits of every integer intermediate.
F = 14

#: ``i_exp`` input clamp: exp(±30) spans [9.4e-14, 1.1e13].
EXP_CLAMP = 30.0


def _f32(c: float) -> float:
    """The f32 value of a constant, as a Python float: a tensor op with it
    is the f32 op (the product or sum of two f32 values rounds once)."""
    return float(np.float32(c))


_LOG2E = _f32(1.4426950408889634)

#: degree-3 fit of ``2^f`` on [0, 1), Q.14
_EXP2_C = (1295, 3672, 11417, 16381)          # c3, c2, c1, c0

#: reciprocal Newton init 48/17 - 32/17 d on d in [0.5, 1), Q.14
_RECIP_A, _RECIP_B = 46261, 30840

#: rsqrt Newton linear-minimax init A - B d on d in [1, 2), Q.14
_RSQRT_A, _RSQRT_B = 20559, 4658

_INV_SQRT2 = _f32(0.7071067811865476)
_GELU_C = _f32(0.7978845608028654)           # sqrt(2/pi)
_GELU_A = _f32(0.044715)
_GELU_3A = _f32(3 * 0.044715)


def _exp2_frac(r: torch.Tensor) -> torch.Tensor:
    """Q.14 polynomial for ``2^f``; ``r = round(f · 2^F)`` in [0, 2^F)."""
    acc = torch.full_like(r, _EXP2_C[0])
    for c in _EXP2_C[1:]:
        acc = ((acc * r) >> F) + c
    return acc


def exp_parts(x: torch.Tensor):
    """``i_exp``'s integer intermediates ``(ti, q, acc)``:
    ``ti = round((x · log2 e) · 2^F)``, ``q = ti >> F`` and the Q.14
    value ``acc`` of ``2^(ti - q·2^F)``."""
    x = torch.clamp(x.to(torch.float32), -EXP_CLAMP, EXP_CLAMP)
    ti = torch.round((x * _LOG2E) * float(1 << F)).to(torch.int32)
    q = ti >> F                          # floor(x log2 e), exact for x < 0
    return ti, q, _exp2_frac(ti - (q << F))


def i_exp(x: torch.Tensor) -> torch.Tensor:
    """Integer ``exp(x)`` on |x| <= 30 (clamped outside):
    ``acc · 2^(q - F)``."""
    _, q, acc = exp_parts(x)
    return acc.to(torch.float32) * pow2(q - F)


def _floor_log2(y: torch.Tensor) -> torch.Tensor:
    """``floor(log2 y)`` of a positive normal f32, from its exponent
    field."""
    return (y.contiguous().view(torch.int32) >> 23) - 127


def recip_parts(y: torch.Tensor):
    """``i_recip``'s intermediates ``(e, d, x)``: ``e = floor(log2 y)``,
    ``d = round(y · 2^-(e+1) · 2^F)`` and the Newton iterate ``x``."""
    y = y.to(torch.float32)
    e = _floor_log2(y)
    d = torch.round((y * pow2(-(e + 1))) * float(1 << F)).to(torch.int32)
    x = _RECIP_A - ((_RECIP_B * d) >> F)
    for _ in range(3):
        x = (x * ((2 << F) - ((d * x) >> F))) >> F
    return e, d, x


def i_recip(y: torch.Tensor) -> torch.Tensor:
    """Integer-Newton ``1/y`` for positive normal f32 ``y``: three steps
    ``x <- x (2 - d x)`` in Q.14 on ``d = y · 2^-(e+1)`` in [0.5, 1)."""
    e, _, x = recip_parts(y)
    return x.to(torch.float32) * pow2(-(F + e + 1))


def rsqrt_parts(y: torch.Tensor):
    """``i_rsqrt``'s intermediates ``(e, d, x)``: ``e = floor(log2 y)``,
    ``d = round(y · 2^-e · 2^F)`` and the Newton iterate ``x``."""
    y = y.to(torch.float32)
    e = _floor_log2(y)
    d = torch.round((y * pow2(-e)) * float(1 << F)).to(torch.int32)
    x = _RSQRT_A - ((_RSQRT_B * d) >> F)
    for _ in range(3):
        t = (((d * x) >> F) * x) >> F                 # d x² in Q.14
        x = (x * ((3 << F) - t)) >> (F + 1)
    return e, d, x


def i_rsqrt(y: torch.Tensor) -> torch.Tensor:
    """Integer-Newton ``1/sqrt(y)`` for positive normal f32 ``y``: three
    steps ``x <- x (3 - d x²) / 2`` in Q.14 on ``d = y · 2^-e`` in [1, 2);
    ``2^(-e/2)`` as an exact power of two, times ``f32(1/sqrt 2)`` where
    ``e`` is odd."""
    e, _, x = rsqrt_parts(y)
    k = e >> 1                                        # floor(e / 2)
    r = x.to(torch.float32) * pow2(-(F + k))
    return torch.where((e - (k << 1)) == 1, r * _INV_SQRT2, r)


def i_sqrt(y: torch.Tensor) -> torch.Tensor:
    """``sqrt(y) = y · i_rsqrt(y)``, exactly 0 at y <= 0."""
    y = y.to(torch.float32)
    safe = torch.clamp(y, min=_f32(1e-30))
    return torch.where(y > 0, y * i_rsqrt(safe), torch.zeros_like(y))


def i_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + i_exp(-|x|))``, reflected for x < 0."""
    x = x.to(torch.float32)
    p = i_recip(1.0 + i_exp(-torch.abs(x)))           # sigmoid(|x|)
    return torch.where(x >= 0, p, 1.0 - p)


def i_tanh(x: torch.Tensor) -> torch.Tensor:
    """``sign(x) · (1 - z) / (1 + z)`` with ``z = i_exp(-2|x|)``."""
    x = x.to(torch.float32)
    z = i_exp(-2.0 * torch.abs(x))
    p = (1.0 - z) * i_recip(1.0 + z)
    return torch.where(x >= 0, p, -p)


def _gelu_arg(x: torch.Tensor) -> torch.Tensor:
    return _GELU_C * (x + _GELU_A * x * x * x)


def i_gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-form GELU with the tanh replaced by ``i_tanh``."""
    x = x.to(torch.float32)
    return 0.5 * x * (1.0 + i_tanh(_gelu_arg(x)))


def i_silu(x: torch.Tensor) -> torch.Tensor:
    """``x · i_sigmoid(x)``."""
    x = x.to(torch.float32)
    return x * i_sigmoid(x)


def i_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Row softmax: max subtraction, ``i_exp`` and the fixed-point
    reciprocal of the row sum.  Its integer casts carry no gradient (as the
    reference's, whose cotangent through them is zero)."""
    x = x.to(torch.float32)
    z = i_exp(x - torch.amax(x, dim=dim, keepdim=True))
    return z * i_recip(torch.sum(z, dim=dim, keepdim=True))


def d_tanh(x: torch.Tensor) -> torch.Tensor:
    t = i_tanh(x)
    return 1.0 - t * t


def d_sigmoid(x: torch.Tensor) -> torch.Tensor:
    s = i_sigmoid(x)
    return s * (1.0 - s)


def d_silu(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    s = i_sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def d_gelu(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.float32)
    t = i_tanh(_gelu_arg(x))
    du = _GELU_C * (1.0 + _GELU_3A * x * x)
    return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * du
