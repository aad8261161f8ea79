"""b-bit dynamic fixed-point (DFX) mapping — the paper's numeric core.

Counterpart of ``repro/core/dfx.py``:

    e_scale = exponent of max|x|        (frexp: max|x| in [0.5, 1)·2^e)
    exp     = e_scale - (b - 1)         (value = m · 2^exp)
    m_i     = clip(round(x_i · 2^-exp), ±(2^(b-1) - 1))

Every power of two is built exactly (``pow2`` writes the IEEE exponent
bits), where the reference's ``jnp.exp2(int)`` is exact on XLA:CPU only for
small arguments; so the port's scales are exact at every exponent.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def storage_dtype(bits: int) -> torch.dtype:
    """Narrowest signed-integer dtype that holds a ``bits``-bit mantissa."""
    if bits <= 8:
        return torch.int8
    if bits <= 16:
        return torch.int16
    return torch.int32


class DfxTensor(NamedTuple):
    """Dynamic fixed-point tensor: ``value = m * 2.0**exp``.

    ``m``   — integer mantissa, or stacked int8 limb planes ``(L, *shape)``
    ``exp`` — int32 scale exponent on ``m``'s device: a 0-d tensor, or the
              ``(E, 1, ..., 1)`` keep-dims per-slice exponents of
              ``quantize_stacked``.
    """

    m: torch.Tensor
    exp: torch.Tensor

    @property
    def shape(self):
        return self.m.shape


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact ``2.0**e`` in float32 for an int tensor ``e``.

    Normal results get their exponent field written directly; ``e`` in
    [-149, -127] gives the subnormal power, below that 0, above 127 inf.
    The CUDA kernels build their scales with the same rule
    (``csrc/dfx_common.cuh::pow2f``), so kernel and plain version agree
    at every exponent.
    """
    e = e.to(torch.int32)
    normal = ((e.clamp(-126, 127) + 127) << 23).view(torch.float32)
    sub = (torch.ones_like(e) << (e + 149).clamp(0, 22)).view(torch.float32)
    out = torch.where(e >= -126, normal, sub)
    out = torch.where(e < -149, torch.zeros_like(out), out)
    return torch.where(e > 127, torch.full_like(out, float("inf")), out)


def scale_exponent(x: torch.Tensor) -> torch.Tensor:
    """int32 0-d exponent ``e`` with ``max|x| <= 2**e`` (frexp convention);
    0 for an all-zero tensor.

    The max-abs reduction is plain PyTorch (one ``aminmax`` pass, no
    ``abs`` temporary), as the reference leaves it to XLA.
    """
    lo, hi = torch.aminmax(x)
    absmax = torch.maximum(-lo, hi)
    _, e = torch.frexp(absmax)
    return torch.where(absmax > 0, e, torch.zeros_like(e)).to(torch.int32)


def slice_exponents(x: torch.Tensor) -> torch.Tensor:
    """``scale_exponent`` of every leading slice ``x[e]``: an (E,) int32
    tensor, 0 for an all-zero slice (an expert that receives no token)."""
    lo, hi = torch.aminmax(x.reshape(x.shape[0], -1), dim=1)
    absmax = torch.maximum(-lo, hi)
    _, e = torch.frexp(absmax)
    return torch.where(absmax > 0, e, torch.zeros_like(e)).to(torch.int32)


def uniform(key, shape, device) -> torch.Tensor:
    """Noise ``u`` in [0, 1) for stochastic rounding, f32 of ``shape`` on
    ``device``.

    ``key`` is the port's counterpart of a JAX PRNG key: a
    ``torch.Generator`` on ``device`` (each call draws the next numbers of
    its stream), or a callable ``key(shape, device) -> u``, through which a
    caller hands in noise of its own (the parity tests feed the
    reference's ``jax.random.uniform`` draws this way).
    """
    if isinstance(key, torch.Generator):
        return torch.rand(shape, generator=key, device=device,
                          dtype=torch.float32)
    u = key(tuple(shape), device)
    return torch.as_tensor(u, dtype=torch.float32, device=device)


def quantize(x: torch.Tensor, bits: int, *, u: torch.Tensor | None = None,
             limb_planes: bool = False) -> DfxTensor:
    """Per-tensor linear fixed-point mapping: the exponent from the
    tensor's max-abs, then one shift-round-clip pass of the quantize kernel
    (``kernels/dfx_quant.py``; its plain version for a CPU tensor) over the
    2-D view.  Round-to-nearest is half-to-even; with noise ``u`` in [0, 1)
    it is ``floor(y + u)``.  With ``limb_planes`` ``m`` is the
    ``(L,) + x.shape`` int8 limb-plane stack."""
    from repro_torch.kernels import ops   # the kernels import this module
    x = x.to(torch.float32)
    exp = scale_exponent(x) - (bits - 1)
    x2 = x if x.dim() == 2 else x.reshape(-1, x.shape[-1])
    if u is not None:
        u = u.reshape(x2.shape)
    m = ops.quantize(x2, exp, bits, u=u, limb_planes=limb_planes)
    shape = (m.shape[0],) + tuple(x.shape) if limb_planes else x.shape
    return DfxTensor(m=m.reshape(shape), exp=exp)


def quantize_stacked(x: torch.Tensor, bits: int, *,
                     u: torch.Tensor | None = None,
                     limb_planes: bool = False) -> DfxTensor:
    """Per-slice (leading-axis) mapping, one scale per expert: the
    reference's ``_stacked_pallas_quantize``.  The exponents come from each
    slice's max-abs (plain PyTorch), then one grouped quantize launch
    covers the whole ``(E, ..., N)`` stack.  ``u`` is one draw over the
    whole stack.  ``exp`` is ``(E, 1, ..., 1)``; with ``limb_planes`` ``m``
    is the plane-major ``(L,) + x.shape`` int8 stack."""
    from repro_torch.kernels import ops   # the kernels import this module
    x = x.to(torch.float32)
    E = x.shape[0]
    exp = slice_exponents(x) - (bits - 1)
    x3 = x.reshape(E, -1, x.shape[-1])
    if u is not None:
        u = u.reshape(x3.shape)
    m = ops.quantize_batched(x3, exp, bits, u=u, limb_planes=limb_planes)
    shape = (m.shape[0],) + tuple(x.shape) if limb_planes else x.shape
    return DfxTensor(m=m.reshape(shape),
                     exp=exp.reshape((E,) + (1,) * (x.dim() - 1)))


def dequantize(t: DfxTensor) -> torch.Tensor:
    """Non-linear inverse mapping: DFX -> float32 (exact)."""
    return t.m.to(torch.float32) * pow2(t.exp)


# ---------------------------------------------------------------------------
# Health counters (the sentinel's probes, core/health.py)
# ---------------------------------------------------------------------------

@torch.no_grad()
def health_stats(x: torch.Tensor, bits: int) -> dict:
    """Counters of mapping ``x`` at ``bits``, 0-d f32 tensors: the clip rate
    at the quantizer's saturation point, the mantissa zero-fraction (an
    underflow proxy), the step exponent and the non-finite count.  The
    quantizer's frexp / step arithmetic on the sanitised magnitudes, so a
    NaN raises ``nonfinite`` and does not poison the amax.  Plain PyTorch
    reductions: no kernel launch."""
    x = x.detach().to(torch.float32)
    finite = torch.isfinite(x)
    ax = torch.where(finite, x.abs(), torch.zeros_like(x))
    exp = scale_exponent(ax) - (bits - 1)
    y = torch.round(ax * pow2(-exp))
    lim = float(2 ** (bits - 1) - 1)
    return {"clip": (y >= lim).to(torch.float32).mean(),
            "zero": (y == 0).to(torch.float32).mean(),
            "nonfinite": (~finite).sum().to(torch.float32),
            "exp": exp.to(torch.float32)}


# ---------------------------------------------------------------------------
# Error-bound helpers (Proposition 1)
# ---------------------------------------------------------------------------

def error_bound(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Prop. 1 bound on |x̂ - x|: the quantization step ``2^(e_scale-b+1)``
    (RN halves it; stochastic rounding meets it), a 0-d f32 tensor."""
    return pow2(scale_exponent(x.to(torch.float32)) - (bits - 1))


def variance_bound(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Prop. 1: V{delta} <= 2^(2(e_scale_ieee - b + 2)) = step^2."""
    return error_bound(x, bits) ** 2
