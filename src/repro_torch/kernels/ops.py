"""Public wrappers over the integer kernels (counterpart of
``repro/kernels/ops.py``), keeping the reference's signatures and layouts.

The TPU wrappers pad to (8, 128) tiles, pick VMEM blocks and reshape
attention into a "rows" layout; none of that is carried over.  The CUDA
kernels take the ragged shapes and the model layouts as they are and mask
the edges themselves, so these wrappers only route and reshape views.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bfp_matmul import bfp_matmul
from repro_torch.kernels.dfx_quant import (dfx_quantize, n_limbs,
                                           split_limbs_stacked)
from repro_torch.kernels.int_attention import int_attn_fwd
from repro_torch.kernels.int_norm import int_rmsnorm_fwd


def _as_planes(m: torch.Tensor, bits: int, base_ndim: int) -> torch.Tensor:
    """Accept stacked limb planes or a logical mantissa (split here)."""
    if m.dim() == base_ndim + 1:
        if m.shape[0] != n_limbs(bits) or m.dtype != torch.int8:
            raise ValueError(f"expected {n_limbs(bits)} int8 planes, got "
                             f"{tuple(m.shape)} {m.dtype}")
        return m
    if m.dim() != base_ndim:
        raise ValueError(f"mantissa rank {m.dim()}, expected {base_ndim}")
    return split_limbs_stacked(m, bits)


def quantize(x: torch.Tensor, exp: torch.Tensor, bits: int,
             u: torch.Tensor | None = None,
             limb_planes: bool = False) -> torch.Tensor:
    """2-D quantize: the (M, N) logical mantissa or the (L, M, N) planes."""
    if x.dim() != 2:
        raise ValueError(f"quantize takes a 2-D tensor, got {tuple(x.shape)}")
    return dfx_quantize(x, exp, bits=bits, u=u, limb_planes=limb_planes)


def dfx_matmul_tiled(xm: torch.Tensor, x_exp: torch.Tensor, x_bits: int,
                     wm: torch.Tensor, w_exp: torch.Tensor,
                     w_bits: int) -> torch.Tensor:
    """Integer DFX matmul, one launch at every bit-width.  xm: (Lx, M, K)
    planes or a logical (M, K) mantissa; wm: (Lw, K, N) or (K, N).
    Returns the dequantized f32 (M, N)."""
    xm = _as_planes(xm, x_bits, 2)
    wm = _as_planes(wm, w_bits, 2)
    return bfp_matmul(xm, wm, (x_exp + w_exp).to(torch.int32))


def rmsnorm(xm: torch.Tensor, x_exp: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6):
    """Fused RMS-norm forward over (R, D) mantissas -> ``(y, rstd)``."""
    return int_rmsnorm_fwd(xm, x_exp, gamma, eps=eps)


def attention_fwd(qm: torch.Tensor, q_exp: torch.Tensor,
                  km: torch.Tensor, k_exp: torch.Tensor,
                  vm: torch.Tensor, v_exp: torch.Tensor,
                  q_off: torch.Tensor, p_bits: int, *, causal: bool,
                  window: int | None = None):
    """Fused integer attention forward.  qm: (Lq, B, Sq, KV, G, hd) planes;
    km/vm: (L, B, Sk, KV, hd); q_off (B,) int32.  Returns ``(o, lse)``:
    o (B, Sq, KV, G, hd) f32, lse (B, KV, G, Sq) f32."""
    hd = qm.shape[-1]
    exps = torch.stack([q_exp.reshape(()), k_exp.reshape(()),
                        v_exp.reshape(())]).to(torch.int32)
    return int_attn_fwd(qm, km, vm, q_off, exps, p_bits=p_bits,
                        causal=causal, window=window,
                        sc=1.0 / float(hd) ** 0.5)

