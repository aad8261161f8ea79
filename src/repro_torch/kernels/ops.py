"""Public wrappers over the integer kernels (counterpart of
``repro/kernels/ops.py``), keeping the reference's signatures and layouts.

The TPU wrappers pad to (8, 128) tiles, pick VMEM blocks and reshape
attention into a "rows" layout; none of that is carried over.  The CUDA
kernels take the ragged shapes and the model layouts as they are and mask
the edges themselves, so these wrappers only route and reshape views.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bfp_matmul import (bfp_matmul, bfp_matmul_batched,
                                            bfp_matmul_batched_nt,
                                            bfp_matmul_batched_tn,
                                            bfp_matmul_nt, bfp_matmul_tn)
from repro_torch.kernels.dfx_quant import (dfx_quantize, dfx_quantize_grouped,
                                           n_limbs, split_limbs_stacked)
from repro_torch.kernels.int_attention import (int_attn_bwd_dkv,
                                               int_attn_bwd_dq, int_attn_fwd)
from repro_torch.kernels.int_norm import int_rmsnorm_bwd, int_rmsnorm_fwd


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


def dfx_matmul_tiled_nt(gm: torch.Tensor, g_exp: torch.Tensor, g_bits: int,
                        wm: torch.Tensor, w_exp: torch.Tensor,
                        w_bits: int) -> torch.Tensor:
    """Backward dX product ``q(G)·q(W)ᵀ`` with W in its forward (K, N)
    layout.  gm: (Lg, M, N) planes or a logical (M, N) mantissa; wm:
    (Lw, K, N) or (K, N).  Returns the dequantized f32 (M, K)."""
    gm = _as_planes(gm, g_bits, 2)
    wm = _as_planes(wm, w_bits, 2)
    return bfp_matmul_nt(gm, wm, (g_exp + w_exp).to(torch.int32))


def dfx_matmul_tiled_tn(xm: torch.Tensor, x_exp: torch.Tensor, x_bits: int,
                        gm: torch.Tensor, g_exp: torch.Tensor,
                        g_bits: int) -> torch.Tensor:
    """Backward dW product ``q(X)ᵀ·q(G)`` with X in its forward (M, K)
    layout.  xm: (Lx, M, K) planes or (M, K); gm: (Lg, M, N) or (M, N).
    Returns the dequantized f32 (K, N)."""
    xm = _as_planes(xm, x_bits, 2)
    gm = _as_planes(gm, g_bits, 2)
    return bfp_matmul_tn(xm, gm, (x_exp + g_exp).to(torch.int32))


def quantize_batched(x: torch.Tensor, exp: torch.Tensor, bits: int,
                     u: torch.Tensor | None = None,
                     limb_planes: bool = False) -> torch.Tensor:
    """3-D (E, M, N) quantize with one exponent per leading slice (``exp``
    (E,) or any (E,)-broadcastable keep-dims layout): the (E, M, N) logical
    mantissa or the plane-major (L, E, M, N) planes."""
    if x.dim() != 3:
        raise ValueError(f"quantize_batched takes an (E, M, N) tensor, got "
                         f"{tuple(x.shape)}")
    return dfx_quantize_grouped(x, exp.reshape(x.shape[0]), bits=bits, u=u,
                                limb_planes=limb_planes)


def _expert_exp(a_exp: torch.Tensor, b_exp: torch.Tensor,
                E: int) -> torch.Tensor:
    return (a_exp.reshape(E) + b_exp.reshape(E)).to(torch.int32)


def dfx_matmul_tiled_batched(xm: torch.Tensor, x_exp: torch.Tensor,
                             x_bits: int, wm: torch.Tensor,
                             w_exp: torch.Tensor,
                             w_bits: int) -> torch.Tensor:
    """Batched NN ``q(X[e])·q(W[e])`` for every expert and limb pair in one
    launch.  xm: (Lx, E, M, K) planes or a logical (E, M, K) mantissa; wm:
    (Lw, E, K, N) or (E, K, N); exponents (E,)-broadcastable (the (E, 1, 1)
    keep-dims layout of the per-expert quantize too).  Returns the
    dequantized f32 (E, M, N)."""
    xm = _as_planes(xm, x_bits, 3)
    wm = _as_planes(wm, w_bits, 3)
    return bfp_matmul_batched(xm, wm, _expert_exp(x_exp, w_exp, xm.shape[1]))


def dfx_matmul_tiled_batched_nt(gm: torch.Tensor, g_exp: torch.Tensor,
                                g_bits: int, wm: torch.Tensor,
                                w_exp: torch.Tensor,
                                w_bits: int) -> torch.Tensor:
    """Batched NT ``dX[e] = q(G[e])·q(W[e])ᵀ`` with W in its forward layout.
    gm: (Lg, E, M, N) planes or (E, M, N); wm: (Lw, E, K, N) or (E, K, N).
    Returns the dequantized f32 (E, M, K)."""
    gm = _as_planes(gm, g_bits, 3)
    wm = _as_planes(wm, w_bits, 3)
    return bfp_matmul_batched_nt(gm, wm,
                                 _expert_exp(g_exp, w_exp, gm.shape[1]))


def dfx_matmul_tiled_batched_tn(xm: torch.Tensor, x_exp: torch.Tensor,
                                x_bits: int, gm: torch.Tensor,
                                g_exp: torch.Tensor,
                                g_bits: int) -> torch.Tensor:
    """Batched TN ``dW[e] = q(X[e])ᵀ·q(G[e])`` with X in its forward layout.
    xm: (Lx, E, M, K) planes or (E, M, K); gm: (Lg, E, M, N) or (E, M, N).
    Returns the dequantized f32 (E, K, N)."""
    xm = _as_planes(xm, x_bits, 3)
    gm = _as_planes(gm, g_bits, 3)
    return bfp_matmul_batched_tn(xm, gm,
                                 _expert_exp(x_exp, g_exp, xm.shape[1]))


def rmsnorm(xm: torch.Tensor, x_exp: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6, integer_rsqrt: bool = False):
    """Fused RMS-norm forward over (R, D) mantissas -> ``(y, rstd)``;
    ``integer_rsqrt`` takes the kept-int body."""
    return int_rmsnorm_fwd(xm, x_exp, gamma, eps=eps,
                           integer_rsqrt=integer_rsqrt)


def rmsnorm_bwd(xm: torch.Tensor, x_exp: torch.Tensor, gm: torch.Tensor,
                g_exp: torch.Tensor, gamma: torch.Tensor, rstd: torch.Tensor):
    """Fused RMS-norm backward over (R, D) mantissas -> ``(dx, dgamma)``
    (dgamma summed over the row blocks)."""
    return int_rmsnorm_bwd(xm, gm, x_exp, g_exp, gamma, rstd)


def attention_fwd(qm: torch.Tensor, q_exp: torch.Tensor,
                  km: torch.Tensor, k_exp: torch.Tensor,
                  vm: torch.Tensor, v_exp: torch.Tensor,
                  q_off: torch.Tensor, p_bits: int, *, causal: bool,
                  window: int | None = None, integer_exp: bool = False):
    """Fused integer attention forward.  qm: (Lq, B, Sq, KV, G, hd) planes;
    km/vm: (L, B, Sk, KV, hd); q_off (B,) int32; ``integer_exp`` the
    kept-int body.  Returns ``(o, lse)``: o (B, Sq, KV, G, hd) f32, lse
    (B, KV, G, Sq) f32."""
    hd = qm.shape[-1]
    exps = torch.stack([q_exp.reshape(()), k_exp.reshape(()),
                        v_exp.reshape(())]).to(torch.int32)
    return int_attn_fwd(qm, km, vm, q_off, exps, p_bits=p_bits,
                        causal=causal, window=window,
                        sc=1.0 / float(hd) ** 0.5, integer_exp=integer_exp)


def attention_bwd(qm: torch.Tensor, q_exp: torch.Tensor,
                  km: torch.Tensor, k_exp: torch.Tensor,
                  vm: torch.Tensor, v_exp: torch.Tensor,
                  gm: torch.Tensor, g_exp: torch.Tensor,
                  lse: torch.Tensor, delta: torch.Tensor,
                  ds_exp: torch.Tensor, q_off: torch.Tensor, p_bits: int,
                  ds_bits: int, *, causal: bool, window: int | None = None,
                  integer_exp: bool = False):
    """Fused integer attention backward: the dq kernel and the dk + dv
    kernel.  gm: the quantized upstream gradient's planes in q's layout;
    lse (B, KV, G, Sq) and delta (B, Sq, KV, G) the forward-saved rows;
    ds_exp the dS scale exponent; ``integer_exp`` the kept-int body (the
    forward's).  Returns ``(dq, dk, dv)`` in the model layout."""
    hd = qm.shape[-1]
    exps = torch.stack([e.reshape(()) for e in (q_exp, k_exp, v_exp, g_exp,
                                                ds_exp)]).to(torch.int32)
    kw = dict(p_bits=p_bits, ds_bits=ds_bits, causal=causal, window=window,
              sc=1.0 / float(hd) ** 0.5, integer_exp=integer_exp)
    dq = int_attn_bwd_dq(qm, km, vm, gm, lse, delta, q_off, exps, **kw)
    dk, dv = int_attn_bwd_dkv(qm, km, vm, gm, lse, delta, q_off, exps, **kw)
    return dq, dk, dv
