"""Integer layers: linear (the tied head included), the MoE experts'
batched linear, embedding, layer-norm, RMS-norm and attention, each with
integer forward and backward.

Counterpart of ``repro/core/int_ops.py`` on the reference's ``pallas``
route: every quantization goes through the quantize kernel (the max-abs
exponent stays plain PyTorch), every matmul through the limb-plane matmul
kernels, the norms through the integer norm kernels and attention through
the integer flash-attention kernel.  The kernels run on the card for CUDA
tensors and as their plain PyTorch versions for CPU tensors.  With
``cfg.enabled`` False each layer is its FP32 reference (plain autograd).

``int_patch_embed`` (ViT) is a reshape in front of ``int_linear``.
``int_linear``, ``int_batched_linear``, ``int_embedding``,
``int_layernorm``, ``int_rmsnorm`` and ``int_attention`` are
``torch.autograd.Function``s, the counterparts of the reference's
``custom_vjp``s (paper, Fig. 2):

    forward:   q(X)·q(W)              NN limb matmul
    backward:  dX = q(G)·q(W)ᵀ        NT limb matmul
               dW = q(X)ᵀ·q(G)        TN limb matmul

The residuals are the quantized limb planes / mantissas and their
exponents, never the f32 inputs.  Each backward quantizes the upstream
gradient once, at ``grad_bits``, and uses it for every product; it rounds
stochastically (``floor(y + u)``, the paper's Assumption 2) when
``cfg.stochastic_grad`` is set and a ``key`` is given, else to nearest.
``key`` stands where the reference has a PRNG key: None, a
``torch.Generator`` on the tensors' device, or a callable handing in the
noise (``core/dfx.py::uniform``).  Weights are re-quantized on every call,
as in the reference.

Attention's backward (flash-attention-2 form, the reference's
``_int_attention_bwd``) runs the dq and dk + dv kernels over the saved
q / k / v planes, o and lse; ``delta`` and the dS exponent (from the row
norms of the raw upstream gradient and of v) are plain PyTorch, as the
reference leaves them to XLA.

``kept_ops="integer"`` (DESIGN.md §10) swaps the kept FP32 ops for the
Q.14 forms of ``core/iapprox.py``, as the reference routes them: the
norms' rsqrt and attention's softmax exp / normalizer inside the same
kernel launches (their ``integer_rsqrt`` / ``integer_exp`` bodies), the
activations as an autograd Function whose backward is the iapprox
derivative, and the standalone softmax (the MoE router) as ``i_softmax``,
through whose integer casts no gradient flows (the reference's cotangent
there is zero too).

``stochastic_fwd`` with a key rounds each layer's activation quantization
stochastically too (not the weights').  As the reference splits its key,
the activation noise is drawn first (attention: q, k, then v), the
gradient noise later, in the backward.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import dfx, iapprox
from repro_torch.core.qconfig import QuantConfig
from repro_torch.kernels import int_norm
from repro_torch.kernels import ops as kops


def _kept_int(cfg: QuantConfig) -> bool:
    return cfg.enabled and cfg.kept_ops == "integer"


def _act_noise(x: torch.Tensor, cfg: QuantConfig, key, stacked=False):
    """Noise ``u`` for the activation's forward quantization when
    ``cfg.stochastic_fwd`` and a key is given (over the 2-D view, or the
    whole (E, C, K) stack), else None."""
    if not (cfg.stochastic_fwd and key is not None):
        return None
    shape = tuple(x.shape) if stacked else (x.numel() // x.shape[-1],
                                            x.shape[-1])
    return dfx.uniform(key, shape, x.device)


def _quant_grad(g: torch.Tensor, cfg: QuantConfig, key,
                limb_planes: bool = False) -> dfx.DfxTensor:
    """The upstream gradient at ``grad_bits``: stochastic rounding with
    noise from ``key`` when ``cfg.stochastic_grad`` and a key is given
    (over the 2-D view, as the reference draws it), else to nearest."""
    u = None
    if cfg.stochastic_grad and key is not None:
        u = dfx.uniform(key, (g.numel() // g.shape[-1], g.shape[-1]),
                        g.device)
    return dfx.quantize(g, cfg.grad_bits, u=u, limb_planes=limb_planes)


# =========================================================================
# Linear
# =========================================================================

class _IntLinear(torch.autograd.Function):
    """Integer linear: residuals are the (L, M, K) activation planes and the
    weight planes, with their exponents."""

    @staticmethod
    def forward(ctx, x, w, b, key, cfg: QuantConfig, transposed_w: bool):
        qx = dfx.quantize(x, cfg.act_bits, u=_act_noise(x, cfg, key),
                          limb_planes=True)
        qw = dfx.quantize(w, cfg.weight_bits, limb_planes=True)
        wm = qw.m.transpose(-1, -2) if transposed_w else qw.m
        K = x.shape[-1]
        xm = qx.m.reshape(qx.m.shape[0], -1, K)
        y2 = kops.dfx_matmul_tiled(xm, qx.exp, cfg.act_bits, wm, qw.exp,
                                   cfg.weight_bits)
        y = y2.reshape(tuple(x.shape[:-1]) + (wm.shape[-1],))
        ctx.save_for_backward(xm, qx.exp, qw.m, qw.exp)
        ctx.cfg, ctx.key, ctx.transposed_w = cfg, key, transposed_w
        ctx.x_shape, ctx.has_b = tuple(x.shape), b is not None
        return y + b if b is not None else y   # O(N) bias add, kept FP32

    @staticmethod
    def backward(ctx, g):
        xm, x_exp, wm, w_exp = ctx.saved_tensors
        cfg = ctx.cfg
        N = g.shape[-1]
        qg = _quant_grad(g, cfg, ctx.key, limb_planes=True)
        g2 = qg.m.reshape(qg.m.shape[0], -1, N)
        gb = cfg.grad_bits
        dx = dw = db = None
        if ctx.transposed_w:
            # the (V, D) table's planes as quantized: dX = q(G)·table is NN,
            # dTable = q(G)ᵀ·q(X) is TN landing in (V, D); no transposed copy
            if ctx.needs_input_grad[0]:
                dx = kops.dfx_matmul_tiled(g2, qg.exp, gb, wm, w_exp,
                                           cfg.weight_bits)
            if ctx.needs_input_grad[1]:
                dw = kops.dfx_matmul_tiled_tn(g2, qg.exp, gb, xm, x_exp,
                                              cfg.act_bits)
        else:
            if ctx.needs_input_grad[0]:
                dx = kops.dfx_matmul_tiled_nt(g2, qg.exp, gb, wm, w_exp,
                                              cfg.weight_bits)
            if ctx.needs_input_grad[1]:
                dw = kops.dfx_matmul_tiled_tn(xm, x_exp, cfg.act_bits, g2,
                                              qg.exp, gb)
        if dx is not None:
            dx = dx.reshape(ctx.x_shape)
        if ctx.has_b and ctx.needs_input_grad[2]:
            db = g.reshape(-1, N).sum(0)
        return dx, dw, db, None, None, None


def int_linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
               key, cfg: QuantConfig, *,
               transposed_w: bool = False) -> torch.Tensor:
    """``y = x @ w (+ b)`` with integer forward and backward.  x: (..., K),
    w: (K, N), b: (N,) or None.

    ``transposed_w``: ``w`` is given as its (N, K) transpose — the tied
    head's embedding table.  It is quantized in that layout (the op is
    elementwise under one scale) and its planes reach the matmul as the
    K-major view, so the table is never copied or transposed; the backward
    reads the same planes (dX an NN product, the table's gradient a TN
    product in the table's own layout)."""
    if not cfg.enabled:
        y = torch.matmul(x, w.t() if transposed_w else w)
        return y + b if b is not None else y
    return _IntLinear.apply(x, w, b, key, cfg, transposed_w)


def int_patch_embed(images: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor], key, cfg: QuantConfig,
                    patch: int) -> torch.Tensor:
    """ViT patch embedding = non-overlapping conv = reshape + int_linear.

    images: (B, H, W, C); w: (patch*patch*C, D) -> (B, H/p·W/p, D), each
    patch flattened in (row, column, channel) order as in the reference."""
    B, H, W, C = images.shape
    x = images.reshape(B, H // patch, patch, W // patch, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(
        B, (H // patch) * (W // patch), -1)
    return int_linear(x, w, b, key, cfg)


# =========================================================================
# Batched (per-expert) linear
# =========================================================================

class _IntBatchedLinear(torch.autograd.Function):
    """``y[e] = x[e] @ w[e]`` with one DFX scale per expert.  Residuals: the
    plane-major activation and weight planes and their (E, 1, 1)
    exponents."""

    @staticmethod
    def forward(ctx, x, w, key, cfg: QuantConfig):
        qx = dfx.quantize_stacked(x, cfg.act_bits,
                                  u=_act_noise(x, cfg, key, stacked=True),
                                  limb_planes=True)
        qw = dfx.quantize_stacked(w, cfg.weight_bits, limb_planes=True)
        y = kops.dfx_matmul_tiled_batched(qx.m, qx.exp, cfg.act_bits, qw.m,
                                          qw.exp, cfg.weight_bits)
        ctx.save_for_backward(qx.m, qx.exp, qw.m, qw.exp)
        ctx.cfg, ctx.key = cfg, key
        return y

    @staticmethod
    def backward(ctx, g):
        xm, x_exp, wm, w_exp = ctx.saved_tensors
        cfg = ctx.cfg
        u = None
        if cfg.stochastic_grad and ctx.key is not None:
            u = dfx.uniform(ctx.key, g.shape, g.device)   # the whole stack
        qg = dfx.quantize_stacked(g, cfg.grad_bits, u=u, limb_planes=True)
        gb = cfg.grad_bits
        dx = dw = None
        # one batched launch per direction covers every expert and limb pair
        if ctx.needs_input_grad[0]:
            dx = kops.dfx_matmul_tiled_batched_nt(qg.m, qg.exp, gb, wm, w_exp,
                                                  cfg.weight_bits)
        if ctx.needs_input_grad[1]:
            dw = kops.dfx_matmul_tiled_batched_tn(xm, x_exp, cfg.act_bits,
                                                  qg.m, qg.exp, gb)
        return dx, dw, None, None


def int_batched_linear(x: torch.Tensor, w: torch.Tensor, key,
                       cfg: QuantConfig) -> torch.Tensor:
    """``y[e] = x[e] @ w[e]`` with integer forward and backward and a DFX
    scale per expert.  x: (E, C, K), w: (E, K, N) -> (E, C, N).

    Forward: x and w quantized per expert (grouped quantize launches), one
    batched NN launch.  Backward: the upstream gradient quantized per
    expert at ``grad_bits`` (stochastically from ``key``, one draw over the
    stack), then one batched NT launch (dX) and one TN launch (dW).  With
    ``cfg.enabled`` False: FP32 einsums."""
    if not cfg.enabled:
        return torch.einsum("eck,ekn->ecn", x, w)
    return _IntBatchedLinear.apply(x, w, key, cfg)


# =========================================================================
# Embedding
# =========================================================================

class _IntEmbedding(torch.autograd.Function):
    """Lookup from the quantized table; the backward scatter-adds the
    dequantized, grad-bit quantized gradient into a zero table."""

    @staticmethod
    def forward(ctx, table, ids, key, cfg: QuantConfig):
        qt = dfx.quantize(table, cfg.weight_bits)
        ctx.save_for_backward(ids)
        ctx.cfg, ctx.key, ctx.table_shape = cfg, key, tuple(table.shape)
        return qt.m[ids].to(torch.float32) * dfx.pow2(qt.exp)

    @staticmethod
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        gq = dfx.dequantize(_quant_grad(g, ctx.cfg, ctx.key))
        D = ctx.table_shape[-1]
        dt = torch.zeros(ctx.table_shape, dtype=torch.float32,
                         device=g.device)
        dt.index_add_(0, ids.reshape(-1), gq.reshape(-1, D))
        return dt, None, None, None


def int_embedding(table: torch.Tensor, ids: torch.Tensor, key,
                  cfg: QuantConfig) -> torch.Tensor:
    """Embedding lookup from the b-bit quantized table: gather the integer
    mantissas, then the inverse mapping (no activation to round
    stochastically: ``stochastic_fwd`` leaves it as the reference does)."""
    if not cfg.enabled or not cfg.int_embedding:
        return table[ids]
    return _IntEmbedding.apply(table, ids, key, cfg)


# =========================================================================
# Layer norm (and RMS norm)
# =========================================================================

class _IntLayerNorm(torch.autograd.Function):
    """Layer-norm over the act-bit mantissas through the fused kernels.
    The residuals are the mantissas, the dequantized γ and the (mu, rstd)
    the forward kernel normalised with; the backward kernel rebuilds xn
    from them, so it differentiates exactly the forward that ran."""

    @staticmethod
    def forward(ctx, x, gamma, beta, key, cfg: QuantConfig, eps: float):
        xq = dfx.quantize(x, cfg.act_bits, u=_act_noise(x, cfg, key))
        gv = dfx.dequantize(dfx.quantize(gamma, cfg.weight_bits))
        D = x.shape[-1]
        xm = xq.m.reshape(-1, D)
        y, mu, rstd = int_norm.int_layernorm_fwd(
            xm, xq.exp, gv, beta, eps=eps, integer_rsqrt=_kept_int(cfg))
        ctx.save_for_backward(xm, xq.exp, gv, mu, rstd)
        ctx.cfg, ctx.key = cfg, key
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        xm, x_exp, gv, mu, rstd = ctx.saved_tensors
        qg = _quant_grad(g, ctx.cfg, ctx.key)
        dx, dgamma, dbeta = int_norm.int_layernorm_bwd(
            xm, qg.m.reshape(xm.shape), x_exp, qg.exp, gv, mu, rstd)
        return dx.reshape(g.shape), dgamma, dbeta, None, None, None


def int_layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  key, cfg: QuantConfig, eps: float = 1e-5) -> torch.Tensor:
    """Layer-norm with integer statistics forward and backward (the
    weight-bit fake-quantized γ; β stays FP32, the rsqrt too unless
    ``kept_ops="integer"``)."""
    if cfg.enabled and cfg.int_layernorm:
        return _IntLayerNorm.apply(x, gamma, beta, key, cfg, eps)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * gamma + beta


class _IntRmsNorm(torch.autograd.Function):
    """RMS-norm over the act-bit mantissas through the fused kernels.  The
    residuals are the mantissas and their exponent, the dequantized γ and
    the rstd the forward kernel normalised with."""

    @staticmethod
    def forward(ctx, x, gamma, key, cfg: QuantConfig, eps: float):
        xq = dfx.quantize(x, cfg.act_bits, u=_act_noise(x, cfg, key))
        gv = dfx.dequantize(dfx.quantize(gamma, cfg.weight_bits))
        D = x.shape[-1]
        xm = xq.m.reshape(-1, D)
        y, rstd = kops.rmsnorm(xm, xq.exp, gv, eps=eps,
                               integer_rsqrt=_kept_int(cfg))
        ctx.save_for_backward(xm, xq.exp, gv, rstd)
        ctx.cfg, ctx.key = cfg, key
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        xm, x_exp, gv, rstd = ctx.saved_tensors
        qg = _quant_grad(g, ctx.cfg, ctx.key)
        dx, dgamma = kops.rmsnorm_bwd(xm, x_exp, qg.m.reshape(xm.shape),
                                      qg.exp, gv, rstd)
        return dx.reshape(g.shape), dgamma, None, None, None


def int_rmsnorm(x: torch.Tensor, gamma: torch.Tensor, key, cfg: QuantConfig,
                eps: float = 1e-6) -> torch.Tensor:
    """RMS-norm over the act-bit mantissas of ``x`` with the weight-bit
    fake-quantized ``gamma``, through the integer RMS-norm kernels forward
    and backward."""
    if cfg.enabled and cfg.int_layernorm:
        return _IntRmsNorm.apply(x, gamma, key, cfg, eps)
    ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * gamma


#: kind -> (FP32 op, integer forward, integer derivative)
_ACT_FNS = {"gelu": (lambda x: F.gelu(x, approximate="tanh"),
                     iapprox.i_gelu, iapprox.d_gelu),
            "silu": (F.silu, iapprox.i_silu, iapprox.d_silu),
            "tanh": (torch.tanh, iapprox.i_tanh, iapprox.d_tanh)}


class _IntAct(torch.autograd.Function):
    """The iapprox activation; its backward is ``g · d_<kind>(x)`` (the
    reference's custom_vjp)."""

    @staticmethod
    def forward(ctx, x, kind: str):
        ctx.save_for_backward(x)
        ctx.kind = kind
        return _ACT_FNS[kind][1](x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * _ACT_FNS[ctx.kind][2](x), None


def int_activation(x: torch.Tensor, cfg: QuantConfig,
                   kind: str) -> torch.Tensor:
    """Kept-op activation, ``kind`` in {"gelu", "silu", "tanh"}: the FP32
    op, or under an enabled ``kept_ops="integer"`` config the iapprox form
    with the iapprox derivative as its backward."""
    if kind not in _ACT_FNS:
        raise KeyError(f"int_activation kind {kind!r} not in "
                       f"{sorted(_ACT_FNS)}")
    if _kept_int(cfg):
        return _IntAct.apply(x, kind)
    return _ACT_FNS[kind][0](x)


def int_softmax(x: torch.Tensor, cfg: QuantConfig,
                dim: int = -1) -> torch.Tensor:
    """Softmax outside attention (the MoE router's gate): the FP32 op, or
    under an enabled ``kept_ops="integer"`` config ``i_softmax``, which
    carries no gradient (the router then learns nothing through it, as in
    the reference)."""
    if _kept_int(cfg):
        return iapprox.i_softmax(x, dim=dim)
    return torch.softmax(x, dim=dim)


def _max_row_norm(x: torch.Tensor) -> torch.Tensor:
    """max over rows of ‖x_row‖₂ along the trailing (head) dim: f32 0-d."""
    return torch.sqrt(torch.amax(torch.sum(torch.square(x.float()), dim=-1)))


def _ds_exp(g_norm: torch.Tensor, v_norm: torch.Tensor,
            ds_bits: int) -> torch.Tensor:
    """dS's scale exponent (int32 0-d), the reference's bound: |dS| <=
    2·max‖dO_row‖·max‖v_row‖, so ``ceil(log2(bound)) - (ds_bits - 1)``."""
    bound = 2.0 * g_norm * v_norm
    e = torch.ceil(torch.log2(torch.clamp(bound, min=1e-30))) - (ds_bits - 1)
    return e.to(torch.int32)


class _IntAttention(torch.autograd.Function):
    """Integer flash attention.  Residuals: the q / k / v limb planes and
    exponents, o, lse and max‖v_row‖ (for dS's exponent)."""

    @staticmethod
    def forward(ctx, q, k, v, off, key, cfg_qk: QuantConfig,
                cfg_pv: QuantConfig, causal: bool, window):
        # q, k, v noise in that order (the reference's split of its key);
        # all three follow cfg_qk.stochastic_fwd, as there
        qq, qk, qv = (dfx.quantize(t, bits, u=_act_noise(t, cfg_qk, key),
                                   limb_planes=True)
                      for t, bits in ((q, cfg_qk.act_bits),
                                      (k, cfg_qk.act_bits),
                                      (v, cfg_pv.act_bits)))
        iexp = _kept_int(cfg_qk)
        o, lse = kops.attention_fwd(qq.m, qq.exp, qk.m, qk.exp, qv.m, qv.exp,
                                    off, cfg_pv.act_bits, causal=causal,
                                    window=window, integer_exp=iexp)
        v_norm = _max_row_norm(v) if any(ctx.needs_input_grad[:3]) else None
        ctx.save_for_backward(qq.m, qq.exp, qk.m, qk.exp, qv.m, qv.exp, o,
                              lse, v_norm, off)
        ctx.cfg_qk, ctx.cfg_pv, ctx.key = cfg_qk, cfg_pv, key
        ctx.causal, ctx.window, ctx.iexp = causal, window, iexp
        return o

    @staticmethod
    def backward(ctx, g):
        qm, q_exp, km, k_exp, vm, v_exp, o, lse, v_norm, off = \
            ctx.saved_tensors
        cfg_qk, cfg_pv = ctx.cfg_qk, ctx.cfg_pv
        qg = _quant_grad(g, cfg_pv, ctx.key, limb_planes=True)
        # delta = rowsum(dO ∘ o) over the RAW upstream gradient (a kept op)
        delta = torch.sum(g * o, dim=-1)                      # (B, Sq, KV, G)
        ds_bits = cfg_qk.grad_bits
        ds_exp = _ds_exp(_max_row_norm(g), v_norm, ds_bits)
        dq, dk, dv = kops.attention_bwd(
            qm, q_exp, km, k_exp, vm, v_exp, qg.m, qg.exp, lse, delta,
            ds_exp, off, cfg_pv.act_bits, ds_bits, causal=ctx.causal,
            window=ctx.window, integer_exp=ctx.iexp)
        return dq, dk, dv, None, None, None, None, None, None


def int_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_offset, key, cfg_qk: QuantConfig, cfg_pv: QuantConfig,
                  causal: bool, window: Optional[int]) -> torch.Tensor:
    """Scaled-dot-product attention with integer QKᵀ and PV products,
    forward and backward.

    q: (B, Sq, KV, G, hd); k, v: (B, Sk, KV, hd) (GQA layout); q_offset a
    scalar or (B,) query position offset (not differentiated).  q and k
    quantize at ``cfg_qk.act_bits``, v and P at ``cfg_pv.act_bits``, each
    over the whole tensor (for a KV cache: every slot and every empty
    position).  The backward quantizes the upstream gradient at
    ``cfg_pv.grad_bits`` and dS at ``cfg_qk.grad_bits``.  Under an enabled
    ``cfg_qk.kept_ops="integer"`` the softmax's exp and normalizer are the
    Q.14 forms, forward and backward.  Returns (B, Sq, KV, G, hd) f32.
    """
    B = q.shape[0]
    off = torch.as_tensor(q_offset, device=q.device).to(torch.int32)
    off = torch.broadcast_to(off.reshape(-1), (B,)).contiguous()
    return _IntAttention.apply(q, k, v, off, key, cfg_qk, cfg_pv, causal,
                               window)
