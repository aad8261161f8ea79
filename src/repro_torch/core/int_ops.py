"""Integer layers, forward only: linear / embedding / RMS-norm / attention.

Counterpart of the forward halves of ``repro/core/int_ops.py`` on the
reference's ``pallas`` route: every quantization goes through the quantize
kernel (the max-abs exponent stays plain PyTorch), every matmul through the
limb-plane matmul kernel, the norm through the integer RMS-norm kernel and
attention through the integer flash-attention kernel.  The kernels run on
the card for CUDA tensors and as their plain PyTorch versions for CPU
tensors.  With ``cfg.enabled`` False each layer is its FP32 reference.

Weights are re-quantized on every call, as in the reference (including the
whole embedding table in ``int_embedding`` and the tied head).

These are forward-only functions: with grad mode on and an input that
requires grad they raise — the backward kernels (``torch.autograd.Function``
wrappers) are not ported yet.  ``kept_ops="integer"`` is not ported yet
either.  ``key`` (stochastic forward rounding) must be None: serving rounds
to nearest.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import dfx
from repro_torch.core.qconfig import QuantConfig
from repro_torch.kernels import ops as kops


def _forward_only(what: str, *tensors) -> None:
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{what} is forward-only in this port (no backward kernels "
            "yet); run it under torch.no_grad()")


def _no_integer_kept_ops(cfg: QuantConfig, what: str) -> None:
    if cfg.enabled and cfg.kept_ops == "integer":
        raise NotImplementedError(
            f"{what}: kept_ops='integer' is not ported yet")


def _no_stochastic(cfg: QuantConfig, key) -> None:
    if cfg.enabled and cfg.stochastic_fwd and key is not None:
        raise NotImplementedError(
            "stochastic forward rounding is not ported yet")


def int_linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
               key, cfg: QuantConfig, *,
               transposed_w: bool = False) -> torch.Tensor:
    """``y = x @ w (+ b)`` with integer forward.  x: (..., K), w: (K, N).

    ``transposed_w``: ``w`` is given as its (N, K) transpose — the tied
    head's embedding table.  It is quantized in that layout (the op is
    elementwise under one scale) and its planes reach the matmul as the
    K-major view, so the table is never copied or transposed."""
    _forward_only("int_linear", x, w, b)
    if not cfg.enabled:
        y = torch.matmul(x, w.t() if transposed_w else w)
        return y + b if b is not None else y
    _no_stochastic(cfg, key)
    qx = dfx.quantize(x, cfg.act_bits, limb_planes=True)
    qw = dfx.quantize(w, cfg.weight_bits, limb_planes=True)
    wm = qw.m.transpose(-1, -2) if transposed_w else qw.m
    K = x.shape[-1]
    y2 = kops.dfx_matmul_tiled(qx.m.reshape(qx.m.shape[0], -1, K), qx.exp,
                               cfg.act_bits, wm, qw.exp, cfg.weight_bits)
    y = y2.reshape(tuple(x.shape[:-1]) + (wm.shape[-1],))
    return y + b if b is not None else y   # O(N) bias add, kept FP32


def int_embedding(table: torch.Tensor, ids: torch.Tensor, key,
                  cfg: QuantConfig) -> torch.Tensor:
    """Embedding lookup from the b-bit quantized table: gather the integer
    mantissas, then the inverse mapping."""
    _forward_only("int_embedding", table)
    if not cfg.enabled or not cfg.int_embedding:
        return table[ids]
    _no_stochastic(cfg, key)
    qt = dfx.quantize(table, cfg.weight_bits)
    return qt.m[ids].to(torch.float32) * dfx.pow2(qt.exp)


def int_rmsnorm(x: torch.Tensor, gamma: torch.Tensor, key, cfg: QuantConfig,
                eps: float = 1e-6) -> torch.Tensor:
    """RMS-norm over the act-bit mantissas of ``x`` with the weight-bit
    fake-quantized ``gamma``, through the integer RMS-norm kernel."""
    _forward_only("int_rmsnorm", x, gamma)
    if cfg.enabled and cfg.int_layernorm:
        _no_integer_kept_ops(cfg, "int_rmsnorm")
        _no_stochastic(cfg, key)
        xq = dfx.quantize(x, cfg.act_bits)
        gv = dfx.dequantize(dfx.quantize(gamma, cfg.weight_bits))
        D = x.shape[-1]
        y, _ = kops.rmsnorm(xq.m.reshape(-1, D), xq.exp, gv, eps=eps)
        return y.reshape(x.shape)
    ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(ms + eps) * gamma


_ACT_FNS = {"gelu": lambda x: F.gelu(x, approximate="tanh"),
            "silu": F.silu, "tanh": torch.tanh}


def int_activation(x: torch.Tensor, cfg: QuantConfig,
                   kind: str) -> torch.Tensor:
    """Kept-op activation, ``kind`` in {"gelu", "silu", "tanh"}: the FP32
    op (``kept_ops="integer"`` is not ported yet)."""
    if kind not in _ACT_FNS:
        raise KeyError(f"int_activation kind {kind!r} not in "
                       f"{sorted(_ACT_FNS)}")
    _no_integer_kept_ops(cfg, "int_activation")
    return _ACT_FNS[kind](x)


def int_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_offset, key, cfg_qk: QuantConfig, cfg_pv: QuantConfig,
                  causal: bool, window: Optional[int]) -> torch.Tensor:
    """Scaled-dot-product attention with integer QKᵀ and PV products.

    q: (B, Sq, KV, G, hd); k, v: (B, Sk, KV, hd) (GQA layout); q_offset a
    scalar or (B,) query position offset.  q and k quantize at
    ``cfg_qk.act_bits``, v and P at ``cfg_pv.act_bits``, each over the
    whole tensor (for a KV cache: every slot and every empty position).
    Returns (B, Sq, KV, G, hd) f32.
    """
    _forward_only("int_attention", q, k, v)
    _no_integer_kept_ops(cfg_qk, "int_attention")
    _no_stochastic(cfg_qk, key)
    B = q.shape[0]
    off = torch.as_tensor(q_offset, device=q.device).to(torch.int32)
    off = torch.broadcast_to(off.reshape(-1), (B,)).contiguous()
    qq = dfx.quantize(q, cfg_qk.act_bits, limb_planes=True)
    qk = dfx.quantize(k, cfg_qk.act_bits, limb_planes=True)
    qv = dfx.quantize(v, cfg_pv.act_bits, limb_planes=True)
    o, _ = kops.attention_fwd(qq.m, qq.exp, qk.m, qk.exp, qv.m, qv.exp, off,
                              cfg_pv.act_bits, causal=causal, window=window)
    return o
