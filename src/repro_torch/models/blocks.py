"""Transformer blocks built on the integer layers (dense family).

Counterpart of ``repro/models/blocks.py``: RoPE, GQA attention with a KV
cache, the SwiGLU MLP and the RMS-norm wrapper, as plain functions over
dicts of tensors.  Every projection goes through ``core.int_ops``; RoPE and
the activation stay FP32.  When the policy enables quantization at the
``attn.qk`` leaf, attention is ``int_ops.int_attention``; otherwise the FP32
reference path below (a plain masked softmax) runs.

The reference's ``health.probe`` calls are identities on the serving path
(its serve scan runs under ``health.suspend()``) and are left out; so is
``subkey``, since serving draws no randomness (every key is None).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import int_ops
from repro_torch.core.qpolicy import QuantLike, ensure_scope
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]

_BIG_NEG = -1e30


def _init(gen: torch.Generator, shape, device, scale: float = 0.02):
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32) * scale


def mlp_leaves(prefix: str = "mlp") -> list:
    """Integer-layer leaf paths of one SwiGLU MLP (policy-resolution probe
    set)."""
    return [f"{prefix}.{n}" for n in ("wg", "wu", "wd", "act")]


# =========================================================================
# RoPE (FP32)
# =========================================================================

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S)."""
    hd = x.shape[-1]
    half = hd // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(-torch.arange(half, dtype=torch.float32)
                      * (log_theta / half)).to(x.device)
    ang = positions[..., None].to(torch.float32) * freqs     # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _fp32_attention(q, k, v, *, q_offset,
                    window: Optional[int]) -> torch.Tensor:
    """FP32 reference attention (quantization disabled): causal masked
    softmax.
    q: (B, Sq, KV, G, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, KV, G, hd)."""
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float() / hd ** 0.5, k.float())
    qpos = (torch.as_tensor(q_offset, device=q.device).reshape(-1, 1)
            + torch.arange(Sq, device=q.device))               # (1|B, Sq)
    kpos = torch.arange(Sk, device=q.device)
    ok = kpos <= qpos[..., None]
    if window is not None:
        ok = ok & (kpos > qpos[..., None] - window)
    s = torch.where(ok[:, None, None], s, _BIG_NEG)
    o = torch.einsum("bhgqk,bkhd->bhgqd", torch.softmax(s, dim=-1),
                     v.float())
    return o.permute(0, 3, 1, 2, 4)


# =========================================================================
# Attention layer (GQA, optional sliding window, KV cache)
# =========================================================================

def attention_init(gen: torch.Generator, cfg: ArchConfig, device,
                   lead: Tuple[int, ...] = ()) -> Params:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": _init(gen, lead + (D, H * hd), device),
        "wk": _init(gen, lead + (D, KV * hd), device),
        "wv": _init(gen, lead + (D, KV * hd), device),
        "wo": _init(gen, lead + (H * hd, D), device),
    }
    if cfg.qkv_bias:
        p.update(bq=torch.zeros(lead + (H * hd,), device=device),
                 bk=torch.zeros(lead + (KV * hd,), device=device),
                 bv=torch.zeros(lead + (KV * hd,), device=device))
    return p


def write_cache(ck: torch.Tensor, cv: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, cache_index) -> None:
    """Write S new (B, S, KV, hd) rows into the (B, Smax, KV, hd) caches in
    place at a scalar or per-row (B,) start index, clamped into
    [0, Smax - S] like the reference's ``dynamic_update_slice``."""
    B, S = k.shape[:2]
    idx = torch.as_tensor(cache_index, device=ck.device).reshape(-1, 1)
    start = idx.clamp(0, ck.shape[1] - S)
    rows = (start + torch.arange(S, device=ck.device)).expand(B, S)
    bidx = torch.arange(B, device=ck.device)[:, None].expand(B, S)
    ck[bidx, rows] = k.to(ck.dtype)
    cv[bidx, rows] = v.to(cv.dtype)


def attention_apply(
    p: Params, x: torch.Tensor, cfg: ArchConfig, qcfg: QuantLike, key,
    *,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_index=0,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Causal GQA self-attention with RoPE.  Returns (out, cache).
    x: (B, S, D) at positions ``cache_index + [0, S)``.  A given
    ``kv_cache`` (k, v) of shape (B, Smax, KV, hd) is updated in place (the
    reference returns an updated copy) and attention then runs over the
    whole cache."""
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // KV
    sc = ensure_scope(qcfg)
    q = int_ops.int_linear(x, p["wq"], p.get("bq"), key, sc.leaf("wq"))
    k = int_ops.int_linear(x, p["wk"], p.get("bk"), key, sc.leaf("wk"))
    v = int_ops.int_linear(x, p["wv"], p.get("bv"), key, sc.leaf("wv"))
    q = q.reshape(B, S, KV, G, hd)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)

    idx = torch.as_tensor(cache_index, device=x.device)
    positions = (idx.reshape(-1, 1)
                 + torch.arange(S, device=x.device)).expand(B, S)
    q = rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta).reshape(
        B, S, KV, G, hd)
    k = rope(k, positions, cfg.rope_theta)

    new_cache = None
    q_offset = 0
    if kv_cache is not None:
        ck, cv = kv_cache
        write_cache(ck, cv, k, v, idx)
        new_cache = (ck, cv)
        k, v = ck, cv
        q_offset = idx

    leaf_qk = sc.leaf("qk")
    leaf_pv = sc.leaf("pv")
    win = cfg.sliding_window
    if leaf_qk.enabled:
        o = int_ops.int_attention(q, k, v, q_offset, key, leaf_qk, leaf_pv,
                                  True, win)
    else:
        o = _fp32_attention(q, k, v, q_offset=q_offset, window=win)
    o = o.reshape(B, S, H * hd)
    out = int_ops.int_linear(o, p["wo"], None, key, sc.leaf("wo"))
    return out, new_cache


# =========================================================================
# Dense MLP (SwiGLU or GeLU)
# =========================================================================

def mlp_init(gen: torch.Generator, cfg: ArchConfig, device,
             lead: Tuple[int, ...] = ()) -> Params:
    if cfg.act != "silu":
        raise NotImplementedError("only the SwiGLU MLP is ported")
    D, F = cfg.d_model, cfg.d_ff
    return {"wg": _init(gen, lead + (D, F), device),
            "wu": _init(gen, lead + (D, F), device),
            "wd": _init(gen, lead + (F, D), device)}


def mlp_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, qcfg: QuantLike,
              key) -> torch.Tensor:
    """SwiGLU: wd(silu(wg x) * wu x)."""
    sc = ensure_scope(qcfg)
    g = int_ops.int_linear(x, p["wg"], None, key, sc.leaf("wg"))
    u = int_ops.int_linear(x, p["wu"], None, key, sc.leaf("wu"))
    h = int_ops.int_activation(g, sc.leaf("act"), "silu") * u
    return int_ops.int_linear(h, p["wd"], None, key, sc.leaf("wd"))


# =========================================================================
# Norm wrappers
# =========================================================================

def norm_init(cfg: ArchConfig, device, lead: Tuple[int, ...] = ()) -> Params:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError("only RMS-norm is ported")
    return {"g": torch.ones(lead + (cfg.d_model,), device=device)}


def norm_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, qcfg: QuantLike,
               key) -> torch.Tensor:
    return int_ops.int_rmsnorm(x, p["g"], key, ensure_scope(qcfg).cfg())
