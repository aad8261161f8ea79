"""Transformer blocks built on the integer layers.

Counterpart of ``repro/models/blocks.py``: RoPE, GQA attention (causal with
a KV cache, or bidirectional for the encoder), the SwiGLU and GELU MLPs and
the RMS-norm / layer-norm wrappers, as plain functions over dicts of
tensors.  Every projection and norm goes through ``core.int_ops``; RoPE,
the softmax and the activations stay FP32.  When the policy enables
quantization at the ``attn.qk`` leaf, attention is
``int_ops.int_attention``; otherwise the FP32 reference path below (a plain
masked softmax, differentiable) runs.

The reference's ``health.probe`` calls are identities with probes
suspended and are left out.  Its ``subkey`` (a distinct PRNG key per call
site) has no counterpart: every call site gets the same ``key``, and a
``torch.Generator`` hands each draw the next numbers of its one stream.
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


def unstack(tree: Params, n: int) -> list:
    """The stacked ``(L, ...)`` block params as ``n`` per-layer trees of
    views (``unbind``: under autograd each stacked leaf's gradient is
    assembled once, a stack, not summed from ``n`` zero-padded slices)."""
    per = {k: unstack(v, n) if isinstance(v, dict) else v.unbind(0)
           for k, v in tree.items()}
    return [{k: v[i] for k, v in per.items()} for i in range(n)]


def mlp_leaves(cfg: ArchConfig, prefix: str = "mlp") -> list:
    """Integer-layer leaf paths of one MLP (policy-resolution probe set);
    ``act`` is the non-linearity's kept-ops leaf."""
    names = ("wg", "wu", "wd") if cfg.act == "silu" else ("w1", "w2")
    return [f"{prefix}.{n}" for n in names + ("act",)]


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


def _fp32_attention(q, k, v, *, causal: bool, q_offset,
                    window: Optional[int]) -> torch.Tensor:
    """FP32 reference attention (quantization disabled): masked softmax,
    causal or bidirectional; plain differentiable ops (the reference's XLA
    ``flash_attention`` at one KV chunk, which is no Pallas kernel).
    q: (B, Sq, KV, G, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, KV, G, hd)."""
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float() / hd ** 0.5, k.float())
    if causal:
        s = _causal_mask(s, q, Sq, Sk, q_offset, window)
    o = torch.einsum("bhgqk,bkhd->bhgqd", torch.softmax(s, dim=-1),
                     v.float())
    return o.permute(0, 3, 1, 2, 4)


def _causal_mask(s, q, Sq, Sk, q_offset, window):
    """Scores of keys after each query's position (or outside its window)
    set to -1e30."""
    qpos = (torch.as_tensor(q_offset, device=q.device).reshape(-1, 1)
            + torch.arange(Sq, device=q.device))               # (1|B, Sq)
    kpos = torch.arange(Sk, device=q.device)
    ok = kpos <= qpos[..., None]
    if window is not None:
        ok = ok & (kpos > qpos[..., None] - window)
    return torch.where(ok[:, None, None], s, _BIG_NEG)


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
    causal: bool = True,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_index=0,
    use_rope: bool = True,
) -> Tuple[torch.Tensor, Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """GQA self-attention, causal with RoPE (the LM) or bidirectional
    without (``causal=False, use_rope=False``: the encoder).  Returns (out,
    cache).  x: (B, S, D) at positions ``cache_index + [0, S)``.  A given
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
    if use_rope:
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
    win = cfg.sliding_window if causal else None
    if leaf_qk.enabled:
        o = int_ops.int_attention(q, k, v, q_offset, key, leaf_qk, leaf_pv,
                                  causal, win)
    else:
        o = _fp32_attention(q, k, v, causal=causal, q_offset=q_offset,
                            window=win)
    o = o.reshape(B, S, H * hd)
    out = int_ops.int_linear(o, p["wo"], None, key, sc.leaf("wo"))
    return out, new_cache


# =========================================================================
# Dense MLP (SwiGLU or GeLU)
# =========================================================================

def mlp_init(gen: torch.Generator, cfg: ArchConfig, device,
             lead: Tuple[int, ...] = ()) -> Params:
    D, F = cfg.d_model, cfg.d_ff
    if cfg.act == "silu":
        return {"wg": _init(gen, lead + (D, F), device),
                "wu": _init(gen, lead + (D, F), device),
                "wd": _init(gen, lead + (F, D), device)}
    return {"w1": _init(gen, lead + (D, F), device),
            "b1": torch.zeros(lead + (F,), device=device),
            "w2": _init(gen, lead + (F, D), device),
            "b2": torch.zeros(lead + (D,), device=device)}


def mlp_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, qcfg: QuantLike,
              key) -> torch.Tensor:
    """SwiGLU ``wd(silu(wg x) * wu x)`` or GELU ``w2 gelu(w1 x + b1) + b2``
    (the activation a kept FP32 op)."""
    sc = ensure_scope(qcfg)
    if "wg" in p:
        g = int_ops.int_linear(x, p["wg"], None, key, sc.leaf("wg"))
        u = int_ops.int_linear(x, p["wu"], None, key, sc.leaf("wu"))
        h = int_ops.int_activation(g, sc.leaf("act"), "silu") * u
        return int_ops.int_linear(h, p["wd"], None, key, sc.leaf("wd"))
    h = int_ops.int_linear(x, p["w1"], p["b1"], key, sc.leaf("w1"))
    h = int_ops.int_activation(h, sc.leaf("act"), "gelu")
    return int_ops.int_linear(h, p["w2"], p["b2"], key, sc.leaf("w2"))


# =========================================================================
# Norm wrappers
# =========================================================================

def norm_init(cfg: ArchConfig, device, lead: Tuple[int, ...] = ()) -> Params:
    p = {"g": torch.ones(lead + (cfg.d_model,), device=device)}
    if cfg.norm == "layernorm":
        p["b"] = torch.zeros(lead + (cfg.d_model,), device=device)
    return p


def norm_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, qcfg: QuantLike,
               key) -> torch.Tensor:
    leaf = ensure_scope(qcfg).cfg()      # the scope path IS the norm's path
    if "b" in p:
        return int_ops.int_layernorm(x, p["g"], p["b"], key, leaf)
    return int_ops.int_rmsnorm(x, p["g"], key, leaf)
