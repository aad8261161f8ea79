"""Transformer blocks built on the integer layers.

Counterpart of ``repro/models/blocks.py``: RoPE, GQA attention (causal with
a KV cache, or bidirectional for the encoder), the SwiGLU and GELU MLPs, the
mixture of experts (top-k router, capacity dispatch, per-expert integer
SwiGLU, optional shared expert) and the RMS-norm / layer-norm wrappers, as
plain functions over dicts of tensors.  Every projection and norm goes
through ``core.int_ops``; RoPE stays FP32, and the softmaxes and the
activations are FP32 unless the leaf's ``kept_ops="integer"`` swaps them
for the iapprox forms (``int_ops.int_activation`` / ``int_softmax``, and
attention's in-kernel exp).  When the policy enables
quantization at the ``attn.qk`` leaf, attention is
``int_ops.int_attention``; otherwise the reference's FP32 paths run as plain
differentiable ops: ``flash_attention`` (an online softmax over KV chunks)
or, for one query over a KV cache, ``_decode_attention``.

Each block probes the tensor it is about to quantize at the reference's
scope paths (``health.probe``: the attention input, the MLP's, the MoE
router's, each norm's), which does nothing unless a sentinel step has a
collector open.  The reference's ``subkey`` (a distinct PRNG key per call
site) has no counterpart: every call site gets the same ``key``, and a
``torch.Generator`` hands each draw the next numbers of its one stream.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import health, int_ops
from repro_torch.core.qpolicy import QuantLike, ensure_scope
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]

_BIG_NEG = -1e30


def _init(gen: torch.Generator, shape, device, scale: float = 0.02):
    # scaled in place: no second copy of the largest stacks (a full-depth
    # MoE expert stack is 16.6 GB)
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).mul_(scale)


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


# =========================================================================
# FP32 attention (quantization disabled at ``attn.qk``): the reference's
# online softmax over KV chunks, and its single-pass decode form
# =========================================================================

def _scale(hd: int) -> float:
    """The reference's ``1 / sqrt(float32(hd))``, rounded to f32 as it is
    there (a Python float that a float32 tensor takes exactly)."""
    return float(1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32)))


def _chunk_mask(qpos, c: int, chunk: int, Sk: int, causal: bool,
                window: Optional[int]) -> torch.Tensor:
    """Keys ``c * chunk ..`` each query may see, as the reference masks
    them: inside the keys (``kpos < Sk``: the zero-padded ragged last
    chunk is out), not after the query (causal), inside the window.
    (1|B, 1, 1, Sq, chunk), broadcasting against (B, KV, G, Sq, chunk)."""
    kpos = c * chunk + torch.arange(chunk, device=qpos.device)
    ok = (kpos < Sk).expand(qpos.shape + (chunk,))
    if causal:
        ok = ok & (kpos <= qpos[..., None])
    if window is not None:
        ok = ok & (kpos > qpos[..., None] - window)
    return ok[:, None, None]


class _FlashAttention(torch.autograd.Function):
    """The online softmax over KV chunks, forward as the reference computes
    it; the backward is flash attention's: it keeps q, k, v, the output
    and each row's final max and normalizer (no chunk's scores) and, chunk
    by chunk, recomputes the probabilities ``P`` and forms ``dS = P ∘ (dP
    - rowsum(dO ∘ O))``.  qs: the scaled queries (B, Sq, KV, G, hd); k, v:
    (B, n·chunk, KV, hd), zero-padded; qpos: (1|B, Sq)."""

    @staticmethod
    def forward(ctx, qs, k, v, qpos, Sk: int, chunk: int, causal: bool,
                window):
        B, Sq, KV, G, hd = qs.shape
        f = dict(device=qs.device, dtype=qs.dtype)
        m = torch.full((B, KV, G, Sq), _BIG_NEG, **f)
        l = torch.zeros((B, KV, G, Sq), **f)
        acc = torch.zeros((B, KV, G, Sq, hd), **f)
        for c in range(k.shape[1] // chunk):
            sl = slice(c * chunk, (c + 1) * chunk)
            okb = _chunk_mask(qpos, c, chunk, Sk, causal, window)
            s = torch.where(okb, torch.einsum("bqhgd,bkhd->bhgqk", qs,
                                              k[:, sl]), _BIG_NEG)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(okb, torch.exp(s - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, v[:, sl])
            m = m_new
        l = torch.clamp(l, min=1e-20)
        out = acc / l[..., None]
        ctx.save_for_backward(qs, k, v, qpos, m, l, out)
        ctx.meta = (Sk, chunk, causal, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        qs, k, v, qpos, m, l, out = ctx.saved_tensors
        Sk, chunk, causal, window = ctx.meta
        delta = (dout * out).sum(-1)                        # (B, KV, G, Sq)
        dqs = torch.zeros_like(qs)
        dk, dv = torch.zeros_like(k), torch.zeros_like(v)
        for c in range(k.shape[1] // chunk):
            sl = slice(c * chunk, (c + 1) * chunk)
            okb = _chunk_mask(qpos, c, chunk, Sk, causal, window)
            s = torch.where(okb, torch.einsum("bqhgd,bkhd->bhgqk", qs,
                                              k[:, sl]), _BIG_NEG)
            p = torch.where(okb, torch.exp(s - m[..., None]),
                            0.0) / l[..., None]
            dp = torch.einsum("bhgqd,bkhd->bhgqk", dout, v[:, sl])
            ds = p * (dp - delta[..., None])
            dqs += torch.einsum("bhgqk,bkhd->bqhgd", ds, k[:, sl])
            dk[:, sl] = torch.einsum("bhgqk,bqhgd->bkhd", ds, qs)
            dv[:, sl] = torch.einsum("bhgqk,bhgqd->bkhd", p, dout)
        return dqs, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_offset=0, window: Optional[int] = None,
                    chunk: int = 1024) -> torch.Tensor:
    """FP32 attention as the reference's ``flash_attention`` computes it:
    an online softmax over KV chunks of ``chunk`` keys, with the same order
    of operations (the ragged last chunk zero-padded and masked by ``kpos <
    Sk``; the running max ``m``, normalizer ``l`` and ``acc`` carried in
    f32; ``acc / max(l, 1e-20)``).  No score matrix wider than one chunk is
    formed, in the forward or the backward (``_FlashAttention``).
    ``q_offset`` is a scalar or a per-row (B,) vector of the queries' first
    positions.
    q: (B, Sq, KV, G, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, KV, G, hd)."""
    B, Sq, KV, G, hd = q.shape
    Sk = k.shape[1]
    chunk = min(chunk, Sk)
    pad = -(-Sk // chunk) * chunk - Sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qpos = (torch.as_tensor(q_offset, device=q.device).reshape(-1, 1)
            + torch.arange(Sq, device=q.device))                # (1|B, Sq)
    out = _FlashAttention.apply(q.to(torch.float32) * _scale(hd),
                                k.to(torch.float32), v.to(torch.float32),
                                qpos, Sk, chunk, causal, window)
    return out.permute(0, 3, 1, 2, 4)


def _decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      index, window: Optional[int]) -> torch.Tensor:
    """One query per row over the whole cache: a single masked FP32
    softmax, keys after ``index`` (a scalar or a per-row (B,) vector of the
    queries' positions) or outside the window masked out.
    q: (B, 1, KV, G, hd); k, v: (B, Smax, KV, hd) -> (B, 1, KV, G, hd)."""
    hd = q.shape[-1]
    Smax = k.shape[1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.to(torch.float32) * _scale(hd),
                     k.to(torch.float32))
    idx = torch.as_tensor(index, device=q.device).reshape(-1, 1)  # (1|B, 1)
    kpos = torch.arange(Smax, device=q.device)[None, :]
    ok = kpos <= idx
    if window is not None:
        ok = ok & (kpos > idx - window)
    s = torch.where(ok[:, None, None, None, :], s, _BIG_NEG)
    o = torch.einsum("bhgqk,bkhd->bhgqd", torch.softmax(s, dim=-1),
                     v.to(torch.float32))
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
    health.probe(sc.path, x, sc.leaf("wq").act_bits)
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
    elif S == 1 and kv_cache is not None:
        o = _decode_attention(q, k, v, idx, win)
    else:
        o = flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                            window=win)
    o = o.reshape(B, S, H * hd)
    out = int_ops.int_linear(o, p["wo"], None, key, sc.leaf("wo"))
    return out, new_cache


# =========================================================================
# Dense MLP (SwiGLU or GeLU)
# =========================================================================

def mlp_init(gen: torch.Generator, cfg: ArchConfig, device,
             lead: Tuple[int, ...] = (), d_ff: Optional[int] = None
             ) -> Params:
    D, F = cfg.d_model, d_ff or cfg.d_ff
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
    health.probe(sc.path, x, sc.leaf("wg" if "wg" in p else "w1").act_bits)
    if "wg" in p:
        g = int_ops.int_linear(x, p["wg"], None, key, sc.leaf("wg"))
        u = int_ops.int_linear(x, p["wu"], None, key, sc.leaf("wu"))
        h = int_ops.int_activation(g, sc.leaf("act"), "silu") * u
        return int_ops.int_linear(h, p["wd"], None, key, sc.leaf("wd"))
    h = int_ops.int_linear(x, p["w1"], p["b1"], key, sc.leaf("w1"))
    h = int_ops.int_activation(h, sc.leaf("act"), "gelu")
    return int_ops.int_linear(h, p["w2"], p["b2"], key, sc.leaf("w2"))


# =========================================================================
# Mixture of experts (top-k, capacity dispatch, optional always-on shared
# expert — qwen2-moe style)
# =========================================================================

def moe_init(gen: torch.Generator, cfg: ArchConfig, device,
             lead: Tuple[int, ...] = ()) -> Params:
    D, F, E = cfg.d_model, cfg.d_ff, cfg.moe_experts
    p = {
        "router": _init(gen, lead + (D, E), device),
        "wg_e": _init(gen, lead + (E, D, F), device),
        "wu_e": _init(gen, lead + (E, D, F), device),
        "wd_e": _init(gen, lead + (E, F, D), device),
    }
    if cfg.moe_shared_dff:
        p["shared"] = mlp_init(gen, cfg, device, lead,
                               d_ff=cfg.moe_shared_dff)
    return p


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row and their indices, the lower
    index first among equal values (``jax.lax.top_k``'s order; a stable
    descending sort, where ``torch.topk`` promises no order on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg: ArchConfig, tokens: int) -> int:
    """Rows per expert of the capacity dispatch: drop-free (``T·K``) for
    ``T·K <= 4096`` (decode, so decode == prefill), else ``capacity_factor
    · T·K / E`` rounded up to a multiple of 128."""
    tk = tokens * cfg.moe_topk
    if tk <= 4096:
        return tk
    c = int(cfg.moe_capacity_factor * tk / cfg.moe_experts) or 1
    return ((c + 127) // 128) * 128


def moe_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, qcfg: QuantLike,
              key) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out, aux_loss).  x: (B, S, D).

    Router: ``int_linear`` (D -> E), FP32 softmax, top-k with the gates
    renormalised, the Switch-style load-balancing loss over each token's
    first choice.  Dispatch: the reference's capacity dispatch with one
    group (one device): token-choice ``j`` of expert ``e`` takes row
    ``pos`` = the count of earlier choices of ``e``; choices past the
    capacity write a spill row, which is dropped (with duplicate writes
    there, whichever lands is never read).  The reference keeps one spill
    row per expert (``Cg + 1`` rows each); here one spill row follows all
    ``E·Cg`` rows, so the experts' (E, Cg, D) input is a view of the
    buffer, not a copy — the same rows either way.  Experts: the per-expert
    integer SwiGLU through ``int_batched_linear`` over the (E, Cg, D)
    stack — its per-expert scales span every row of an expert's slice,
    empty rows included, as in the reference.  Combine: each choice
    gathers row ``min(pos, Cg - 1)`` of its expert, times ``keep · gate``.
    The shared expert's MLP is added without a gate, as in the
    reference."""
    B, S, D = x.shape
    E, K = cfg.moe_experts, cfg.moe_topk
    T = B * S
    sc = ensure_scope(qcfg)
    health.probe(sc.path, x, sc.leaf("router").act_bits)
    xf = x.reshape(T, D)
    logits = int_ops.int_linear(xf, p["router"], None, key, sc.leaf("router"))
    probs = int_ops.int_softmax(logits.to(torch.float32), sc.leaf("router"))
    gate, sel = top_k(probs, K)                                  # (T, K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    density = torch.mean(
        torch.nn.functional.one_hot(sel[:, 0], E).to(torch.float32), dim=0)
    aux = E * torch.sum(density * torch.mean(probs, dim=0))

    Cg = capacity(cfg, T)
    sel_f, gate_f = sel.reshape(T * K), gate.reshape(T * K)
    onehot = torch.nn.functional.one_hot(sel_f, E)               # (TK, E)
    pos_all = torch.cumsum(onehot, dim=0) - onehot
    pos = torch.gather(pos_all, 1, sel_f[:, None])[:, 0]
    keep = pos < Cg
    spill = E * Cg
    flat_idx = torch.where(keep, sel_f * Cg + pos, torch.full_like(pos, spill))
    upd = xf[torch.arange(T * K, device=x.device) // K]          # (TK, D)
    buf = torch.zeros((spill + 1, D), dtype=x.dtype, device=x.device)
    buf = buf.index_put((flat_idx,), upd)
    ex_in = buf[:spill].reshape(E, Cg, D)

    g = int_ops.int_batched_linear(ex_in, p["wg_e"], key, sc.leaf("wg_e"))
    u = int_ops.int_batched_linear(ex_in, p["wu_e"], key, sc.leaf("wu_e"))
    h = int_ops.int_activation(g, sc.leaf("act"), "silu") * u
    ex_out = int_ops.int_batched_linear(h, p["wd_e"], key, sc.leaf("wd_e"))

    take = sel_f * Cg + torch.clamp(pos, max=Cg - 1)
    y = ex_out.reshape(E * Cg, D)[take]                          # (TK, D)
    y = y * (keep[:, None] * gate_f[:, None])
    y = y.reshape(T, K, D).sum(dim=1)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], xf, cfg, sc.child("shared"), key)
    return y.reshape(B, S, D), aux


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
    sc = ensure_scope(qcfg)
    leaf = sc.cfg()                      # the scope path IS the norm's path
    health.probe(sc.path, x, leaf.act_bits)
    if "b" in p:
        return int_ops.int_layernorm(x, p["g"], p["b"], key, leaf)
    return int_ops.int_rmsnorm(x, p["g"], key, leaf)
