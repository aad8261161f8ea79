"""Whisper-style encoder-decoder (the audio frontend is a stub: the encoder
takes precomputed frame embeddings).

Counterpart of ``repro/models/encdec.py``.  Encoder: bidirectional
self-attention, layer norm, the GELU MLP, over the frames plus a
sinusoid table.  Decoder: causal self-attention, cross-attention over the
encoder's output, the MLP, over the token embeddings plus the same
table; the head is the embedding table's transpose (``int_linear`` with
``transposed_w``, under the ``lm_head`` leaf), tied whatever the config
says.  Training computes each decoder layer's cross K/V inside the layer;
decode precomputes them once (``encdec_precompute_cross``) and each step
runs the self-attention over a KV cache, updated in place.

Parameters: ``embed``, the stacked ``enc_blocks`` and ``dec_blocks``
(``(L, ...)`` leaves, as the reference's ``vmap``-ed init), ``enc_ln`` and
``final_norm``, so ``convert.params_from_jax`` carries the reference's
tree one to one.  Scope paths are the reference's: ``embed``,
``enc.{i}.*``, ``enc_ln``, ``dec.{i}.*`` (``attn.*``, ``xattn.*``,
``ln_x``), ``final_norm``, ``lm_head``; each run of identically resolved
layers runs under its first layer's scope.  Both training stacks run each
layer under ``lm._remat`` (the reference's ``utils.checkpoint``; the
recompute replays the forward's noise), and every stack runs with probes
suspended, as the reference's scans do; ``enc_ln`` and ``final_norm``
probe.  Each layer gathers its own leaves of a sharded stack
(``sharding.gather_layer``, as in ``models/lm.py``), the cross K/V's
projections with them.

Under a training step that splits its products over the model group
(``dfx.model``) both stacks' layers split as ``models/blocks.py`` says
(q / k / v and ``w1`` / ``b1`` column-parallel, ``wo`` and ``w2``
row-parallel with ``b2`` added whole after the sum, the layer norms
whole); the cross K/V are column-parallel over the encoder's output,
entered through ``copy_to_model`` once a step before the decoder loop,
so one all-reduce sums the 32 layers' accumulated dX partials; the
embedding, the tied head and the cross entropy are vocab-parallel, as
``models/lm.py``'s.  By default each stream whose length the group divides
is also sequence-sharded (``int_ops.sequence_split``: the encoder's frames
and the decoder's tokens apart): its norms and residual adds run on the
rank's rows (the frames' taken after the sinusoid rows are added, the
decoder's embedding reduce-scattered before its rows' sinusoids are), and
the encoder's output after ``enc_ln`` is gathered once a step before the
decoder loop, its backward one reduce-scatter of the cross K/V's
accumulated input gradient (with the kv replication, the rank's rows of
the whole gradient every rank computes).

Decode runs under a serving mesh too (``sharding.serving``): ``encode``
and ``encdec_precompute_cross`` give each rank the cross K/V of its kv
heads (column-parallel over the whole encoder output; the reference keeps
them whole over ``model``), ``encdec_init_cache(..., mesh=)`` the rank's
self cache, and ``encdec_decode_step`` the rank's rows and vocabulary
columns of the logits.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import sharding
from repro_torch.core import dfx, health, int_ops
from repro_torch.core.qpolicy import QuantLike, ensure_scope, layer_groups
from repro_torch.models import blocks, lm
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]

_ATTN = ["attn." + n for n in ("wq", "wk", "wv", "wo", "qk", "pv")]
_XATTN = ["xattn." + n for n in ("wq", "wk", "wv", "wo", "qk", "pv")]


def _enc_leaves(cfg: ArchConfig) -> list:
    return ["ln1", "ln2"] + _ATTN + blocks.mlp_leaves(cfg)


def _dec_leaves(cfg: ArchConfig) -> list:
    return _enc_leaves(cfg) + ["ln_x"] + _XATTN


def _sinusoids(length: int, channels: int, start=0,
               device=None) -> torch.Tensor:
    """Rows ``start .. start + length`` of the reference's sinusoid table
    (``[sin(t · inv), cos(t · inv)]``, ``inv = exp(-i · log(10000) / (C/2 -
    1))``), each row computed from its own position with the reference's
    f32 operations: no row before ``start`` is formed.  ``start`` is an
    int or a 0-d tensor (a decode cache's index)."""
    half = channels // 2
    # the f32 step, exact as a Python float: no copy to the device
    step = float(torch.log(torch.tensor(10000.0)) / (half - 1))
    inv = torch.exp(-torch.arange(half, dtype=torch.float32, device=device)
                    * step)
    t = (torch.as_tensor(start, device=device)
         + torch.arange(length, device=device)).to(torch.float32)
    ang = t[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_block_init(gen, cfg: ArchConfig, device, lead) -> Params:
    return {"ln1": blocks.norm_init(cfg, device, lead),
            "attn": blocks.attention_init(gen, cfg, device, lead),
            "ln2": blocks.norm_init(cfg, device, lead),
            "mlp": blocks.mlp_init(gen, cfg, device, lead)}


def _dec_block_init(gen, cfg: ArchConfig, device, lead) -> Params:
    return {"ln1": blocks.norm_init(cfg, device, lead),
            "attn": blocks.attention_init(gen, cfg, device, lead),
            "ln_x": blocks.norm_init(cfg, device, lead),
            "xattn": blocks.attention_init(gen, cfg, device, lead),
            "ln2": blocks.norm_init(cfg, device, lead),
            "mlp": blocks.mlp_init(gen, cfg, device, lead)}


def encdec_init(gen: torch.Generator, cfg: ArchConfig,
                device="cuda") -> Params:
    """Random params (normal · 0.02 matrices, zero biases, unit norms) drawn
    from ``gen``, a generator on ``device``."""
    device = lm.resolve_device(device)
    return {
        "embed": blocks._init(gen, (lm.padded_vocab(cfg), cfg.d_model),
                              device),
        "enc_blocks": _enc_block_init(gen, cfg, device, (cfg.n_enc_layers,)),
        "dec_blocks": _dec_block_init(gen, cfg, device, (cfg.n_layers,)),
        "enc_ln": blocks.norm_init(cfg, device),
        "final_norm": blocks.norm_init(cfg, device),
    }


def _remat_call(fn, x: torch.Tensor, key, remat: bool) -> torch.Tensor:
    """``fn(x, key)`` — one layer — under ``lm._remat`` when ``remat``."""
    return lm._remat(fn, x, key) if remat else fn(x, key)


def _enc_layer(bp: Params, x: torch.Tensor, cfg: ArchConfig, bsc,
               key, seq: bool = False) -> torch.Tensor:
    bp = sharding.gather_layer(bp)
    h = blocks.norm_apply(bp["ln1"], x, cfg, bsc.child("ln1"), key, seq=seq)
    h, _ = blocks.attention_apply(bp["attn"], h, cfg, bsc.child("attn"), key,
                                  causal=False, use_rope=False, seq=seq)
    x = x + h
    h = blocks.norm_apply(bp["ln2"], x, cfg, bsc.child("ln2"), key, seq=seq)
    return x + blocks.mlp_apply(bp["mlp"], h, cfg, bsc.child("mlp"), key,
                                seq=seq)


def encode(params: Params, frames: torch.Tensor, cfg: ArchConfig,
           qcfg: QuantLike, key, *, seq: bool = False) -> torch.Tensor:
    """frames: (B, T, D) precomputed frame embeddings (the conv frontend's
    stub) -> the encoder's output (B, T, D), after ``enc_ln``; with
    ``seq`` the rank's rows of it (B, T / M, D)."""
    sc = ensure_scope(qcfg)
    x = frames + _sinusoids(frames.shape[1], cfg.d_model,
                            device=frames.device)[None]
    if seq:
        x = int_ops.scatter_to_sequence(x)
    Le = cfg.n_enc_layers
    layers = blocks.unstack(params["enc_blocks"], Le)
    remat = torch.is_grad_enabled()
    with health.suspend():
        for start, stop, bsc in layer_groups(sc, Le, _enc_leaves(cfg),
                                             stack="enc"):
            for i in range(start, stop):
                x = _remat_call(
                    lambda x, k, bp=layers[i], bsc=bsc: _enc_layer(
                        bp, x, cfg, bsc, k, seq), x, key, remat)
    return blocks.norm_apply(params["enc_ln"], x, cfg, sc.child("enc_ln"),
                             key, seq=seq)


def _cross_kv(bp: Params, enc: torch.Tensor, cfg: ArchConfig,
              qcfg: QuantLike, key) -> Tuple[torch.Tensor, torch.Tensor]:
    """A decoder layer's cross-attention keys and values from the encoder's
    output: each (B, T, KV, hd).  Under a model group the rank's kv heads,
    column-parallel over ``enc`` (which the caller entered through
    ``copy_to_model`` once for every layer), or with the kv replication
    all of them from the plain ``enc`` and the one its query heads read."""
    B, T, _ = enc.shape
    sc = ensure_scope(qcfg)
    kv_head = blocks.replicated_kv_head(cfg)
    col = "col" if dfx.model is not None and kv_head is None else None
    k = int_ops.int_linear(enc, bp["wk"], bp.get("bk"), key, sc.leaf("wk"),
                           split=col)
    v = int_ops.int_linear(enc, bp["wv"], bp.get("bv"), key, sc.leaf("wv"),
                           split=col)
    k, v = (t.reshape(B, T, -1, cfg.head_dim) for t in (k, v))
    if kv_head is not None:
        k, v = (int_ops.model_head(t, kv_head) for t in (k, v))
    return k, v


def _dec_layer(bp: Params, x: torch.Tensor, enc, cfg: ArchConfig, bsc, key,
               *, cache=None, cross=None, index=0,
               seq: bool = False) -> torch.Tensor:
    """One decoder layer: causal self-attention (over ``cache`` when given,
    updated in place), cross-attention over ``cross`` (or over the cross
    K/V computed here from ``enc``, whole), the MLP.  ``seq``: ``x`` and
    the output are the rank's rows of the sequence."""
    bp = sharding.gather_layer(bp)
    h = blocks.norm_apply(bp["ln1"], x, cfg, bsc.child("ln1"), key, seq=seq)
    h, _ = blocks.attention_apply(bp["attn"], h, cfg, bsc.child("attn"), key,
                                  kv_cache=cache, cache_index=index,
                                  use_rope=False, seq=seq)
    x = x + h
    h = blocks.norm_apply(bp["ln_x"], x, cfg, bsc.child("ln_x"), key,
                          seq=seq)
    if cross is None:
        cross = _cross_kv(bp["xattn"], enc, cfg, bsc.child("xattn"), key)
    h, _ = blocks.attention_apply(bp["xattn"], h, cfg, bsc.child("xattn"),
                                  key, causal=False, kv_override=cross,
                                  use_rope=False, seq=seq)
    x = x + h
    h = blocks.norm_apply(bp["ln2"], x, cfg, bsc.child("ln2"), key, seq=seq)
    return x + blocks.mlp_apply(bp["mlp"], h, cfg, bsc.child("mlp"), key,
                                seq=seq)


def _decoder(params: Params, x: torch.Tensor, enc, cfg: ArchConfig,
             qcfg: QuantLike, key, *, self_cache=None, index=0,
             seq: bool = False, enc_seq: bool = False) -> torch.Tensor:
    """The decoder stack.  Training (``self_cache`` None): each layer's
    cross K/V from ``enc``, each layer under remat while autograd records;
    ``seq`` / ``enc_seq``: ``x`` / ``enc`` are the rank's rows of their
    sequences.  Decode: ``self_cache`` = (k, v, xk, xv), the (L, B, Smax,
    KV, hd) self caches (written in place at ``index``) and the (L, B, T,
    KV, hd) precomputed cross K/V."""
    sc = ensure_scope(qcfg)
    L = cfg.n_layers
    layers = blocks.unstack(params["dec_blocks"], L)
    groups = layer_groups(sc, L, _dec_leaves(cfg), stack="dec")
    with health.suspend():
        if self_cache is None:
            remat = torch.is_grad_enabled()
            if dfx.model is not None:
                # the cross K/V's input, entered (or gathered) once a step:
                # one SUM of the layers' accumulated dX partials, or with
                # the kv replication the whole gradient every rank computes
                split_kv = blocks.replicated_kv_head(cfg) is None
                enc = int_ops.into_split(enc, enc_seq)[0 if split_kv else 1]
            for start, stop, bsc in groups:
                for i in range(start, stop):
                    x = _remat_call(
                        lambda x, k, bp=layers[i], bsc=bsc: _dec_layer(
                            bp, x, enc, cfg, bsc, k, seq=seq), x, key,
                        remat)
            return x
        ck, cv, xk, xv = self_cache
        for start, stop, bsc in groups:
            for i in range(start, stop):
                x = _dec_layer(layers[i], x, None, cfg, bsc, key,
                               cache=(ck[i], cv[i]), cross=(xk[i], xv[i]),
                               index=index)
    return x


def _dec_embed(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
               qcfg: QuantLike, key, index=0,
               seq: bool = False) -> torch.Tensor:
    """The tokens' embeddings plus the sinusoid rows of their positions
    ``index .. index + S`` (the start clamped into the table, as the
    reference's ``dynamic_slice`` clamps it); ``seq``: the rank's rows."""
    sc = ensure_scope(qcfg)
    table, tp = params["embed"], dfx.model
    x = int_ops.int_embedding(
        table, tokens, key, sc.leaf("embed"),
        vocab_start=None if tp is None else tp.index * table.shape[0],
        seq=seq)
    S = tokens.shape[1]
    start = torch.as_tensor(index, device=x.device).clamp(
        0, cfg.max_position_embeddings - S)
    if seq:
        start = start + tp.index * x.shape[1]
    return x + _sinusoids(x.shape[1], cfg.d_model, start,
                          device=x.device)[None]


def _head(params: Params, x: torch.Tensor, cfg: ArchConfig,
          qcfg: QuantLike, key, seq: bool = False) -> torch.Tensor:
    """``final_norm``, then the tied head: the (V, D) table read as its
    transpose under the ``lm_head`` leaf.  ``seq``: ``x`` is the rank's
    rows of the sequence (``lm._logits``)."""
    sc = ensure_scope(qcfg)
    x = blocks.norm_apply(params["final_norm"], x, cfg,
                          sc.child("final_norm"), key, seq=seq)
    split = None
    if dfx.model is not None:
        # the rank's vocabulary columns: column-parallel over V
        x, split = int_ops.into_split(x, seq)[0], "col"
    return int_ops.int_linear(x, params["embed"], None, key,
                              sc.leaf("lm_head"), transposed_w=True,
                              split=split)


def encdec_loss(params: Params, batch: Dict[str, torch.Tensor],
                cfg: ArchConfig, qcfg: QuantLike,
                key) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token cross entropy over the padded vocabulary.  batch: frames
    (B, T, D) f32, tokens (B, S) and labels (B, S) integer tensors (label
    < 0: masked).  Returns ``(loss, {"ce": loss})``."""
    frames, tokens = batch["frames"], batch["tokens"]
    enc_seq = int_ops.sequence_split(frames.shape[1])
    seq = int_ops.sequence_split(tokens.shape[1])
    enc = encode(params, frames, cfg, qcfg, key, seq=enc_seq)
    x = _dec_embed(params, tokens, cfg, qcfg, key, seq=seq)
    x = _decoder(params, x, enc, cfg, qcfg, key, seq=seq, enc_seq=enc_seq)
    ce = lm.token_ce if dfx.model is None else lm.token_ce_vocab_parallel
    loss = ce(_head(params, x, cfg, qcfg, key, seq=seq), batch["labels"])
    return loss, {"ce": loss.detach()}


def encdec_init_cache(cfg: ArchConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, device="cuda",
                      mesh=None) -> Params:
    """The decoder's self-attention cache: k / v (L, B, max_seq, KV, hd) of
    ``dtype`` (the reference's bfloat16 by default) and a scalar int32
    ``index``; with ``mesh`` the rank's block of each
    (``sharding.cache_pspecs``)."""
    device = lm.resolve_device(device)
    if mesh is not None:
        return sharding.cache_zeros(encdec_init_cache(
            cfg, batch, max_seq, dtype, "meta"), mesh, cfg, device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": torch.zeros((), dtype=torch.int32, device=device)}


def encdec_precompute_cross(params: Params, enc: torch.Tensor,
                            cfg: ArchConfig, qcfg: QuantLike
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross-attention K/V from the encoder's output,
    computed once before decoding (no key: rounding to nearest), so a
    decode step projects only its own token.  Returns (xk, xv), each (L,
    B, T, KV, hd) f32; under a model group the rank's kv heads (or the one
    its query heads read)."""
    sc = ensure_scope(qcfg)
    L = cfg.n_layers
    layers = blocks.unstack(params["dec_blocks"], L)
    xk = xv = None
    for start, stop, bsc in layer_groups(sc, L, ["xattn.wk", "xattn.wv"],
                                         stack="dec"):
        for i in range(start, stop):
            bp = sharding.gather_layer(layers[i]["xattn"])
            k, v = _cross_kv(bp, enc, cfg, bsc.child("xattn"), None)
            if xk is None:
                xk = torch.empty((L,) + tuple(k.shape), dtype=torch.float32,
                                 device=enc.device)
                xv = torch.empty_like(xk)
            xk[i], xv[i] = k, v
    return xk, xv


def encdec_decode_step(params: Params, token: torch.Tensor, cache: Params,
                       cross_kv: Tuple[torch.Tensor, torch.Tensor],
                       cfg: ArchConfig, qcfg: QuantLike,
                       ) -> Tuple[torch.Tensor, Params]:
    """One decoder token per row, cross-attending over the precomputed
    cross K/V.  token: (B, 1).  Returns (logits (B, 1, V), cache); the
    cache's k / v are updated in place and its index advanced."""
    index = cache["index"]
    xk, xv = cross_kv
    x = _dec_embed(params, token, cfg, qcfg, None, index=index)
    x = _decoder(params, x, None, cfg, qcfg, None,
                 self_cache=(cache["k"], cache["v"], xk, xv), index=index)
    logits = _head(params, x, cfg, qcfg, None)
    return logits, {"k": cache["k"], "v": cache["v"], "index": index + 1}

