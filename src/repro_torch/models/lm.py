"""Decoder-only language model, dense family: init, the training loss,
KV cache, chunked prefill and decode.

Counterpart of the dense path of ``repro/models/lm.py``.  Parameters are a
nested dict of tensors with the layer stack stacked on a leading
``(L, ...)`` axis, as in the reference's ``lm_init``, so the reference's
params carry across one to one (``repro_torch.convert``).  The reference's
``lax.scan`` over the stack is a Python loop here, and its remat
(``utils.checkpoint`` around each layer of the training stack) is left
out: the backward keeps every layer's residuals (the quantized planes the
integer layers save), trading device memory for no recompute.  Its
sharding constraints (``sharding.constrain*``) and ``health.probe`` calls
are identities on one device with probes suspended, and are left out.

MoE, SSM, hybrid and VLM families are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.core import int_ops
from repro_torch.core.qpolicy import QuantLike, ensure_scope, layer_groups
from repro_torch.models import blocks
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]


def _require_dense(cfg: ArchConfig) -> None:
    if cfg.family != "dense" or cfg.moe_experts or cfg.vlm_prefix:
        raise NotImplementedError(
            f"{cfg.name}: only the dense family is ported (got "
            f"family={cfg.family!r})")


def _block_leaves(cfg: ArchConfig) -> list:
    """Every integer-layer leaf path inside one dense block."""
    return (["ln1", "ln2"]
            + [f"attn.{n}" for n in ("wq", "wk", "wv", "wo", "qk", "pv")]
            + blocks.mlp_leaves(cfg))


def padded_vocab(cfg: ArchConfig) -> int:
    """Vocab padded to a multiple of 256 (padded rows are never valid)."""
    return ((cfg.vocab + 255) // 256) * 256


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; asking for CUDA without a card
    raises instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' explicitly")
    return device


def lm_init(gen: torch.Generator, cfg: ArchConfig, device="cuda") -> Params:
    """Random params (normal · 0.02 matrices, zero biases, unit norms) drawn
    from ``gen``, a generator on ``device``."""
    _require_dense(cfg)
    device = resolve_device(device)
    L = (cfg.n_layers,)
    params: Params = {
        "embed": blocks._init(gen, (padded_vocab(cfg), cfg.d_model), device),
        "final_norm": blocks.norm_init(cfg, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = blocks._init(
            gen, (cfg.d_model, padded_vocab(cfg)), device)
    params["blocks"] = {
        "ln1": blocks.norm_init(cfg, device, L),
        "attn": blocks.attention_init(gen, cfg, device, L),
        "ln2": blocks.norm_init(cfg, device, L),
        "mlp": blocks.mlp_init(gen, cfg, device, L),
    }
    return params


def _attn_block(bp: Params, x: torch.Tensor, cfg: ArchConfig,
                qcfg: QuantLike, key, *, cache=None, cache_index=0):
    sc = ensure_scope(qcfg)
    h = blocks.norm_apply(bp["ln1"], x, cfg, sc.child("ln1"), key)
    h, new_cache = blocks.attention_apply(
        bp["attn"], h, cfg, sc.child("attn"), key,
        kv_cache=cache, cache_index=cache_index)
    x = x + h
    h = blocks.norm_apply(bp["ln2"], x, cfg, sc.child("ln2"), key)
    h = blocks.mlp_apply(bp["mlp"], h, cfg, sc.child("mlp"), key)
    return x + h, new_cache


def _embed(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
           qcfg: QuantLike, key) -> torch.Tensor:
    sc = ensure_scope(qcfg)
    return int_ops.int_embedding(params["embed"], tokens, key,
                                 sc.leaf("embed"))


def _logits(params: Params, x: torch.Tensor, cfg: ArchConfig,
            qcfg: QuantLike, key) -> torch.Tensor:
    sc = ensure_scope(qcfg)
    x = blocks.norm_apply(params["final_norm"], x, cfg,
                          sc.child("final_norm"), key)
    tied = cfg.tie_embeddings
    head = params["embed"] if tied else params["lm_head"]
    # the head resolves under "lm_head" whether or not it is tied; a tied
    # head is the (V, D) table, read as its transpose
    return int_ops.int_linear(x, head, None, key, sc.leaf("lm_head"),
                              transposed_w=tied)


def _backbone_train(params: Params, x: torch.Tensor, cfg: ArchConfig,
                    qcfg: QuantLike, key) -> torch.Tensor:
    """All layers, no cache (training): a Python loop over the stack, each
    run of identically resolved layers under its scope."""
    sc = ensure_scope(qcfg)
    layers = blocks.unstack(params["blocks"], cfg.n_layers)
    for start, stop, bsc in layer_groups(sc, cfg.n_layers,
                                         _block_leaves(cfg)):
        for i in range(start, stop):
            x, _ = _attn_block(layers[i], x, cfg, bsc, key)
    return x


def lm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            qcfg: QuantLike, key) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token cross entropy.  batch: tokens (B, S) and labels (B, S)
    integer tensors (label -1: masked).  Returns ``(loss, {"ce", "aux"})``;
    ``aux`` is 0 (the dense family has no MoE balance loss)."""
    _require_dense(cfg)
    x = _embed(params, batch["tokens"], cfg, qcfg, key)
    x = _backbone_train(params, x, cfg, qcfg, key)
    logits = _logits(params, x, cfg, qcfg, key)
    labels = batch["labels"]
    valid = labels >= 0
    lab = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, lab[..., None])[..., 0]
    n = torch.clamp(valid.sum(), min=1).to(torch.float32)
    loss = -torch.sum(ll * valid) / n
    return loss, {"ce": loss.detach(),
                  "aux": torch.zeros((), device=loss.device)}


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.float32, device="cuda") -> Params:
    """KV cache: k/v (L, B, max_seq, KV, hd) and a per-row (B,) int32
    ``index`` (continuous batching admits slots at different times)."""
    _require_dense(cfg)
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "index": torch.zeros((batch,), dtype=torch.int32, device=device)}


def lm_prefill_cache(params: Params, tokens: torch.Tensor, cache: Params,
                     cfg: ArchConfig,
                     qcfg: QuantLike) -> Tuple[torch.Tensor, Params]:
    """Chunked prefill through the decode cache.

    tokens: (B, S) int — written into the cache at ``cache['index'] ..
    index+S`` with per-row ``q_offset = index`` (S == 1 is plain decode).
    The cache's k/v tensors are updated in place; returns (last-position
    logits (B, 1, V), cache with the advanced index).
    """
    _require_dense(cfg)
    key = None                                   # no stochastic rounding
    index = cache["index"]
    sc = ensure_scope(qcfg)
    x = _embed(params, tokens, cfg, sc, key)
    layers = blocks.unstack(params["blocks"], cfg.n_layers)
    groups = layer_groups(sc, cfg.n_layers, _block_leaves(cfg))
    for start, stop, bsc in groups:
        for i in range(start, stop):
            x, _ = _attn_block(layers[i], x, cfg, bsc, key,
                               cache=(cache["k"][i], cache["v"][i]),
                               cache_index=index)
    logits = _logits(params, x[:, -1:], cfg, sc, key)
    return logits, {"k": cache["k"], "v": cache["v"],
                    "index": index + tokens.shape[1]}


def lm_decode_step(params: Params, token: torch.Tensor, cache: Params,
                   cfg: ArchConfig,
                   qcfg: QuantLike) -> Tuple[torch.Tensor, Params]:
    """token: (B, 1).  Returns (logits (B, 1, V), cache)."""
    return lm_prefill_cache(params, token, cache, cfg, qcfg)
