"""Decoder-only language model, dense and MoE families: init, the training
loss, the full-prompt prefill, KV cache, chunked prefill and decode.

Counterpart of the dense and MoE paths of ``repro/models/lm.py``.
Parameters are a nested dict of tensors with the layer stack stacked on a
leading ``(L, ...)`` axis, as in the reference's ``lm_init``, so the
reference's
params carry across one to one (``repro_torch.convert``).  The reference's
``lax.scan`` over the stack is a Python loop here.  Its remat
(``utils.checkpoint`` around each layer of the training stack, full
recompute) is ``torch.utils.checkpoint`` around each layer: the backward
keeps each layer's input and recomputes the layer's residuals (the
quantized planes the integer layers save) when it reaches it.  The
recompute replays the forward's stochastic-rounding noise from a copy of
the generator (``_remat_layer``).  Its sharding constraints
(``sharding.constrain*``) and ``health.probe`` calls are identities on one
device with probes suspended, and are left out.

A MoE block's ``moe`` sublayer (``blocks.moe_apply``) takes the MLP's
place; its load-balancing loss is summed over the layers and ``lm_loss``
adds ``0.01 · aux / n_layers``, as the reference does.  The SSM, hybrid
and VLM families are not ported yet.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.core import int_ops
from repro_torch.core.qpolicy import QuantLike, ensure_scope, layer_groups
from repro_torch.models import blocks
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]


def _require_ported(cfg: ArchConfig) -> None:
    if (cfg.family not in ("dense", "moe")
            or bool(cfg.moe_experts) != (cfg.family == "moe")
            or cfg.vlm_prefix):
        raise NotImplementedError(
            f"{cfg.name}: only the dense and MoE families are ported (got "
            f"family={cfg.family!r})")


def _block_leaves(cfg: ArchConfig) -> list:
    """Every integer-layer leaf path inside one block (the probe set
    ``layer_groups`` uses to prove two layers resolve equal)."""
    leaves = ["ln1", "ln2"] + [
        f"attn.{n}" for n in ("wq", "wk", "wv", "wo", "qk", "pv")]
    if cfg.moe_experts:
        leaves += ["moe.router", "moe.wg_e", "moe.wu_e", "moe.wd_e",
                   "moe.act"]
        if cfg.moe_shared_dff:
            leaves += blocks.mlp_leaves(cfg, "moe.shared")
    else:
        leaves += blocks.mlp_leaves(cfg)
    return leaves


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
    _require_ported(cfg)
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
    }
    if cfg.moe_experts:
        params["blocks"]["moe"] = blocks.moe_init(gen, cfg, device, L)
    else:
        params["blocks"]["mlp"] = blocks.mlp_init(gen, cfg, device, L)
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
    aux = torch.zeros((), device=x.device)
    if "moe" in bp:
        h, aux = blocks.moe_apply(bp["moe"], h, cfg, sc.child("moe"), key)
    else:
        h = blocks.mlp_apply(bp["mlp"], h, cfg, sc.child("mlp"), key)
    return x + h, aux, new_cache


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


def _replay_key(key, state):
    """The key a layer's recompute draws from: a fresh generator on the
    key's device set to ``state``, the key's state before the layer's
    forward; the key itself (None) when there is no state."""
    if state is None:
        return key
    gen = torch.Generator(device=key.device)
    gen.set_state(state)
    return gen


def _remat_layer(bp: Params, x: torch.Tensor, cfg: ArchConfig,
                 bsc: QuantLike, key):
    """``_attn_block`` under ``torch.utils.checkpoint`` (non-reentrant):
    the backward recomputes the layer from its input.

    The layers draw stochastic-rounding noise from ``key`` — the
    activations' in the forward (``stochastic_fwd``), the gradients' in the
    backward (each autograd Function keeps ``key`` for that) — and
    ``torch.utils.checkpoint`` restores only the default generators.  A
    recompute that drew from ``key`` would take other activation noise
    than the forward did and shift every later gradient draw.  So the
    recompute draws from a copy of ``key`` set to its state before the
    layer: the same noise, the same saved tensors (checkpoint checks their
    count, shapes and dtypes), and ``key`` left where the step without
    remat leaves it.  A callable key hands in noise that cannot be
    replayed, so its layers run without remat."""
    if key is not None and not isinstance(key, torch.Generator):
        return _attn_block(bp, x, cfg, bsc, key)[:2]
    state = key.get_state() if key is not None else None
    calls = []

    def run(x):
        k = key if not calls else _replay_key(key, state)
        calls.append(1)
        return _attn_block(bp, x, cfg, bsc, k)[:2]
    # the layers draw from ``key`` only, never from the default generators
    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False,
                                             preserve_rng_state=False)


def _backbone_train(params: Params, x: torch.Tensor, cfg: ArchConfig,
                    qcfg: QuantLike, key, *,
                    remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """All layers, no cache (training, and ``lm_prefill``): a Python loop
    over the stack, each run of identically resolved layers under its
    scope.  ``remat``: each layer under ``_remat_layer`` while autograd
    records (the reference's per-layer remat; off only to compare the
    two).  Returns (x, the MoE aux losses summed over the layers)."""
    sc = ensure_scope(qcfg)
    layers = blocks.unstack(params["blocks"], cfg.n_layers)
    remat = remat and torch.is_grad_enabled()
    aux = torch.zeros((), device=x.device)
    for start, stop, bsc in layer_groups(sc, cfg.n_layers,
                                         _block_leaves(cfg)):
        for i in range(start, stop):
            if remat:
                x, a = _remat_layer(layers[i], x, cfg, bsc, key)
            else:
                x, a, _ = _attn_block(layers[i], x, cfg, bsc, key)
            aux = aux + a
    return x, aux


def lm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            qcfg: QuantLike, key) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token cross entropy.  batch: tokens (B, S) and labels (B, S)
    integer tensors (label -1: masked).  Returns ``(loss, {"ce", "aux"})``:
    for a MoE config the loss includes ``0.01 · aux / n_layers`` and ``aux``
    is the layers' summed balance loss (0 for the dense family); ``ce`` is
    the returned loss, as the reference reports it."""
    _require_ported(cfg)
    x = _embed(params, batch["tokens"], cfg, qcfg, key)
    x, aux = _backbone_train(params, x, cfg, qcfg, key)
    logits = _logits(params, x, cfg, qcfg, key)
    labels = batch["labels"]
    valid = labels >= 0
    lab = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, lab[..., None])[..., 0]
    n = torch.clamp(valid.sum(), min=1).to(torch.float32)
    loss = -torch.sum(ll * valid) / n
    if cfg.moe_experts:
        loss = loss + 0.01 * aux / cfg.n_layers
    return loss, {"ce": loss.detach(), "aux": aux.detach()}


def lm_prefill(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
               qcfg: QuantLike) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass over the full prompt, no cache and no key (round to
    nearest): the training backbone, whose FP32 attention is the chunked
    ``flash_attention``.  Returns (last-position logits (B, 1, V), the
    final hidden states (B, S, D))."""
    _require_ported(cfg)
    x = _embed(params, tokens, cfg, qcfg, None)
    x, _ = _backbone_train(params, x, cfg, qcfg, None)
    logits = _logits(params, x[:, -1:], cfg, qcfg, None)
    return logits, x


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.float32, device="cuda") -> Params:
    """KV cache: k/v (L, B, max_seq, KV, hd) and a per-row (B,) int32
    ``index`` (continuous batching admits slots at different times)."""
    _require_ported(cfg)
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
    _require_ported(cfg)
    key = None                                   # no stochastic rounding
    index = cache["index"]
    sc = ensure_scope(qcfg)
    x = _embed(params, tokens, cfg, sc, key)
    layers = blocks.unstack(params["blocks"], cfg.n_layers)
    groups = layer_groups(sc, cfg.n_layers, _block_leaves(cfg))
    for start, stop, bsc in groups:
        for i in range(start, stop):
            x, _, _ = _attn_block(layers[i], x, cfg, bsc, key,
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
