"""The paper's own models: a BERT-style encoder with a classification or
span head, and the ViT classifier.

Counterpart of ``repro/models/paper_models.py``.  Every linear, layer-norm,
embedding and patch embedding goes through the integer layers of
``core.int_ops``; softmax, GELU and the pooler's tanh
are the paper's kept FP32 ops (the iapprox integer forms under
``kept_ops="integer"``).  Parameters are a nested dict of tensors
with the layer stack on a leading ``(L, ...)`` axis, as in the reference,
so its params carry across one to one (``repro_torch.convert``).  The
reference's ``lax.scan`` over the stack (under activation recompute) is a
Python loop here, without recompute.

Quantization scope paths, as in the reference: ``embed``, ``type_embed``,
``embed_ln``, ``blocks.{i}.{ln1, attn.*, ln2, mlp.{w1,w2,act}}``,
``pooler`` (+ ``pooler.act``), ``head``, ``span_head``; ViT:
``patch_embed``, ``blocks.{i}.*``, ``final_ln``, ``head``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core import int_ops
from repro_torch.core.qpolicy import QuantLike, ensure_scope, layer_groups
from repro_torch.models import blocks
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import resolve_device

Params = Dict[str, Any]

_ENC_BLOCK_LEAVES = (["ln1", "ln2"]
                     + ["attn." + n
                        for n in ("wq", "wk", "wv", "wo", "qk", "pv")]
                     + ["mlp.w1", "mlp.w2", "mlp.act"])


def bert_config(n_layers=12, d_model=768, n_heads=12, d_ff=3072,
                vocab=30522, name="bert-base") -> ArchConfig:
    return ArchConfig(name=name, family="encoder", n_layers=n_layers,
                      d_model=d_model, n_heads=n_heads, n_kv_heads=n_heads,
                      d_ff=d_ff, vocab=vocab, norm="layernorm", act="gelu",
                      max_position_embeddings=512)


def vit_config(n_layers=12, d_model=768, n_heads=12, d_ff=3072,
               img=224, patch=16, name="vit-base") -> ArchConfig:
    return ArchConfig(name=name, family="encoder", n_layers=n_layers,
                      d_model=d_model, n_heads=n_heads, n_kv_heads=n_heads,
                      d_ff=d_ff, vocab=0, norm="layernorm", act="gelu",
                      max_position_embeddings=(img // patch) ** 2 + 1,
                      frontend="vision_stub")


def _enc_block_init(gen: torch.Generator, cfg: ArchConfig, device,
                    lead=()) -> Params:
    return {"ln1": blocks.norm_init(cfg, device, lead),
            "attn": blocks.attention_init(gen, cfg, device, lead),
            "ln2": blocks.norm_init(cfg, device, lead),
            "mlp": blocks.mlp_init(gen, cfg, device, lead)}


def _encoder(params: Params, x: torch.Tensor, cfg: ArchConfig,
             qcfg: QuantLike, key) -> torch.Tensor:
    """Pre-LN encoder stack, bidirectional attention without RoPE; the
    policy may resolve runs of layers differently (``layer_groups``)."""
    sc = ensure_scope(qcfg)
    L = cfg.n_layers
    layers = blocks.unstack(params["blocks"], L)
    for start, stop, bsc in layer_groups(sc, L, _ENC_BLOCK_LEAVES):
        for bp in layers[start:stop]:
            h = blocks.norm_apply(bp["ln1"], x, cfg, bsc.child("ln1"), key)
            h, _ = blocks.attention_apply(bp["attn"], h, cfg,
                                          bsc.child("attn"), key,
                                          causal=False, use_rope=False)
            x = x + h
            h = blocks.norm_apply(bp["ln2"], x, cfg, bsc.child("ln2"), key)
            x = x + blocks.mlp_apply(bp["mlp"], h, cfg, bsc.child("mlp"),
                                     key)
    return x


def bert_init(gen: torch.Generator, cfg: ArchConfig, num_labels: int = 2,
              span_head: bool = False, device="cuda") -> Params:
    """Random params (normal · 0.02 matrices, zero biases, unit LN gains)
    drawn from ``gen``, a generator on ``device``."""
    device = resolve_device(device)
    D = cfg.d_model

    def init(*shape):
        return blocks._init(gen, shape, device)
    p = {
        "embed": init(cfg.vocab, D),
        "pos_embed": init(cfg.max_position_embeddings, D),
        "type_embed": init(2, D),
        "embed_ln": blocks.norm_init(cfg, device),
        "blocks": _enc_block_init(gen, cfg, device, (cfg.n_layers,)),
        "pooler": init(D, D),
        "pooler_b": torch.zeros((D,), device=device),
        "head": init(D, num_labels),
        "head_b": torch.zeros((num_labels,), device=device),
    }
    if span_head:
        p["span"] = init(D, 2)
    return p


def bert_apply(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
               qcfg: QuantLike, key, segment: Optional[torch.Tensor] = None,
               pool: bool = True) -> torch.Tensor:
    """tokens (B, S) -> class logits (B, num_labels) through the pooler
    (``pool``), or per-position span logits (B, S, 2)."""
    S = tokens.shape[1]
    sc = ensure_scope(qcfg)
    x = int_ops.int_embedding(params["embed"], tokens, key, sc.leaf("embed"))
    x = x + params["pos_embed"][None, :S]
    if segment is not None:
        x = x + int_ops.int_embedding(params["type_embed"], segment, key,
                                      sc.leaf("type_embed"))
    x = blocks.norm_apply(params["embed_ln"], x, cfg, sc.child("embed_ln"),
                          key)
    x = _encoder(params, x, cfg, sc, key)
    if pool:
        # BERT pooler: dense + tanh on the CLS token; the tanh is a kept op
        cls = int_ops.int_linear(x[:, 0], params["pooler"],
                                 params["pooler_b"], key, sc.leaf("pooler"))
        cls = int_ops.int_activation(cls, sc.child("pooler").leaf("act"),
                                     "tanh")
        return int_ops.int_linear(cls, params["head"], params["head_b"], key,
                                  sc.leaf("head"))
    return int_ops.int_linear(x, params["span"], None, key,
                              sc.leaf("span_head"))


def _pick(logp: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.take_along_dim(logp, idx.long()[:, None], dim=-1)


def bert_cls_loss(params: Params, batch: dict, cfg: ArchConfig,
                  qcfg: QuantLike, key):
    """Mean cross-entropy of the class logits -> ``(loss, {"logits"})``."""
    logits = bert_apply(params, batch["tokens"], cfg, qcfg, key,
                        segment=batch.get("segment"))
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(_pick(logp, batch["labels"])), {"logits": logits}


def bert_span_loss(params: Params, batch: dict, cfg: ArchConfig,
                   qcfg: QuantLike, key):
    """SQuAD-style span prediction: log-softmax over positions for the
    start and end -> ``(loss, {"start_lp", "end_lp"})``."""
    out = bert_apply(params, batch["tokens"], cfg, qcfg, key, pool=False)
    start_lp = torch.log_softmax(out[..., 0].to(torch.float32), dim=-1)
    end_lp = torch.log_softmax(out[..., 1].to(torch.float32), dim=-1)
    ls = _pick(start_lp, batch["span_start"])
    le = _pick(end_lp, batch["span_end"])
    return -0.5 * torch.mean(ls + le), {"start_lp": start_lp,
                                        "end_lp": end_lp}


# ===================== ViT =====================

def vit_init(gen: torch.Generator, cfg: ArchConfig, num_classes: int = 10,
             img: int = 224, patch: int = 16, channels: int = 3,
             device="cuda") -> Params:
    """Random params drawn from ``gen`` (a generator on ``device``), in the
    reference's tree: the patch projection, the class token, learned
    positions, the stacked encoder blocks, the final norm and the head."""
    device = resolve_device(device)
    D = cfg.d_model

    def init(*shape):
        return blocks._init(gen, shape, device)
    return {
        "patch_w": init(patch * patch * channels, D),
        "patch_b": torch.zeros((D,), device=device),
        "cls": init(1, 1, D),
        "pos_embed": init((img // patch) ** 2 + 1, D),
        "blocks": _enc_block_init(gen, cfg, device, (cfg.n_layers,)),
        "final_ln": blocks.norm_init(cfg, device),
        "head": init(D, num_classes),
        "head_b": torch.zeros((num_classes,), device=device),
    }


def vit_apply(params: Params, images: torch.Tensor, cfg: ArchConfig,
              qcfg: QuantLike, key, patch: int = 16) -> torch.Tensor:
    """images (B, H, W, C) f32 -> class logits (B, num_classes): patch
    embedding, the class token in front, learned positions, the encoder,
    the final norm over every token, the head on the class token."""
    sc = ensure_scope(qcfg)
    x = int_ops.int_patch_embed(images, params["patch_w"], params["patch_b"],
                                key, sc.leaf("patch_embed"), patch)
    cls = params["cls"].expand(x.shape[0], 1, cfg.d_model)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"][None]
    x = _encoder(params, x, cfg, sc, key)
    x = blocks.norm_apply(params["final_ln"], x, cfg, sc.child("final_ln"),
                          key)
    return int_ops.int_linear(x[:, 0], params["head"], params["head_b"], key,
                              sc.leaf("head"))


def vit_cls_loss(params: Params, batch: dict, cfg: ArchConfig,
                 qcfg: QuantLike, key, patch: int = 16):
    """Mean cross-entropy of the class logits -> ``(loss, {"logits"})``."""
    logits = vit_apply(params, batch["images"], cfg, qcfg, key, patch=patch)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    return -torch.mean(_pick(logp, batch["labels"])), {"logits": logits}
