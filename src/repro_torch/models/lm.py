"""Decoder-only language model, the dense / MoE / SSM / hybrid / VLM
families: init, the training loss, the full-prompt prefill, the KV / SSM
cache, chunked prefill and decode.

Counterpart of ``repro/models/lm.py``.
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
the generator (``_remat``), with probes suspended.  Under a mesh step a
layer stack's leaves arrive as the rank's blocks (``sharding.Stack``):
each layer gathers its own (``sharding.gather_layer``) inside the function
the remat checkpoints, so the recompute gathers again and nothing
gathered outlives the layer; full tensors pass through.  Its sharding
constraints (``sharding.constrain*``) are identities on one device and
are left out; its ``health.probe`` calls are here (the embedding's output
and the head's input, beside the blocks' own).

Under a step that splits its products over the model group
(``dfx.model``, ``sharding.tensor_parallel``: every family here)
the embedding, the tied or untied head and the cross entropy are
vocab-parallel: each rank holds the rows ``[r V / M, (r + 1) V / M)`` of
the padded vocabulary, looks up the ids there (the rows SUMmed over the
group), computes its columns of the logits, and the loss reduces the row
max, the sum of exps and the target's logit over the group
(``token_ce_vocab_parallel``); the blocks split as ``models/blocks.py``
says, the Mamba2 layers as ``models/ssm.py`` does, and the hybrid's shared
block (one set of model shards, its gradient summed over its calls) as
an attention block.

By default such a step also shards the sequence (``sharding.
SEQUENCE_SHARDING``, ``int_ops.sequence_split``): the embedding's lookup
is reduce-scattered onto the rank's rows of the sequence (the VLM's rows
taken after the patch prefix is put in front), every layer's residual
stream, norms and residual adds are those rows, ``final_norm`` runs on
them and the head reads them through ``int_ops.gather_from_sequence``
(the VLM's text positions cut from the gathered sequence, its
``final_norm`` whole, as without).

A MoE block's ``moe`` sublayer (``blocks.moe_apply``) takes the MLP's
place; its load-balancing loss is summed over the layers and ``lm_loss``
adds ``0.01 · aux / n_layers``, as the reference does.

The SSM family is a stack of Mamba2 layers (``models/ssm.py``); the
hybrid runs the one ``shared_attn`` block (a dense attention block, one
param set) after every ``hybrid_attn_every`` of them, each of its
``L // every`` calls with a KV cache of its own at decode.  Their layers
run under the same remat (the shared block's calls too) and with probes
suspended, as the reference masks them there.  Their recurrence has no
cache-prefill form: ``lm_prefill_cache`` raises for them and the engine
teacher-forces a prompt through ``lm_decode_step``.  The decode cache
keeps the SSM and conv states FP32 and is updated in place, like the KV
cache.  The VLM family is the dense stack behind an ``mm_proj``
projection of precomputed patch embeddings, put in front of the tokens
(``prefix_embeds`` / the batch's ``patch_embeds``); its loss counts the
text positions only.

Serving runs under a mesh too (``sharding.serving``, the reference's
dry-run layout): ``lm_prefill``, ``lm_prefill_cache`` and
``lm_decode_step`` take the rank's ``view`` of its parameter blocks (each
layer gathered inside the layer, as in training), the rank's rows of the
batch and the rank's cache (``init_cache(..., mesh=)``: its rows, its kv
heads, its SSD heads and conv channels), split every product over the
model group as a training step does and return the rank's rows and
vocabulary columns of the logits.  A prompt the model group divides runs
sequence-sharded and is gathered before the head; a one-token decode
stays whole (``int_ops.sequence_split``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import sharding, utils
from repro_torch.core import dfx, health, int_ops
from repro_torch.core.qpolicy import (PolicyScopeError, QuantLike,
                                      ensure_scope, layer_groups)
from repro_torch.models import blocks, ssm
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]

#: families whose layers carry an SSM state (no cache-prefill form)
STATE_FAMILIES = ("ssm", "hybrid")


def _require_ported(cfg: ArchConfig) -> None:
    if cfg.enc_dec:
        raise NotImplementedError(
            f"{cfg.name}: an enc-dec arch runs through models/encdec.py "
            "(encdec_init, encdec_loss, encode, encdec_precompute_cross, "
            "encdec_decode_step), not the decoder-only models/lm.py")
    if (cfg.family not in ("dense", "moe", "ssm", "hybrid", "vlm")
            or bool(cfg.moe_experts) != (cfg.family == "moe")
            or bool(cfg.vlm_prefix) != (cfg.family == "vlm")
            or (cfg.family == "hybrid"
                and (not cfg.hybrid_attn_every
                     or cfg.n_layers % cfg.hybrid_attn_every))):
        raise NotImplementedError(
            f"{cfg.name}: models/lm.py runs the decoder-only families "
            f"(dense, MoE, SSM, hybrid, VLM); got family={cfg.family!r}")


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


#: every integer-layer leaf path inside one Mamba2 layer
_MAMBA_LEAVES = ["mamba." + n for n in
                 ("wz", "wx", "wBC", "wdt", "conv_x", "conv_BC",
                  "norm_g", "out_proj",
                  "act.conv_x", "act.conv_BC", "act.gate")]


def _uniform_stack_scope(sc, L: int, leaves, what: str):
    """The one scope of a stack that cannot be split into groups (the
    hybrid's), raising when the policy resolves it per layer."""
    groups = layer_groups(sc, L, leaves)
    if len(groups) > 1:
        raise PolicyScopeError(
            f"quantization policy resolves non-uniformly over the {what} "
            f"block stack ({len(groups)} groups); per-layer-index scope "
            "rules are not supported for the hybrid family — use rules "
            "uniform over 'blocks.*'")
    return groups[0][2]


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
    if cfg.family in STATE_FAMILIES:
        params["blocks"] = {"mamba": ssm.mamba2_init(gen, cfg, device, L)}
        if cfg.family == "hybrid":
            params["shared_attn"] = _block_init(gen, cfg, device, ())
    else:
        params["blocks"] = _block_init(gen, cfg, device, L)
    if cfg.vlm_prefix:
        params["mm_proj"] = blocks._init(gen, (cfg.d_model, cfg.d_model),
                                         device)
    return params


def _block_init(gen: torch.Generator, cfg: ArchConfig, device,
                lead: Tuple[int, ...]) -> Params:
    """An attention block's params (stacked with ``lead = (L,)``)."""
    p = {"ln1": blocks.norm_init(cfg, device, lead),
         "attn": blocks.attention_init(gen, cfg, device, lead),
         "ln2": blocks.norm_init(cfg, device, lead)}
    if cfg.moe_experts:
        p["moe"] = blocks.moe_init(gen, cfg, device, lead)
    else:
        p["mlp"] = blocks.mlp_init(gen, cfg, device, lead)
    return p


def _attn_block(bp: Params, x: torch.Tensor, cfg: ArchConfig,
                qcfg: QuantLike, key, *, cache=None, cache_index=0,
                seq: bool = False):
    """One attention block; ``seq``: ``x`` and the output are the rank's
    rows of the sequence."""
    bp = sharding.gather_layer(bp)
    sc = ensure_scope(qcfg)
    h = blocks.norm_apply(bp["ln1"], x, cfg, sc.child("ln1"), key, seq=seq)
    h, new_cache = blocks.attention_apply(
        bp["attn"], h, cfg, sc.child("attn"), key,
        kv_cache=cache, cache_index=cache_index, seq=seq)
    x = x + h
    h = blocks.norm_apply(bp["ln2"], x, cfg, sc.child("ln2"), key, seq=seq)
    aux = torch.zeros((), device=x.device)
    if "moe" in bp:
        h, aux = blocks.moe_apply(bp["moe"], h, cfg, sc.child("moe"), key,
                                  seq=seq)
    else:
        h = blocks.mlp_apply(bp["mlp"], h, cfg, sc.child("mlp"), key,
                             seq=seq)
    return x + h, aux, new_cache


def _embed(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
           qcfg: QuantLike, key, prefix_embeds=None,
           seq: bool = False) -> torch.Tensor:
    """The tokens' embeddings; for the VLM, the projected patch embeddings
    (``int_linear`` through ``mm_proj``) in front of them.  ``seq``: the
    rank's rows of the sequence."""
    sc = ensure_scope(qcfg)
    table, tp = params["embed"], dfx.model
    vlm = prefix_embeds is not None
    x = int_ops.int_embedding(
        table, tokens, key, sc.leaf("embed"),
        vocab_start=None if tp is None else tp.index * table.shape[0],
        seq=seq and not vlm)
    if vlm:
        pe = int_ops.int_linear(prefix_embeds, params["mm_proj"], None, key,
                                sc.leaf("mm_proj"))
        x = torch.cat([pe, x], dim=1)
    with dfx.split(seq and not vlm):
        health.probe(sc.path + ("embed",), x, sc.leaf("embed").act_bits)
    if seq and vlm:
        # the patch prefix every rank projects whole goes in front first
        x = int_ops.scatter_to_sequence(x)
    return x


def _logits(params: Params, x: torch.Tensor, cfg: ArchConfig,
            qcfg: QuantLike, key, seq: bool = False) -> torch.Tensor:
    """``final_norm`` and the head; ``seq``: ``x`` is the rank's rows of
    the sequence, the logits the whole sequence's (the rank's vocabulary
    columns)."""
    sc = ensure_scope(qcfg)
    x = blocks.norm_apply(params["final_norm"], x, cfg,
                          sc.child("final_norm"), key, seq=seq)
    tied = cfg.tie_embeddings
    head = params["embed"] if tied else params["lm_head"]
    split = None
    if dfx.model is not None:
        # the rank's vocabulary columns: column-parallel over V
        x, split = int_ops.into_split(x, seq)[0], "col"
    health.probe(sc.path + ("lm_head",), x, sc.leaf("lm_head").act_bits)
    # the head resolves under "lm_head" whether or not it is tied; a tied
    # head is the (V, D) table, read as its transpose
    return int_ops.int_linear(x, head, None, key, sc.leaf("lm_head"),
                              transposed_w=tied, split=split)


def _replay_key(key, state):
    """The key a layer's recompute draws from: a fresh generator on the
    key's device set to ``state``, the key's state before the layer's
    forward; the key itself (None) when there is no state."""
    if state is None:
        return key
    gen = torch.Generator(device=key.device)
    gen.set_state(state)
    if dfx.observer is not None:
        dfx.observer.replay(gen)
    return gen


def _remat(fn, x: torch.Tensor, key):
    """``fn(x, key)`` — one layer — under ``torch.utils.checkpoint``
    (non-reentrant): the backward recomputes the layer from its input.

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
    replayed, so its layers run without remat.

    What the backward keeps of the layer is ``utils.CHECKPOINT_POLICY``'s:
    its input (full remat), or under ``"dots"`` also the outputs of its
    FP32 2-D products, which the recompute then takes as they are."""
    if key is not None and not isinstance(key, torch.Generator):
        return fn(x, key)
    state = key.get_state() if key is not None else None
    calls = []

    def run(x):
        if calls:                    # the recompute: probed once already
            prev, int_ops.RECOMPUTING = int_ops.RECOMPUTING, True
            try:
                with health.suspend():
                    return fn(x, _replay_key(key, state))
            finally:
                int_ops.RECOMPUTING = prev
        calls.append(1)
        return fn(x, key)
    context = utils.checkpoint_context()
    extra = {} if context is None else {"context_fn": context}
    # the layers draw from ``key`` only, never from the default generators
    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False,
                                             preserve_rng_state=False,
                                             **extra)


def _remat_layer(bp: Params, x: torch.Tensor, cfg: ArchConfig,
                 bsc: QuantLike, key, seq: bool = False):
    """``_attn_block`` under ``_remat``: (x, aux)."""
    return _remat(lambda x, k: _attn_block(bp, x, cfg, bsc, k,
                                           seq=seq)[:2], x, key)


def _mamba_layer(bp: Params, x: torch.Tensor, cfg: ArchConfig,
                 bsc: QuantLike, key, seq: bool = False) -> torch.Tensor:
    """One residual Mamba2 layer of the training stack."""
    bp = sharding.gather_layer(bp)
    h, _ = ssm.mamba2_apply(bp["mamba"], x, cfg, bsc.child("mamba"), key,
                            seq=seq)
    return x + h


def _backbone_train(params: Params, x: torch.Tensor, cfg: ArchConfig,
                    qcfg: QuantLike, key, *, remat: bool = True,
                    seq: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """All layers, no cache (training, and ``lm_prefill``): a Python loop
    over the stack, each run of identically resolved layers under its
    scope.  ``remat``: each layer under ``_remat`` while autograd
    records (the reference's per-layer remat; off only to compare the
    two).  Returns (x, the MoE aux losses summed over the layers).  The
    SSM and hybrid stacks run with probes suspended, as the reference
    masks them (``_backbone_train_ssm``).  ``seq``: ``x`` and the output
    are the rank's rows of the sequence."""
    sc = ensure_scope(qcfg)
    layers = blocks.unstack(params["blocks"], cfg.n_layers)
    remat = remat and torch.is_grad_enabled()
    if cfg.family in STATE_FAMILIES:
        with health.suspend():
            return _backbone_train_ssm(params, layers, x, cfg, sc, key,
                                       remat, seq)
    aux = torch.zeros((), device=x.device)
    for start, stop, bsc in layer_groups(sc, cfg.n_layers,
                                         _block_leaves(cfg)):
        for i in range(start, stop):
            if remat:
                x, a = _remat_layer(layers[i], x, cfg, bsc, key, seq)
            else:
                x, a, _ = _attn_block(layers[i], x, cfg, bsc, key, seq=seq)
            aux = aux + a
    return x, aux


def _backbone_train_ssm(params: Params, layers: list, x: torch.Tensor,
                        cfg: ArchConfig, sc, key, remat: bool,
                        seq: bool = False):
    """The SSM stack (runs of identically resolved layers), or the
    hybrid's ``L // every`` groups of ``every`` Mamba2 layers, each group
    followed by the shared attention block, under one scope (a policy
    that splits the hybrid's stack raises).  Returns (x, 0)."""
    L = cfg.n_layers
    zero = torch.zeros((), device=x.device)

    def mamba(i, bsc, x):
        if remat:
            return _remat(lambda x, k: _mamba_layer(layers[i], x, cfg, bsc,
                                                    k, seq), x, key)
        return _mamba_layer(layers[i], x, cfg, bsc, key, seq)

    if cfg.family == "ssm":
        for start, stop, bsc in layer_groups(sc, L, _MAMBA_LEAVES):
            for i in range(start, stop):
                x = mamba(i, bsc, x)
        return x, zero
    every = cfg.hybrid_attn_every
    bsc = _uniform_stack_scope(sc, L, _MAMBA_LEAVES, "hybrid")
    ssc = sc.child("shared_attn")
    shared = params["shared_attn"]
    for g in range(L // every):
        for i in range(g * every, (g + 1) * every):
            x = mamba(i, bsc, x)
        if remat:
            x, _ = _remat(lambda x, k: _attn_block(shared, x, cfg, ssc, k,
                                                   seq=seq)[:2], x, key)
        else:
            x, _, _ = _attn_block(shared, x, cfg, ssc, key, seq=seq)
    return x, zero


def token_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over the valid labels (label < 0: masked).
    Under a mesh (``dfx.sync``) the mean is the logical batch's: the
    count is summed over the ranks, and each rank returns its rows' share
    of the mean times the ranks, so the step's mean of the ranks' losses
    is the logical loss and its backward, seeded with 1 / ranks, gives each
    token the gradient one device would."""
    valid = labels >= 0
    lab = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, lab[..., None])[..., 0]
    n = torch.clamp(dfx.global_sum(valid.sum()), min=1).to(torch.float32)
    return -torch.sum(ll * valid) / (n / dfx.ranks())


class _VocabParallelLogProb(torch.autograd.Function):
    """``log p(label)`` of each row from the rank's columns ``[start,
    start + V_r)`` of the logits, over the model group: the row max
    MAX-reduced, then the sum of exps and the label's logit (taken where
    it lies; a label outside the shard adds 0) SUMmed in one all-reduce.
    Backward: ``g · (onehot − softmax)`` on the rank's columns."""

    @staticmethod
    def forward(ctx, logits, lab, start):
        tp = dfx.model
        z = logits.to(torch.float32)
        m = tp.max(z.amax(-1), "tp_ce")
        e = torch.exp(z - m[..., None])
        local = lab.long() - start
        inside = (local >= 0) & (local < z.shape[-1])
        local = local.clamp(0, z.shape[-1] - 1)
        zt = torch.gather(z, -1, local[..., None])[..., 0]
        s, zt = tp.sum(torch.stack([e.sum(-1), torch.where(inside, zt, 0.0)]),
                       "tp_ce").unbind(0)
        ctx.save_for_backward(e, s, local, inside)
        return zt - m - torch.log(s)

    @staticmethod
    def backward(ctx, g):
        e, s, local, inside = ctx.saved_tensors
        d = e * (-g / s)[..., None]
        d.scatter_add_(-1, local[..., None],
                       torch.where(inside, g, 0.0)[..., None])
        return d, None, None


def token_ce_vocab_parallel(logits: torch.Tensor,
                            labels: torch.Tensor) -> torch.Tensor:
    """``token_ce`` over vocab-parallel logits: ``logits`` the rank's
    columns ``[r V_r, (r + 1) V_r)`` of the padded vocabulary (the pad
    columns in the sum of exps, as one device has them), the mean over the
    logical batch's valid labels, whose count is summed over the batch
    ranks only (the model ranks hold the same labels)."""
    valid = labels >= 0
    lab = torch.where(valid, labels, torch.zeros_like(labels))
    ll = _VocabParallelLogProb.apply(logits, lab,
                                     dfx.model.index * logits.shape[-1])
    n = torch.clamp(dfx.global_sum(valid.sum()), min=1).to(torch.float32)
    return -torch.sum(ll * valid) / (n / dfx.ranks())


def lm_loss(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            qcfg: QuantLike, key) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Next-token cross entropy.  batch: tokens (B, S) and labels (B, S)
    integer tensors (label -1: masked); the VLM's also ``patch_embeds``
    (B, vlm_prefix, D), whose positions the loss leaves out.  Returns
    ``(loss, {"ce", "aux"})``: for a MoE config the loss includes ``0.01 ·
    aux / n_layers`` and ``aux`` is the layers' summed balance loss (0 for
    the other families); ``ce`` is the returned loss, as the reference
    reports it."""
    _require_ported(cfg)
    tokens, pe = batch["tokens"], batch.get("patch_embeds")
    seq = int_ops.sequence_split(
        tokens.shape[1] + (0 if pe is None else pe.shape[1]))
    x = _embed(params, tokens, cfg, qcfg, key, prefix_embeds=pe, seq=seq)
    x, aux = _backbone_train(params, x, cfg, qcfg, key, seq=seq)
    if cfg.vlm_prefix:
        if seq:
            # the whole sequence, as every rank then computes the head's
            # input: the gradient of the rank's rows is its rows of it
            x = int_ops.gather_from_sequence(x)[1]
            seq = False
        x = x[:, -tokens.shape[1]:]          # the text positions only
    logits = _logits(params, x, cfg, qcfg, key, seq=seq)
    ce = token_ce if dfx.model is None else token_ce_vocab_parallel
    loss = ce(logits, batch["labels"])
    if cfg.moe_experts:
        loss = loss + 0.01 * aux / cfg.n_layers
    return loss, {"ce": loss.detach(), "aux": aux.detach()}


def lm_prefill(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
               qcfg: QuantLike, prefix_embeds=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass over the full prompt, no cache and no key (round to
    nearest): the training backbone, whose FP32 attention is the chunked
    ``flash_attention``.  ``prefix_embeds`` (VLM): patch embeddings (B, P,
    D) projected in front of the tokens.  Returns (last-position logits
    (B, 1, V), the final hidden states (B, P + S, D))."""
    _require_ported(cfg)
    seq = int_ops.sequence_split(tokens.shape[1] + (
        0 if prefix_embeds is None else prefix_embeds.shape[1]))
    x = _embed(params, tokens, cfg, qcfg, None, prefix_embeds=prefix_embeds,
               seq=seq)
    x, _ = _backbone_train(params, x, cfg, qcfg, None, seq=seq)
    x = _whole(x, seq)
    logits = _logits(params, x[:, -1:], cfg, qcfg, None)
    return logits, x


def _whole(x: torch.Tensor, seq: bool) -> torch.Tensor:
    """The whole sequence of a stream that ran as the rank's rows."""
    return int_ops.gather_from_sequence(x)[1] if seq else x


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dtype=torch.float32, device="cuda", mesh=None) -> Params:
    """Decode cache and a per-row (B,) int32 ``index`` (continuous
    batching admits slots at different times).  Attention families: k / v
    (L, B, max_seq, KV, hd) of ``dtype``.  SSM and hybrid: the FP32 states
    ``ssm`` (L, B, H, P, N), ``conv_x`` (L, B, K-1, DI) and ``conv_BC``
    (L, B, K-1, 2N); the hybrid also k / v (G, B, max_seq, KV, hd), one
    per call of the shared block.  Batch is axis 1 of every stacked
    tensor.  ``mesh``: the rank's block of each (``sharding.cache_pspecs``:
    its rows and kv heads, its SSD heads and conv channels)."""
    _require_ported(cfg)
    device = resolve_device(device)
    if mesh is not None:
        return sharding.cache_zeros(init_cache(cfg, batch, max_seq, dtype,
                                               "meta"), mesh, cfg, device)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    index = torch.zeros((batch,), dtype=torch.int32, device=device)
    cache = {}
    if cfg.family in STATE_FAMILIES:
        cache.update(zip(("ssm", "conv_x", "conv_BC"),
                         ssm.mamba2_init_state(cfg, batch, device, (L,))))
        if cfg.family == "ssm":
            return dict(cache, index=index)
        L = L // cfg.hybrid_attn_every
    shape = (L, batch, max_seq, KV, hd)
    return dict(cache, k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device),
                index=index)


def lm_prefill_cache(params: Params, tokens: torch.Tensor, cache: Params,
                     cfg: ArchConfig,
                     qcfg: QuantLike) -> Tuple[torch.Tensor, Params]:
    """Chunked prefill through the decode cache.

    tokens: (B, S) int — written into the cache at ``cache['index'] ..
    index+S`` with per-row ``q_offset = index`` (S == 1 is plain decode).
    The cache's k/v tensors are updated in place; returns (last-position
    logits (B, 1, V), cache with the advanced index).  Attention-cache
    families only: the SSM and hybrid recurrence steps token by token
    (``lm_decode_step``).
    """
    _require_ported(cfg)
    if cfg.family in STATE_FAMILIES:
        raise ValueError(
            "lm_prefill_cache supports attention-cache families only; "
            f"got family={cfg.family!r} (use lm_decode_step per token)")
    key = None                                   # no stochastic rounding
    index = cache["index"]
    sc = ensure_scope(qcfg)
    seq = int_ops.sequence_split(tokens.shape[1])
    x = _embed(params, tokens, cfg, sc, key, seq=seq)
    layers = blocks.unstack(params["blocks"], cfg.n_layers)
    groups = layer_groups(sc, cfg.n_layers, _block_leaves(cfg))
    for start, stop, bsc in groups:
        for i in range(start, stop):
            x, _, _ = _attn_block(layers[i], x, cfg, bsc, key,
                                  cache=(cache["k"][i], cache["v"][i]),
                                  cache_index=index, seq=seq)
    logits = _logits(params, _whole(x, seq)[:, -1:], cfg, sc, key)
    return logits, {"k": cache["k"], "v": cache["v"],
                    "index": index + tokens.shape[1]}


def lm_decode_step(params: Params, token: torch.Tensor, cache: Params,
                   cfg: ArchConfig,
                   qcfg: QuantLike) -> Tuple[torch.Tensor, Params]:
    """token: (B, 1).  Returns (logits (B, 1, V), cache); the cache's
    tensors are updated in place."""
    if cfg.family not in STATE_FAMILIES:
        return lm_prefill_cache(params, token, cache, cfg, qcfg)
    _require_ported(cfg)
    key = None                                   # no stochastic rounding
    index = cache["index"]
    sc = ensure_scope(qcfg)
    x = _embed(params, token, cfg, sc, key)
    L = cfg.n_layers
    layers = blocks.unstack(params["blocks"], L)

    def mamba(i, bsc, x):
        h, new = ssm.mamba2_apply(
            sharding.gather_layer(layers[i])["mamba"], x, cfg,
            bsc.child("mamba"), key,
            state=tuple(cache[n][i] for n in ("ssm", "conv_x", "conv_BC")),
            decode=True)
        for n, t in zip(("ssm", "conv_x", "conv_BC"), new):
            cache[n][i].copy_(t)
        return x + h

    if cfg.family == "ssm":
        for start, stop, bsc in layer_groups(sc, L, _MAMBA_LEAVES):
            for i in range(start, stop):
                x = mamba(i, bsc, x)
    else:
        every = cfg.hybrid_attn_every
        bsc = _uniform_stack_scope(sc, L, _MAMBA_LEAVES, "hybrid")
        ssc = sc.child("shared_attn")
        with health.suspend():       # as the reference masks them here
            for g in range(L // every):
                for i in range(g * every, (g + 1) * every):
                    x = mamba(i, bsc, x)
                x, _, _ = _attn_block(params["shared_attn"], x, cfg, ssc,
                                      key, cache=(cache["k"][g],
                                                  cache["v"][g]),
                                      cache_index=index)
    logits = _logits(params, x, cfg, sc, key)
    return logits, dict(cache, index=index + 1)
