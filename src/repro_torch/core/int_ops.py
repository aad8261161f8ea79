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

``int_patch_embed`` (ViT) is a reshape in front of ``int_linear``;
``int_conv1d_depthwise`` (the Mamba frontend) is integer tensor code
around two quantizations, as the reference's is XLA work around them.
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

Tensor parallelism (a step that splits its products over the ``model``
group, ``dfx.model`` set): ``int_linear`` / ``int_batched_linear`` take
``split="col"`` (the weight's output columns are the rank's; the output
and its gradient are the rank's columns) or ``split="row"`` (the input
and the weight's rows are the rank's; the f32 partial outputs are summed
over the group before the bias), Megatron's two conjugate operators:
``copy_to_model`` (identity, its backward the SUM of the dX partials of
every column-parallel product that reads the input) and
``reduce_from_model``.  ``int_attention(split=True)`` works on the rank's
heads, ``int_embedding(vocab_start=)`` on its vocabulary rows and
``int_conv1d_depthwise(split=True)`` on its channels; ``tp_heads``,
``scatter_to_model`` and ``gather_from_model`` move a tensor's last dim
between whole and the ranks' blocks (Mamba2's per-head leaves, its gated
norm over the whole inner row).  Every
quantize of a split tensor takes the logical tensor's exponent
(``dfx.split``); the SR noise of a split gradient is drawn at the rank's
shape.

Sequence parallelism (``dfx.model.sequence``, ``sequence_split``): the
residual stream between the products is the rank's rows ``(B, S / M, D)``
of the sequence, Megatron's two other conjugate operators move it:
``gather_from_sequence`` (an all-gather into the column-parallel products;
its backward reduce-scatters their dX partials, tag ``sp_gather``) and
``reduce_scatter_to_sequence`` (the row-parallel partials summed, the rank
keeping its rows; its backward all-gathers, tag ``sp_scatter``), in place
of ``copy_to_model`` / ``reduce_from_model``; ``scatter_to_sequence`` takes
the rank's rows of a tensor every rank holds whole (tag ``sp_rows``).  With
``seq`` the norms, the row-parallel ``int_linear`` and the vocab-parallel
``int_embedding`` work on the rank's rows: each quantize of such a tensor
(a norm's input, the gradient reaching its output) takes the logical
tensor's exponent, and its SR noise is the rank's rows of the logical
tensor's draw, so the ranks' generators stay in step and every row gets
the noise one device gives it.  A whole leaf applied to the rank's rows
(a norm's gain and bias, a row-parallel bias) gets a partial gradient on
each rank, SUMmed over the model group where it is used (tag
``sp_leaf``).
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


def _noise_2d(key, x: torch.Tensor, seq: bool = False) -> torch.Tensor:
    """Noise over the 2-D view of ``x``, as the reference draws it; with
    ``seq`` (``x`` the rank's rows of a sequence-sharded tensor) the
    rank's rows of the logical tensor's draw."""
    D = x.shape[-1]
    if not seq:
        return dfx.uniform(key, (x.numel() // D, D), x.device)
    u = dfx.uniform(key, (x.numel() * dfx.model.size // D, D), x.device)
    return u.reshape(x.shape[0], dfx.model.size, -1)[:, dfx.model.index]


def _act_noise(x: torch.Tensor, cfg: QuantConfig, key, stacked=False,
               seq: bool = False):
    """Noise ``u`` for the activation's forward quantization when
    ``cfg.stochastic_fwd`` and a key is given (over the 2-D view, or the
    whole (E, C, K) stack; ``seq``: ``_noise_2d``'s rows), else None."""
    if not (cfg.stochastic_fwd and key is not None):
        return None
    if stacked:
        return dfx.uniform(key, tuple(x.shape), x.device)
    return _noise_2d(key, x, seq)


def _quant_grad(g: torch.Tensor, cfg: QuantConfig, key,
                limb_planes: bool = False,
                seq: bool = False) -> dfx.DfxTensor:
    """The upstream gradient at ``grad_bits``: stochastic rounding with
    noise from ``key`` when ``cfg.stochastic_grad`` and a key is given
    (over the 2-D view, as the reference draws it), else to nearest.
    ``seq``: ``g`` is the rank's rows of a sequence-sharded gradient, its
    exponent and noise the logical tensor's."""
    u = None
    if cfg.stochastic_grad and key is not None:
        u = _noise_2d(key, g, seq)
    with dfx.split(seq):
        return dfx.quantize(g, cfg.grad_bits, u=u, limb_planes=limb_planes)


# =========================================================================
# Linear
# =========================================================================

#: True inside a layer's recompute (``lm._remat``): a product marked
#: ``tail`` there (a layer's last, whose output no saved tensor depends on)
#: quantizes and saves its operands and skips its matmul, as the
#: reference's recompute, dead-code eliminated by JAX, never computes it
RECOMPUTING = False


class _IntLinear(torch.autograd.Function):
    """Integer linear: residuals are the (L, M, K) activation planes and the
    weight planes, with their exponents."""

    @staticmethod
    def forward(ctx, x, w, b, key, cfg: QuantConfig, transposed_w: bool,
                split: Optional[str] = None, tail: bool = False):
        with dfx.split(split == "row"):
            qx = dfx.quantize(x, cfg.act_bits, u=_act_noise(x, cfg, key),
                              limb_planes=True)
        with dfx.split(split is not None):
            qw = dfx.quantize(w, cfg.weight_bits, limb_planes=True)
        wm = qw.m.transpose(-1, -2) if transposed_w else qw.m
        K = x.shape[-1]
        xm = qx.m.reshape(qx.m.shape[0], -1, K)
        if tail and RECOMPUTING:
            # the recompute stops at this call's saved planes: its output
            # is never read (torch.utils.checkpoint's early stop)
            y2 = x.new_empty((xm.shape[1], wm.shape[-1]))
        else:
            y2 = kops.dfx_matmul_tiled(xm, qx.exp, cfg.act_bits, wm, qw.exp,
                                       cfg.weight_bits)
        y = y2.reshape(tuple(x.shape[:-1]) + (wm.shape[-1],))
        ctx.save_for_backward(xm, qx.exp, qw.m, qw.exp)
        ctx.cfg, ctx.key, ctx.transposed_w = cfg, key, transposed_w
        ctx.x_shape, ctx.has_b, ctx.split = tuple(x.shape), b is not None, split
        return y + b if b is not None else y   # O(N) bias add, kept FP32

    @staticmethod
    def backward(ctx, g):
        xm, x_exp, wm, w_exp = ctx.saved_tensors
        cfg = ctx.cfg
        N = g.shape[-1]
        with dfx.split(ctx.split == "col"):
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
        return dx, dw, db, None, None, None, None, None


def int_linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
               key, cfg: QuantConfig, *, transposed_w: bool = False,
               split: Optional[str] = None, seq: bool = False,
               tail: bool = False) -> torch.Tensor:
    """``y = x @ w (+ b)`` with integer forward and backward.  x: (..., K),
    w: (K, N), b: (N,) or None.

    ``transposed_w``: ``w`` is given as its (N, K) transpose — the tied
    head's embedding table.  It is quantized in that layout (the op is
    elementwise under one scale) and its planes reach the matmul as the
    K-major view, so the table is never copied or transposed; the backward
    reads the same planes (dX an NN product, the table's gradient a TN
    product in the table's own layout).

    ``split`` (tensor parallelism): "col", ``w`` / ``b`` the rank's shard
    of the output columns (of the tied table: its vocabulary rows), ``x``
    whole and entered through ``copy_to_model`` by the caller, once for
    every product that reads it; "row", ``x`` and ``w`` the rank's shard of
    the contraction, the partial outputs summed over the model group
    (``reduce_from_model``) before ``b``, which is whole, is added.  With
    ``seq`` (sequence parallelism) a row-parallel output leaves through
    ``reduce_scatter_to_sequence`` and ``b`` is added to the rank's rows
    (its partial gradient SUMmed over the group).  ``tail``: the layer's
    last product, skipped in its recompute (``RECOMPUTING``)."""
    row = split == "row"
    if cfg.enabled:
        y = _IntLinear.apply(x, w, None if row else b, key, cfg,
                             transposed_w, split, tail)
        if not row:
            return y
    else:
        y = torch.matmul(x, w.t() if transposed_w else w)
    if row and seq:
        y = reduce_scatter_to_sequence(y)
        b = None if b is None else copy_to_model(b, "sp_leaf")
    elif row:
        y = reduce_from_model(y)
    return y + b if b is not None else y


# =========================================================================
# Tensor parallelism: Megatron's conjugate operators over the model group
# =========================================================================

class _CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: the identity; its backward SUMs the dX partials
    of the column-parallel products that read the input over the model
    group, in f32 (under ``tag``)."""

    @staticmethod
    def forward(ctx, x, tag):
        ctx.tag = tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return dfx.model.sum(g, ctx.tag), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g``: the f32 SUM over the model group of the
    row-parallel partial outputs; its backward is the identity."""

    @staticmethod
    def forward(ctx, y):
        return dfx.model.sum(y, "tp_out")

    @staticmethod
    def backward(ctx, g):
        return g


class _ModelHead(torch.autograd.Function):
    """Head ``j`` of a (B, S, KV, hd) tensor every rank of the model group
    computes whole (Megatron's kv replication).  Backward: the rank's
    gradient of its head, zero at the others, SUMmed over the group, so
    each rank holds the logical gradient of every head."""

    @staticmethod
    def forward(ctx, t, j):
        ctx.shape, ctx.j = tuple(t.shape), j
        return t[:, :, j:j + 1].clone()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full[:, :, ctx.j:ctx.j + 1] = g
        return dfx.model.sum(full, "tp_kv"), None


def model_head(t: torch.Tensor, j: int) -> torch.Tensor:
    """Head ``j`` of ``t`` (B, S, KV, hd), whole on every rank of the model
    group, as (B, S, 1, hd)."""
    return _ModelHead.apply(t, j)


def _gathered(t: torch.Tensor, tag: str) -> torch.Tensor:
    """Every rank's ``t`` (..., n) over the model group side by side along
    the last dim, in rank order: (..., size · n)."""
    parts = dfx.model.gather(t, tag)                    # (size, ..., n)
    return parts.movedim(0, -2).reshape(tuple(t.shape[:-1]) + (-1,))


def _own_columns(t: torch.Tensor) -> torch.Tensor:
    """The rank's block of the last dim of ``t``."""
    n = t.shape[-1] // dfx.model.size
    return t[..., dfx.model.index * n:(dfx.model.index + 1) * n]


class _ScatterToModel(torch.autograd.Function):
    """The rank's block of the last dim of a tensor every rank of the model
    group holds whole.  Backward: the ranks' gradients of their blocks
    gathered side by side (an all-gather), so each rank holds the whole
    gradient."""

    @staticmethod
    def forward(ctx, t, tag):
        ctx.tag = tag
        return _own_columns(t).clone()

    @staticmethod
    def backward(ctx, g):
        return _gathered(g.contiguous(), ctx.tag), None


class _GatherFromModel(torch.autograd.Function):
    """The ranks' blocks of the last dim gathered into the whole tensor,
    on every rank; backward: the rank's block of the gradient, which every
    rank computes whole and alike."""

    @staticmethod
    def forward(ctx, t, tag):
        return _gathered(t.contiguous(), tag)

    @staticmethod
    def backward(ctx, g):
        return _own_columns(g).clone(), None


def scatter_to_model(t: torch.Tensor, tag: str) -> torch.Tensor:
    """The rank's block of the last dim of ``t``, whole on every rank of
    the model group; the backward all-gathers the blocks' gradients under
    ``tag``."""
    return _ScatterToModel.apply(t, tag)


def gather_from_model(t: torch.Tensor, tag: str) -> torch.Tensor:
    """The whole tensor from the ranks' blocks ``t`` of its last dim, an
    all-gather under ``tag``; the backward keeps the rank's block."""
    return _GatherFromModel.apply(t, tag)


def tp_heads(t: torch.Tensor) -> torch.Tensor:
    """The rank's SSD heads of ``t`` (..., NH), a per-head leaf every rank
    of the model group holds whole (Mamba2's ``A_log``, ``dt_bias``,
    ``D_skip``): the forward slices its ``NH / size`` heads; the backward
    all-gathers the ranks' gradients of their heads (tag ``tp_heads``), so
    every rank holds the leaf's whole gradient.

    Under a model group a Mamba2 layer's gradients are of two kinds.
    Per-rank partials, SUMmed over ``model`` before they reach a leaf:
    the dX of the column-parallel products (``copy_to_model``), the
    partial dB / dC of each rank's heads (the same operator after the
    conv), and these per-head leaves (here, as an all-gather of disjoint
    blocks).  Identical on every rank and never summed over ``model``:
    ``wBC`` and ``conv_BC`` (their input gradient is the summed dB / dC)
    and the gated norm's ``norm_g`` (the norm runs over the gathered row
    on every rank); the gathers' backward keeps the rank's block where the
    leaf is split."""
    return scatter_to_model(t, "tp_heads")


def copy_to_model(x: torch.Tensor, tag: str = "tp_dx") -> torch.Tensor:
    """``x``, whole on every rank of the model group, entering the
    column-parallel products that read it (or, tag ``sp_leaf``, a whole
    leaf applied to the rank's rows of the sequence): the backward SUMs
    the ranks' partial gradients."""
    return _CopyToModel.apply(x, tag)


def reduce_from_model(y: torch.Tensor) -> torch.Tensor:
    """The logical output of a row-parallel product from the rank's
    partial."""
    return _ReduceFromModel.apply(y)


# =========================================================================
# Sequence parallelism: the residual stream as the rank's rows
# =========================================================================

def sequence_split(length: int) -> bool:
    """Whether a stream of ``length`` positions runs as the ranks' rows:
    under a step that splits its products and shards the sequence
    (``dfx.model.sequence``) when the model group divides ``length``; a
    stream it does not divide stays whole, as the reference's
    ``constrain`` leaves such a dim unsharded."""
    tp = dfx.model
    return tp is not None and tp.sequence and length % tp.size == 0


def _seq_rows(t: torch.Tensor) -> torch.Tensor:
    """The rank's block of dim 1 of ``t``."""
    n = t.shape[1] // dfx.model.size
    return t[:, dfx.model.index * n:(dfx.model.index + 1) * n]


def _seq_gathered(t: torch.Tensor, tag: str) -> torch.Tensor:
    """The ranks' blocks ``t`` of dim 1 side by side, in rank order."""
    parts = dfx.model.gather(t.contiguous(), tag)    # (size, B, n, ...)
    return parts.movedim(0, 1).reshape(
        (t.shape[0], -1) + tuple(t.shape[2:]))


def _seq_summed(t: torch.Tensor, tag: str) -> torch.Tensor:
    """The SUM over the model group of ``t``'s rank block of dim 1."""
    M = dfx.model.size
    blocks = t.reshape((t.shape[0], M, -1) + tuple(t.shape[2:]))
    return dfx.model.reduce_scatter(blocks.movedim(1, 0), tag)


class _GatherFromSequence(torch.autograd.Function):
    """Megatron's sequence-parallel all-gather: the whole (B, S, ...)
    tensor from the ranks' rows (B, S / M, ...).  Two aliases of it: the
    first for the column-parallel products, whose dX partials the backward
    SUMs and scatters to the ranks' rows (one reduce-scatter), the second
    for products every rank computes whole (the kv replication, Mamba2's
    B / C, the MoE's router and dispatch), whose gradient is the logical
    one on every rank: the rank keeps its rows of it, added after the
    sum."""

    @staticmethod
    def forward(ctx, x):
        ctx.set_materialize_grads(False)
        full = _seq_gathered(x, "sp_gather")
        return full, full.view_as(full)

    @staticmethod
    def backward(ctx, g, g_whole):
        out = None if g is None else _seq_summed(g, "sp_gather")
        if g_whole is not None:
            rows = _seq_rows(g_whole)
            out = rows.clone() if out is None else out + rows
        return out


class _ReduceScatterToSequence(torch.autograd.Function):
    """Megatron's sequence-parallel reduce-scatter: the f32 SUM over the
    model group of the row-parallel partial outputs (B, S, ...), the rank
    keeping its rows.  Backward: the rows' gradients all-gathered."""

    @staticmethod
    def forward(ctx, y):
        return _seq_summed(y, "sp_scatter")

    @staticmethod
    def backward(ctx, g):
        return _seq_gathered(g, "sp_scatter")


class _ScatterToSequence(torch.autograd.Function):
    """The rank's rows of a tensor every rank of the model group holds
    whole.  Backward: the rows' gradients all-gathered, so every rank
    holds the whole gradient."""

    @staticmethod
    def forward(ctx, t):
        return _seq_rows(t).clone()

    @staticmethod
    def backward(ctx, g):
        return _seq_gathered(g, "sp_rows")


def gather_from_sequence(x: torch.Tensor):
    """The whole sequence from the rank's rows ``x`` (B, S / M, ...) as two
    aliases ``(split, whole)``: ``split`` for the column-parallel products
    (their dX partials reduce-scattered in the backward), ``whole`` for
    the products every rank computes whole."""
    return _GatherFromSequence.apply(x)


def into_split(x: torch.Tensor, seq: bool):
    """``x`` as the column-parallel products read it, and as the products
    every rank computes whole read it: ``(copy_to_model(x), x)``, or with
    ``seq`` (``x`` the rank's rows) ``gather_from_sequence``'s two
    aliases of the whole sequence."""
    return gather_from_sequence(x) if seq else (copy_to_model(x), x)


def reduce_scatter_to_sequence(y: torch.Tensor) -> torch.Tensor:
    """The rank's rows of the logical output of a row-parallel product
    from the rank's partial (B, S, ...)."""
    return _ReduceScatterToSequence.apply(y)


def scatter_to_sequence(t: torch.Tensor) -> torch.Tensor:
    """The rank's rows of ``t`` (B, S, ...), whole on every rank of the
    model group."""
    return _ScatterToSequence.apply(t)


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
# Causal depthwise conv1d (the Mamba frontend)
# =========================================================================

def _conv_digits(m: torch.Tensor):
    """Balanced base-2^8 digit planes of an integer mantissa tensor, int32:
    ``m = hi * 256 + lo`` with ``|lo| <= 128``, ``|hi| <= 128`` for 16-bit
    mantissas (``hi`` identically zero for 8-bit)."""
    m32 = m.to(torch.int32)
    lo = ((m32 + 128) & 255) - 128
    return (m32 - lo) >> 8, lo


def _shift_front(t: torch.Tensor, n: int) -> torch.Tensor:
    """(B, L, C) -> (B, n + L, C) with ``n`` zero rows in front."""
    return torch.cat([t.new_zeros((t.shape[0], n, t.shape[2])), t], dim=1)


def _shift_back(t: torch.Tensor, n: int) -> torch.Tensor:
    """(B, L, C) -> (B, L + n, C) with ``n`` zero rows behind."""
    return torch.cat([t, t.new_zeros((t.shape[0], n, t.shape[2]))], dim=1)


def _hi(digits, bits: int):
    """The high digit plane, or None where the mantissas fit 8 bits
    (``|m| <= 127``: the plane is identically zero and its products add
    exact zeros)."""
    return digits[0] if bits > 8 else None


def _digit_correlate(a: torch.Tensor, wh, wl: torch.Tensor) -> torch.Tensor:
    """``Σ_k a[:, l + k] · w[k]`` over the K-row windows of ``a`` (B, L +
    K - 1, C), ``w`` (K, C) given as its digit planes (``wh`` None: zero):
    each digit's K products summed exactly in integers, the two combined
    in f32 with one rounding."""
    win = a.unfold(1, wl.shape[0], 1)                     # (B, L, C, K)
    acc = (win * wl.t()).sum(-1).to(torch.float32)
    if wh is not None:
        acc = (win * wh.t()).sum(-1).to(torch.float32) * 256.0 + acc
    return acc


class _IntDwConv(torch.autograd.Function):
    """Integer causal depthwise conv: K shifted elementwise products of the
    act-bit mantissas of x and the weight-bit mantissas of w.  Residuals:
    both mantissas and their exponents."""

    @staticmethod
    def forward(ctx, x, w, key, cfg: QuantConfig, split: bool):
        K = w.shape[0]
        with dfx.split(split):
            qx = dfx.quantize(x, cfg.act_bits, u=_act_noise(x, cfg, key))
            qw = dfx.quantize(w, cfg.weight_bits)
        # w split into base-2^8 digits: every integer partial stays below
        # 2^(b_act - 1) · 2^7 · K, where one f32 sum would round past 2^24
        wd = _conv_digits(qw.m)
        acc = _digit_correlate(_shift_front(qx.m.to(torch.int32), K - 1),
                               _hi(wd, cfg.weight_bits), wd[1])
        ctx.save_for_backward(qx.m, qx.exp, qw.m, qw.exp)
        ctx.cfg, ctx.key, ctx.split = cfg, key, split
        return acc * dfx.pow2(qx.exp + qw.exp)

    @staticmethod
    def backward(ctx, g):
        xm, x_exp, wm, w_exp = ctx.saved_tensors
        cfg = ctx.cfg
        K = wm.shape[0]
        with dfx.split(ctx.split):
            qg = _quant_grad(g, cfg, ctx.key)
        gm = qg.m.to(torch.int32)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dx[l] = Σ_k g[l + K-1-k] · w[k]: a correlation with w's taps
            # reversed, w digit-split
            wd = [d.flip(0) for d in _conv_digits(wm)]
            dx = _digit_correlate(_shift_back(gm, K - 1),
                                  _hi(wd, cfg.weight_bits), wd[1]) \
                * dfx.pow2(qg.exp + w_exp)
        if ctx.needs_input_grad[1]:
            # dw[k] = Σ_{b,l} x[l - (K-1-k)] · g[l] over B·L: both operands
            # digit-split, each plane's integer sum bounded by 2^14 · B·L
            # (exact to B·L = 2^17 in the reference's int32), combined in
            # f32 with the planes weighted 65536 / 256 / 256 / 1
            xd = [_shift_front(d, K - 1).unfold(1, K, 1)   # (B, L, C, K)
                  for d in _conv_digits(xm)]
            xh, xl = _hi(xd, cfg.act_bits), xd[1]
            gd = _conv_digits(gm)
            gh, gl = _hi(gd, cfg.grad_bits), gd[1]

            def plane(a, b):
                if a is None or b is None:
                    return 0.0
                return (a * b[..., None]).sum(dim=(0, 1)).t().to(
                    torch.float32)
            dwm = (plane(xh, gh) * 65536.0
                   + (plane(xh, gl) + plane(xl, gh)) * 256.0
                   + plane(xl, gl))
            dw = dwm * dfx.pow2(x_exp + qg.exp)
        return dx, dw, None, None, None


def int_conv1d_depthwise(x: torch.Tensor, w: torch.Tensor, key,
                         cfg: QuantConfig, *, split: bool = False
                         ) -> torch.Tensor:
    """Causal depthwise conv1d with integer forward and backward.
    x: (B, L, D), w: (K, D) -> (B, L, D); ``y[l] = Σ_k x[l - (K-1-k)] ·
    w[k]``, zeros before the start.

    A sum of K shifted elementwise integer products (plain PyTorch integer
    tensor code, as the reference leaves it to XLA; only the two
    quantizations run in the quantize kernel).  The weight's mantissas are
    split into balanced base-2^8 digits so every int32 partial is exact;
    the digit sums are combined in f32 with one rounding, times
    ``2^(ex + ew)``.  The backward quantizes the upstream gradient once at
    ``grad_bits``: dx by correlation with w digit-split, dw with both
    operands digit-split (four planes weighted 65536 / 256 / 256 / 1, each
    an int32 reduction over B·L).  ``stochastic_fwd`` with a key rounds
    x's quantization stochastically (the activation noise drawn first, the
    gradient's in the backward).  With ``cfg.enabled`` False: the FP32
    pad-and-sum.  ``split`` (tensor parallelism): ``x`` and ``w`` are the
    rank's channels of the logical tensors (the conv is per channel, so
    local), and x's, w's and the gradient's quantizes take the logical
    tensor's exponent."""
    K = w.shape[0]
    if not cfg.enabled:
        pads = _shift_front(x, K - 1)
        return sum(pads[:, k:k + x.shape[1], :] * w[k] for k in range(K))
    return _IntDwConv.apply(x, w, key, cfg, split)


# =========================================================================
# Batched (per-expert) linear
# =========================================================================

class _IntBatchedLinear(torch.autograd.Function):
    """``y[e] = x[e] @ w[e]`` with one DFX scale per expert.  Residuals: the
    plane-major activation and weight planes and their (E, 1, 1)
    exponents."""

    @staticmethod
    def forward(ctx, x, w, key, cfg: QuantConfig,
                split: Optional[str] = None):
        with dfx.split(split == "row"):
            qx = dfx.quantize_stacked(
                x, cfg.act_bits, u=_act_noise(x, cfg, key, stacked=True),
                limb_planes=True)
        with dfx.split(split is not None):
            qw = dfx.quantize_stacked(w, cfg.weight_bits, limb_planes=True)
        y = kops.dfx_matmul_tiled_batched(qx.m, qx.exp, cfg.act_bits, qw.m,
                                          qw.exp, cfg.weight_bits)
        ctx.save_for_backward(qx.m, qx.exp, qw.m, qw.exp)
        ctx.cfg, ctx.key, ctx.split = cfg, key, split
        return y

    @staticmethod
    def backward(ctx, g):
        xm, x_exp, wm, w_exp = ctx.saved_tensors
        cfg = ctx.cfg
        u = None
        if cfg.stochastic_grad and ctx.key is not None:
            u = dfx.uniform(ctx.key, g.shape, g.device)   # the whole stack
        with dfx.split(ctx.split == "col"):
            qg = dfx.quantize_stacked(g, cfg.grad_bits, u=u,
                                      limb_planes=True)
        gb = cfg.grad_bits
        dx = dw = None
        # one batched launch per direction covers every expert and limb pair
        if ctx.needs_input_grad[0]:
            dx = kops.dfx_matmul_tiled_batched_nt(qg.m, qg.exp, gb, wm, w_exp,
                                                  cfg.weight_bits)
        if ctx.needs_input_grad[1]:
            dw = kops.dfx_matmul_tiled_batched_tn(xm, x_exp, cfg.act_bits,
                                                  qg.m, qg.exp, gb)
        return dx, dw, None, None, None


def int_batched_linear(x: torch.Tensor, w: torch.Tensor, key,
                       cfg: QuantConfig, *,
                       split: Optional[str] = None) -> torch.Tensor:
    """``y[e] = x[e] @ w[e]`` with integer forward and backward and a DFX
    scale per expert.  x: (E, C, K), w: (E, K, N) -> (E, C, N).

    Forward: x and w quantized per expert (grouped quantize launches), one
    batched NN launch.  Backward: the upstream gradient quantized per
    expert at ``grad_bits`` (stochastically from ``key``, one draw over the
    stack), then one batched NT launch (dX) and one TN launch (dW).  With
    ``cfg.enabled`` False: FP32 einsums.  ``split``: as ``int_linear``'s,
    over each expert's inner width (the per-expert scales MAX-reduced over
    the model group as a vector)."""
    if cfg.enabled:
        y = _IntBatchedLinear.apply(x, w, key, cfg, split)
    else:
        y = torch.einsum("eck,ekn->ecn", x, w)
    return reduce_from_model(y) if split == "row" else y


# =========================================================================
# Embedding
# =========================================================================

def _vocab_rows(ids: torch.Tensor, start: int, n: int):
    """The rows of a vocabulary shard ``[start, start + n)`` that ``ids``
    name (clamped into the shard) and whether each id lies inside it."""
    local = ids.long() - start
    return local.clamp(0, n - 1), (local >= 0) & (local < n)


class _IntEmbedding(torch.autograd.Function):
    """Lookup from the quantized table; the backward scatter-adds the
    dequantized, grad-bit quantized gradient into a zero table.  With
    ``start`` the table is the rank's vocabulary shard from row
    ``start``: ids outside it look up zeros and add nothing."""

    @staticmethod
    def forward(ctx, table, ids, key, cfg: QuantConfig, start):
        with dfx.split(start is not None):
            qt = dfx.quantize(table, cfg.weight_bits)
        inside = None
        if start is not None:
            ids, inside = _vocab_rows(ids, start, table.shape[0])
        out = qt.m[ids].to(torch.float32) * dfx.pow2(qt.exp)
        if inside is not None:
            out = torch.where(inside[..., None], out, 0.0)
        ctx.save_for_backward(ids, inside)
        ctx.cfg, ctx.key, ctx.table_shape = cfg, key, tuple(table.shape)
        return out

    @staticmethod
    def backward(ctx, g):
        ids, inside = ctx.saved_tensors
        gq = dfx.dequantize(_quant_grad(g, ctx.cfg, ctx.key))
        D = ctx.table_shape[-1]
        dt = torch.zeros(ctx.table_shape, dtype=torch.float32,
                         device=g.device)
        ids, gq = ids.reshape(-1), gq.reshape(-1, D)
        if inside is not None:
            # an id outside the shard (clamped into it) adds +0.0: the sums
            # are those of the ids inside, and no shape depends on the data
            gq = torch.where(inside.reshape(-1, 1), gq, 0.0)
        dt.index_add_(0, ids, gq)
        return dt, None, None, None, None


def int_embedding(table: torch.Tensor, ids: torch.Tensor, key,
                  cfg: QuantConfig, *,
                  vocab_start: Optional[int] = None,
                  seq: bool = False) -> torch.Tensor:
    """Embedding lookup from the b-bit quantized table: gather the integer
    mantissas, then the inverse mapping (no activation to round
    stochastically: ``stochastic_fwd`` leaves it as the reference does).

    ``vocab_start`` (tensor parallelism): ``table`` is the rank's shard of
    the vocabulary from that row, quantized at the logical table's
    exponent; each rank looks up the ids in its shard, zeros elsewhere,
    and the rows are SUMmed over the model group (one non-zero term: the
    logical lookup exactly); with ``seq`` reduce-scattered, the rank
    keeping its rows of the sequence."""
    if cfg.enabled and cfg.int_embedding:
        y = _IntEmbedding.apply(table, ids, key, cfg, vocab_start)
    elif vocab_start is None:
        return table[ids]
    else:
        rows, inside = _vocab_rows(ids, vocab_start, table.shape[0])
        y = torch.where(inside[..., None], table[rows], 0.0)
    if vocab_start is None:
        return y
    return reduce_scatter_to_sequence(y) if seq else reduce_from_model(y)


# =========================================================================
# Layer norm (and RMS norm)
# =========================================================================

class _IntLayerNorm(torch.autograd.Function):
    """Layer-norm over the act-bit mantissas through the fused kernels.
    The residuals are the mantissas, the dequantized γ and the (mu, rstd)
    the forward kernel normalised with; the backward kernel rebuilds xn
    from them, so it differentiates exactly the forward that ran."""

    @staticmethod
    def forward(ctx, x, gamma, beta, key, cfg: QuantConfig, eps: float,
                seq: bool):
        with dfx.split(seq):
            xq = dfx.quantize(x, cfg.act_bits,
                              u=_act_noise(x, cfg, key, seq=seq))
        gv = dfx.dequantize(dfx.quantize(gamma, cfg.weight_bits))
        D = x.shape[-1]
        xm = xq.m.reshape(-1, D)
        y, mu, rstd = int_norm.int_layernorm_fwd(
            xm, xq.exp, gv, beta, eps=eps, integer_rsqrt=_kept_int(cfg))
        ctx.save_for_backward(xm, xq.exp, gv, mu, rstd)
        ctx.cfg, ctx.key, ctx.seq = cfg, key, seq
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        xm, x_exp, gv, mu, rstd = ctx.saved_tensors
        qg = _quant_grad(g, ctx.cfg, ctx.key, seq=ctx.seq)
        dx, dgamma, dbeta = int_norm.int_layernorm_bwd(
            xm, qg.m.reshape(xm.shape), x_exp, qg.exp, gv, mu, rstd)
        return dx.reshape(g.shape), dgamma, dbeta, None, None, None, None


def _seq_leaf(p: torch.Tensor, seq: bool) -> torch.Tensor:
    """A whole leaf a norm applies to the rank's rows (``seq``): its
    partial gradient SUMmed over the model group."""
    return copy_to_model(p, "sp_leaf") if seq else p


def int_layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  key, cfg: QuantConfig, eps: float = 1e-5, *,
                  seq: bool = False) -> torch.Tensor:
    """Layer-norm with integer statistics forward and backward (the
    weight-bit fake-quantized γ; β stays FP32, the rsqrt too unless
    ``kept_ops="integer"``).  ``seq``: ``x`` is the rank's rows of a
    sequence-sharded tensor (the module docstring)."""
    gamma, beta = _seq_leaf(gamma, seq), _seq_leaf(beta, seq)
    if cfg.enabled and cfg.int_layernorm:
        return _IntLayerNorm.apply(x, gamma, beta, key, cfg, eps, seq)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * gamma + beta


class _IntRmsNorm(torch.autograd.Function):
    """RMS-norm over the act-bit mantissas through the fused kernels.  The
    residuals are the mantissas and their exponent, the dequantized γ and
    the rstd the forward kernel normalised with."""

    @staticmethod
    def forward(ctx, x, gamma, key, cfg: QuantConfig, eps: float,
                seq: bool):
        with dfx.split(seq):
            xq = dfx.quantize(x, cfg.act_bits,
                              u=_act_noise(x, cfg, key, seq=seq))
        gv = dfx.dequantize(dfx.quantize(gamma, cfg.weight_bits))
        D = x.shape[-1]
        xm = xq.m.reshape(-1, D)
        y, rstd = kops.rmsnorm(xm, xq.exp, gv, eps=eps,
                               integer_rsqrt=_kept_int(cfg))
        ctx.save_for_backward(xm, xq.exp, gv, rstd)
        ctx.cfg, ctx.key, ctx.seq = cfg, key, seq
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        xm, x_exp, gv, rstd = ctx.saved_tensors
        qg = _quant_grad(g, ctx.cfg, ctx.key, seq=ctx.seq)
        dx, dgamma = kops.rmsnorm_bwd(xm, x_exp, qg.m.reshape(xm.shape),
                                      qg.exp, gv, rstd)
        return dx.reshape(g.shape), dgamma, None, None, None, None


def int_rmsnorm(x: torch.Tensor, gamma: torch.Tensor, key, cfg: QuantConfig,
                eps: float = 1e-6, *, seq: bool = False) -> torch.Tensor:
    """RMS-norm over the act-bit mantissas of ``x`` with the weight-bit
    fake-quantized ``gamma``, through the integer RMS-norm kernels forward
    and backward.  ``seq``: ``x`` is the rank's rows of a sequence-sharded
    tensor (the module docstring)."""
    gamma = _seq_leaf(gamma, seq)
    if cfg.enabled and cfg.int_layernorm:
        return _IntRmsNorm.apply(x, gamma, key, cfg, eps, seq)
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
    """max over rows of ‖x_row‖₂ along the trailing (head) dim: f32 0-d
    (under a mesh over every rank's rows, ``dfx.global_max``)."""
    return dfx.global_max(torch.sqrt(torch.amax(torch.sum(
        torch.square(x.float()), dim=-1))))


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
                cfg_pv: QuantConfig, causal: bool, window, split: bool):
        # q, k, v noise in that order (the reference's split of its key);
        # all three follow cfg_qk.stochastic_fwd, as there
        with dfx.split(split):
            qq, qk, qv = (dfx.quantize(t, bits, u=_act_noise(t, cfg_qk, key),
                                       limb_planes=True)
                          for t, bits in ((q, cfg_qk.act_bits),
                                          (k, cfg_qk.act_bits),
                                          (v, cfg_pv.act_bits)))
            v_norm = (_max_row_norm(v) if any(ctx.needs_input_grad[:3])
                      else None)
        iexp = _kept_int(cfg_qk)
        o, lse = kops.attention_fwd(qq.m, qq.exp, qk.m, qk.exp, qv.m, qv.exp,
                                    off, cfg_pv.act_bits, causal=causal,
                                    window=window, integer_exp=iexp)
        ctx.save_for_backward(qq.m, qq.exp, qk.m, qk.exp, qv.m, qv.exp, o,
                              lse, v_norm, off)
        ctx.cfg_qk, ctx.cfg_pv, ctx.key = cfg_qk, cfg_pv, key
        ctx.causal, ctx.window, ctx.iexp = causal, window, iexp
        ctx.split = split
        return o

    @staticmethod
    def backward(ctx, g):
        qm, q_exp, km, k_exp, vm, v_exp, o, lse, v_norm, off = \
            ctx.saved_tensors
        cfg_qk, cfg_pv = ctx.cfg_qk, ctx.cfg_pv
        with dfx.split(ctx.split):
            qg = _quant_grad(g, cfg_pv, ctx.key, limb_planes=True)
            g_norm = _max_row_norm(g)
        # delta = rowsum(dO ∘ o) over the RAW upstream gradient (a kept op)
        delta = torch.sum(g * o, dim=-1)                      # (B, Sq, KV, G)
        ds_bits = cfg_qk.grad_bits
        ds_exp = _ds_exp(g_norm, v_norm, ds_bits)
        dq, dk, dv = kops.attention_bwd(
            qm, q_exp, km, k_exp, vm, v_exp, qg.m, qg.exp, lse, delta,
            ds_exp, off, cfg_pv.act_bits, ds_bits, causal=ctx.causal,
            window=ctx.window, integer_exp=ctx.iexp)
        return dq, dk, dv, None, None, None, None, None, None, None


def int_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_offset, key, cfg_qk: QuantConfig, cfg_pv: QuantConfig,
                  causal: bool, window: Optional[int], *,
                  split: bool = False) -> torch.Tensor:
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
    ``split`` (tensor parallelism): q / k / v are the rank's heads of the
    logical tensors, every exponent and dS's row-norm bound the logical
    tensor's.
    """
    B = q.shape[0]
    off = torch.as_tensor(q_offset, device=q.device).to(torch.int32)
    off = torch.broadcast_to(off.reshape(-1), (B,)).contiguous()
    return _IntAttention.apply(q, k, v, off, key, cfg_qk, cfg_pv, causal,
                               window, split)
