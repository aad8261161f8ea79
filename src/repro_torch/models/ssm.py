"""Mamba2 (SSD, state-space duality) block with integer projections.

Counterpart of ``repro/models/ssm.py``.  The in / out projections, the
depthwise convs and the gated RMS-norm are integer layers
(``core.int_ops``); the selective-state recurrence (softplus dt, the SSD
scan's exps and einsums) stays FP32, as in the reference (its DESIGN.md
§4): it is the SSM's counterpart of the softmax.  The projections are
separate matrices (z / x / BC / dt), as there.

``ssd_chunked`` is the chunked SSD algorithm (Dao & Gu 2024,
arXiv:2405.21060): the intra-chunk quadratic term, then the inter-chunk
state recurrence, which the reference runs as a ``lax.scan`` and this
port as a Python loop over the chunks; each einsum keeps the reference's
contraction.  ``ssd_decode_step`` is the one-token update of the O(1)
state.  In decode the conv is an FP32 einsum over the concatenated conv
state, not ``int_conv1d_depthwise``, as in the reference.

The reference hands each call site its own ``subkey``; here, as in
``models/blocks.py``, every call site gets the same ``key`` and a
``torch.Generator`` hands each draw the next numbers of its stream.

Under a training step that splits its products over the model group
(``dfx.model``; the reference's rules, which GSPMD applies) each rank
keeps its ``NH / M`` SSD heads end to end: ``wz`` / ``wx`` / ``wdt``
column-parallel behind one ``copy_to_model``, ``conv_x`` on its channels,
the scan on its heads, ``out_proj`` row-parallel.  B and C (one group,
shared by every head) are projected and convolved whole from the plain
input and enter the split region after the conv (``copy_to_model``: the
ranks' partial dB / dC summed).  The gated norm normalises the whole
inner row as the reference's Pallas norm does (a custom call XLA does
not partition along the row): its input is all-gathered over the group
(tag ``tp_norm``), normed at the logical width with ``norm_g`` whole,
and the rank's columns go on (``int_ops.gather_from_model`` /
``scatter_to_model``).  A decode step under a serving mesh
(``sharding.serving``) splits the same way: the rank's conv state holds
its ``DI / M`` channels and its SSM state its heads, the B / C conv state
is whole (``sharding.cache_pspecs``), and the new states are the rank's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import dfx, int_ops
from repro_torch.core.qpolicy import QuantLike, ensure_scope
from repro_torch.models.blocks import _init
from repro_torch.models.config import ArchConfig

Params = Dict[str, Any]


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = Σ_{j < k <= i} x[..., k] as the difference of two
    cumulative sums (the reference's form, not a direct segment sum);
    -inf above the diagonal."""
    Q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    ii = torch.arange(Q, device=x.device)
    mask = ii[:, None] >= ii[None, :]
    return torch.where(mask, diff, torch.full_like(diff, float("-inf")))


def mamba2_init(gen: torch.Generator, cfg: ArchConfig, device,
                lead: Tuple[int, ...] = ()) -> Params:
    """One Mamba2 layer's params (a stack of them with ``lead = (L,)``):
    normal · 0.02 projections, normal · 0.1 conv taps, ``A_log = log(1 ..
    NH)``, zero ``dt_bias``, unit ``D_skip`` and norm gain."""
    D, DI, N, NH = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads

    def rep(v: torch.Tensor) -> torch.Tensor:
        return v.expand(lead + v.shape).contiguous()
    return {
        "wz": _init(gen, lead + (D, DI), device),
        "wx": _init(gen, lead + (D, DI), device),
        "wBC": _init(gen, lead + (D, 2 * N), device),
        "wdt": _init(gen, lead + (D, NH), device),
        "conv_x": _init(gen, lead + (cfg.ssm_conv, DI), device, scale=0.1),
        "conv_BC": _init(gen, lead + (cfg.ssm_conv, 2 * N), device,
                         scale=0.1),
        "A_log": rep(torch.log(torch.arange(1, NH + 1, dtype=torch.float32,
                                            device=device))),
        "dt_bias": torch.zeros(lead + (NH,), device=device),
        "D_skip": torch.ones(lead + (NH,), device=device),
        "norm_g": torch.ones(lead + (DI,), device=device),
        "out_proj": _init(gen, lead + (DI, D), device),
    }


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (FP32).

    x: (b, L, H, P), dt: (b, L, H), A: (H,), B / C: (b, L, N).  Returns
    (y (b, L, H, P), final_state (b, H, P, N))."""
    b, L, H, P = x.shape
    N = B.shape[-1]
    Q = min(chunk, L)
    assert L % Q == 0, (L, Q)
    nc = L // Q
    xr = x.reshape(b, nc, Q, H, P)
    dtr = dt.reshape(b, nc, Q, H)
    Br = B.reshape(b, nc, Q, N)
    Cr = C.reshape(b, nc, Q, N)
    dA = dtr * A[None, None, None, :]                      # (b, nc, Q, H) <= 0
    dA_cs = torch.cumsum(dA, dim=2)

    # intra-chunk (quadratic within the chunk)
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))      # (b, nc, H, Q, Q)
    scores = torch.einsum("bcqn,bckn->bcqk", Cr, Br)
    xdt = xr * dtr[..., None]
    y_diag = torch.einsum("bchqk,bcqk,bckhp->bcqhp", Lmat, scores, xdt)

    # per-chunk end states
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # (b, nc, Q, H)
    states = torch.einsum("bckn,bckh,bckhp->bchpn", Br, decay_states, xdt)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])            # (b, nc, H)
    s = init_state if init_state is not None else torch.zeros(
        (b, H, P, N), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                 # (b, nc, H, P, N)

    state_decay_in = torch.exp(dA_cs)
    y_off = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cr, state_decay_in,
                         prev_states)
    y = (y_diag + y_off).reshape(b, L, H, P)
    return y, s


def ssd_decode_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    A: torch.Tensor, B: torch.Tensor, C: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSD update.  state: (b, H, P, N); x: (b, H, P); dt: (b, H);
    B / C: (b, N).  Returns (new state, y (b, H, P))."""
    dA = torch.exp(dt * A[None, :])
    dBx = torch.einsum("bn,bh,bhp->bhpn", B, dt, x)
    state = state * dA[..., None, None] + dBx
    y = torch.einsum("bn,bhpn->bhp", C, state)
    return state, y


def mamba2_apply(
    p: Params, x: torch.Tensor, cfg: ArchConfig, qcfg: QuantLike, key,
    *,
    state: Optional[Tuple[torch.Tensor, ...]] = None,  # (ssm, conv_x, conv_BC)
    decode: bool = False,
    seq: bool = False,
) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """x: (B, S, D) -> (out, new state).

    Integer: wz / wx / wBC / wdt / out_proj (``int_linear``), the convs
    (``int_conv1d_depthwise``; in decode an FP32 einsum over the conv
    state), the gated norm (``int_rmsnorm``).  The three SiLUs route
    through ``int_ops.int_activation`` at the leaves ``act.{conv_x,
    conv_BC, gate}``.  FP32 by design: softplus dt and the SSD
    recurrence.  In training ``state`` may carry an initial SSM state and
    the new state is ``(final, None, None)``; in decode (S == 1) it is the
    layer's ``(ssm, conv_x, conv_BC)`` and so is the returned one (new
    tensors: the caller writes them into its cache; under a model group
    the rank's heads and conv channels, the B / C conv state whole).
    ``seq`` (under a model group): ``x`` and the output are the rank's rows
    of the
    sequence; the conv and the scan need it whole, so it is gathered once,
    before the projections, and ``out_proj`` reduce-scatters onto the
    rows."""
    DI, N, NH, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    sc = ensure_scope(qcfg)
    act = sc.child("act")
    tp = dfx.model
    A_log, dt_bias, D_skip = p["A_log"], p["dt_bias"], p["D_skip"]
    xc, col = x, None
    if tp is not None:
        # the rank's NH / M heads end to end: z / x / dt column-parallel,
        # the per-head leaves sliced (their gradient gathered back); wBC
        # reads the whole sequence as a product every rank computes
        DI, NH = DI // tp.size, NH // tp.size
        (xc, x), col = int_ops.into_split(x, seq), "col"
        A_log, dt_bias, D_skip = int_ops.tp_heads(
            torch.stack([A_log, dt_bias, D_skip])).unbind(0)
    B_, S, D = x.shape
    z = int_ops.int_linear(xc, p["wz"], None, key, sc.leaf("wz"), split=col)
    xi = int_ops.int_linear(xc, p["wx"], None, key, sc.leaf("wx"), split=col)
    # B / C are shared by every head: from the plain x, whole on each rank
    bc = int_ops.int_linear(x, p["wBC"], None, key, sc.leaf("wBC"))
    dt = int_ops.int_linear(xc, p["wdt"], None, key, sc.leaf("wdt"),
                            split=col)
    dt = F.softplus(dt + dt_bias)
    A = -torch.exp(A_log)

    if decode:
        assert S == 1
        ssm_s, cx_s, cbc_s = state
        cx = torch.cat([cx_s, xi], dim=1)                  # (B, K, DI)
        cbc = torch.cat([cbc_s, bc], dim=1)
        xi = int_ops.int_activation(
            torch.einsum("bkc,kc->bc", cx, p["conv_x"]),
            act.leaf("conv_x"), "silu")[:, None]
        bc = int_ops.int_activation(
            torch.einsum("bkc,kc->bc", cbc, p["conv_BC"]),
            act.leaf("conv_BC"), "silu")[:, None]
        new_cx, new_cbc = cx[:, 1:], cbc[:, 1:]
    else:
        xi = int_ops.int_activation(int_ops.int_conv1d_depthwise(
            xi, p["conv_x"], key, sc.leaf("conv_x"), split=tp is not None),
            act.leaf("conv_x"), "silu")
        bc = int_ops.int_activation(int_ops.int_conv1d_depthwise(
            bc, p["conv_BC"], key, sc.leaf("conv_BC")),
            act.leaf("conv_BC"), "silu")
        if tp is not None:
            # into the split region: the backward SUMs the ranks' partial
            # dB / dC (each from its heads' scan)
            bc = int_ops.copy_to_model(bc)

    xs = xi.reshape(B_, S, NH, P)
    Bmat, Cmat = bc[..., :N], bc[..., N:]

    if decode:
        new_ssm, y = ssd_decode_step(ssm_s, xs[:, 0], dt[:, 0], A,
                                     Bmat[:, 0], Cmat[:, 0])
        y = y[:, None]
        new_state = (new_ssm, new_cx, new_cbc)
    else:
        init = state[0] if state is not None else None
        y, final = ssd_chunked(xs, dt, A, Bmat, Cmat, cfg.ssm_chunk, init)
        new_state = (final, None, None)

    y = y + xs * D_skip[None, None, :, None]
    y = y.reshape(B_, S, DI)
    y = y * int_ops.int_activation(z, act.leaf("gate"), "silu")
    if tp is None:
        y = int_ops.int_rmsnorm(y, p["norm_g"], key, sc.leaf("norm_g"))
        return int_ops.int_linear(y, p["out_proj"], None, key,
                                  sc.leaf("out_proj")), new_state
    # the gated norm normalises the whole inner row: gathered over the
    # model group, normed at the logical width (norm_g whole), the rank's
    # columns into the row-parallel out_proj
    y = int_ops.int_rmsnorm(int_ops.gather_from_model(y, "tp_norm"),
                            p["norm_g"], key, sc.leaf("norm_g"))
    y = int_ops.scatter_to_model(y, "tp_norm")
    return int_ops.int_linear(y, p["out_proj"], None, key,
                              sc.leaf("out_proj"), split="row",
                              seq=seq), new_state


def mamba2_init_state(cfg: ArchConfig, batch: int, device,
                      lead: Tuple[int, ...] = ()) -> Tuple[torch.Tensor, ...]:
    """Zero decode state ``(ssm (b, H, P, N), conv_x (b, K-1, DI), conv_BC
    (b, K-1, 2N))``, FP32 whatever the KV cache's dtype; ``lead`` stacks
    it per layer."""
    K = cfg.ssm_conv
    f = dict(dtype=torch.float32, device=device)
    return (
        torch.zeros(lead + (batch, cfg.ssm_nheads, cfg.ssm_headdim,
                            cfg.ssm_state), **f),
        torch.zeros(lead + (batch, K - 1, cfg.d_inner), **f),
        torch.zeros(lead + (batch, K - 1, 2 * cfg.ssm_state), **f),
    )
