"""Integer flash attention over int8 limb planes, forward and backward.

Counterpart of ``repro/kernels/int_attention.py::int_attn_fwd``,
``int_attn_bwd_dq`` and ``int_attn_bwd_dkv``; the CUDA kernels are
``csrc/int_attention.cu`` (forward) and ``csrc/int_attention_bwd.cu``.
Forward, per 128-wide block of keys (the
reference's online-softmax update width, which is part of the result
because P is quantized against the running max):

    s     = sc · Σ_pairs (f32(q_limb · k_limb) · 2^(qe+ke)) · 2^(7(ja+jb))
    s     = where(ok, s, -1e30)
    m_new = max(m, rowmax(s));  p = where(ok, exp(s - m_new), 0)
    l     = l · exp(m - m_new) + rowsum(p)
    acc   = acc · exp(m - m_new)
            + Σ_pairs (f32(pm_limb · v_limb) · 2^ve) · 2^(7(ja+jb) - (pb-1))
    o = acc / max(l, 1e-20),  lse = m + log(max(l, 1e-37))

with ``pm = clip(round(p · 2^(pb-1)))`` split into limb planes and
``ok = kpos < Sk ∧ (causal: kpos ≤ q_off[b] + i) ∧ (window: kpos >
q_off[b] + i - window)``.  Planes are in the model layout: q
``(Lq, B, Sq, KV, G, hd)``, k/v ``(L, B, Sk, KV, hd)``; outputs o
``(B, Sq, KV, G, hd)`` and lse ``(B, KV, G, Sq)``.

Backward (flash-attention-2 form), from the quantized upstream gradient's
planes g (q's layout), lse and ``delta = rowsum(dO·o)`` (B, Sq, KV, G):

    p   = where(ok, exp(s - lse), 0)
    dp  = Σ_pairs (f32(g_limb · v_limb) · 2^(ge+ve)) · 2^(7(ja+jb))
    dsm = clip(round((p · (dp - delta)) · 2^-dse))     at ds_bits
    dq  = sc · Σ_128-key blocks Σ_pairs (f32(dsm_limb · k_limb)
                                         · 2^(dse+ke)) · 2^(7(ja+jb))
    dv  = Σ_q blocks Σ_pairs (f32(pmᵀ_limb · g_limb) · 2^ge)
                             · 2^(7(ja+jb) - (pb-1))
    dk  = sc · Σ_q blocks Σ_pairs (f32(dsmᵀ_limb · q_limb) · 2^(dse+qe))
                                  · 2^(7(ja+jb))

with ``pm`` the forward's P mantissa.  The f32 sums run over the
reference's blocks: 128 keys for dq, ``bq`` query rows of each group head
in turn (group-major) for dk and dv, which for GQA are the sums over the
G query heads of a kv head.  Outputs dq in q's model layout, dk and dv
``(B, Sk, KV, hd)`` f32.
"""
from __future__ import annotations

import torch

from repro_torch.core.dfx import pow2
from repro_torch.kernels import _lib
from repro_torch.kernels.dfx_quant import LIMB_BITS, n_limbs, split_planes

#: keys per online-softmax update (the reference kernel's bk)
BLOCK_K = 128
_BIG_NEG = -1e30


def q_block(Sq: int) -> int:
    """The reference's query block ``bq``: ``min(128, Sq rounded up to
    8)`` rows (its f32 dk / dv sums run over blocks of this many rows)."""
    return min(128, -(-Sq // 8) * 8)


def _limb_sum(a, b, eq: str, s0, shift: int = 0):
    """Σ over limb pairs of ``einsum(eq, a[ja], b[jb])`` (float64, exact
    integer dots), combined in f32 as the kernels do:
    ``(f32(dot) · s0) · 2^(7(ja+jb) + shift)`` summed in pair order."""
    out = None
    for ja, pa in enumerate(a):
        for jb, pb in enumerate(b):
            part = torch.einsum(eq, pa.to(torch.float64),
                                pb.to(torch.float64))
            part = (part.to(torch.float32) * s0) * float(
                2.0 ** (LIMB_BITS * (ja + jb) + shift))
            out = part if out is None else out + part
    return out


def _mask(qpos, kpos, Sk: int, causal: bool, window):
    """Validity of (query position, key position) pairs: qpos (..., Sq, 1),
    kpos (Sk',)."""
    ok = (kpos < Sk) & torch.ones_like(qpos, dtype=torch.bool)
    if causal:
        ok = ok & (kpos <= qpos)
    if window is not None:
        ok = ok & (kpos > qpos - window)
    return ok


def _round_clip(y, bits: int):
    lim = float(2 ** (bits - 1) - 1)
    return torch.clamp(torch.round(y), -lim, lim)


def int_attn_fwd_plain(qm, km, vm, q_off, exps, *, p_bits: int,
                       causal: bool, window: int | None, sc: float):
    """Plain PyTorch version: the same blocked recurrence, vectorized over
    (B, KV, G, Sq); integer limb dots in float64 (exact), then the ordered
    f32 combines."""
    Lq, B, Sq, KV, G, hd = qm.shape
    Sk = km.shape[2]
    dev = qm.device
    s0 = pow2(exps[0] + exps[1])
    ve = pow2(exps[2])
    sc = torch.tensor(sc, dtype=torch.float32)
    q = qm.to(torch.float64)
    k = km.to(torch.float64)
    v = vm.to(torch.float64)
    qpos = q_off.to(dev).reshape(B, 1) + torch.arange(Sq, device=dev)
    lim = float(2 ** (p_bits - 1) - 1)
    m = torch.full((B, KV, G, Sq, 1), _BIG_NEG, device=dev)
    l = torch.zeros((B, KV, G, Sq, 1), device=dev)
    acc = torch.zeros((B, KV, G, Sq, hd), device=dev)
    for k0 in range(0, Sk, BLOCK_K):
        kb = k[:, :, k0:k0 + BLOCK_K]
        vb = v[:, :, k0:k0 + BLOCK_K]
        kpos = k0 + torch.arange(kb.shape[2], device=dev)
        ok = (kpos < Sk).expand(B, Sq, -1)
        if causal:
            ok = ok & (kpos <= qpos[:, :, None])
        if window is not None:
            ok = ok & (kpos > qpos[:, :, None] - window)
        ok = ok[:, None, None]                           # (B, 1, 1, Sq, ck)
        s = None
        for ja in range(Lq):
            for jb in range(km.shape[0]):
                part = torch.einsum("bqhgd,bkhd->bhgqk", q[ja], kb[jb])
                part = (part.to(torch.float32) * s0) * float(
                    2 ** (LIMB_BITS * (ja + jb)))
                s = part if s is None else s + part
        s = torch.where(ok, s * sc, _BIG_NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(ok, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        pm = torch.clamp(torch.round(p * float(2 ** (p_bits - 1))), -lim, lim)
        pv = None
        for ja, plane in enumerate(split_planes(pm, n_limbs(p_bits))):
            for jb in range(vm.shape[0]):
                part = torch.einsum("bhgqk,bkhd->bhgqd",
                                    plane.to(torch.float64), vb[jb])
                part = (part.to(torch.float32) * ve) * float(
                    2.0 ** (LIMB_BITS * (ja + jb) - (p_bits - 1)))
                pv = part if pv is None else pv + part
        acc = acc * alpha + pv
        m = m_new
    o = (acc / torch.clamp(l, min=1e-20)).permute(0, 3, 1, 2, 4)
    lse = (m + torch.log(torch.clamp(l, min=1e-37)))[..., 0]
    return o.contiguous(), lse


def _launch(lib, qm, km, vm, q_off, exps, p_bits, causal, window, sc,
            stream):
    Lq, B, Sq, KV, G, hd = qm.shape
    Sk = km.shape[2]
    o = torch.empty((B, Sq, KV, G, hd), dtype=torch.float32, device=qm.device)
    lse = torch.empty((B, KV, G, Sq), dtype=torch.float32, device=qm.device)
    err = lib.int_attn_fwd_launch(
        qm.data_ptr(), km.data_ptr(), vm.data_ptr(), q_off.data_ptr(),
        exps.data_ptr(), o.data_ptr(), lse.data_ptr(), B, Sq, Sk, KV, G, hd,
        Lq, vm.shape[0], p_bits, int(causal),
        -1 if window is None else int(window), float(sc), stream)
    _lib.check(err, "int_attn_fwd")
    int_attn_fwd.launches += 1
    return o, lse


def int_attn_fwd(qm: torch.Tensor, km: torch.Tensor, vm: torch.Tensor,
                 q_off: torch.Tensor, exps: torch.Tensor, *, p_bits: int,
                 causal: bool, window: int | None, sc: float):
    """Fused forward ``(o, lse)``.  q_off: (B,) int32 query offsets; exps:
    (3,) int32 [q_exp, k_exp, v_exp].  CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    Lq, B, Sq, KV, G, hd = qm.shape
    if (km.dim() != 5 or km.shape[1] != B or km.shape[3:] != (KV, hd)
            or vm.shape[1:] != km.shape[1:]):
        raise ValueError(f"int_attn_fwd shapes {tuple(qm.shape)}, "
                         f"{tuple(km.shape)}, {tuple(vm.shape)}")
    if km.shape[0] != Lq or vm.shape[0] != n_limbs(p_bits):
        raise ValueError("q/k planes share one limb count; v's must be "
                         "n_limbs(p_bits)")
    if not (1 <= Lq <= 3 and 1 <= vm.shape[0] <= 3):
        raise ValueError("int_attn_fwd supports 1..3 limb planes")
    if qm.device.type == "cpu":
        return int_attn_fwd_plain(qm, km, vm, q_off, exps, p_bits=p_bits,
                                  causal=causal, window=window, sc=sc)
    if qm.device.type != "cuda":
        raise ValueError(f"int_attn_fwd: unsupported device {qm.device}")
    dev = qm.device
    q_off = q_off.to(device=dev, dtype=torch.int32).contiguous()
    exps = exps.to(device=dev, dtype=torch.int32).contiguous()
    return _launch(_lib.load(), qm.contiguous(), km.contiguous(),
                   vm.contiguous(), q_off, exps, p_bits, causal, window, sc,
                   _lib.stream_of(qm))


int_attn_fwd.launches = 0


def int_attn_bwd_dq_plain(qm, km, vm, gm, lse, delta, q_off, exps, *,
                          ds_bits: int, causal: bool, window: int | None,
                          sc: float):
    """Plain PyTorch version of the dq kernel: the same 128-key blocked
    recurrence, vectorized over (B, KV, G, Sq)."""
    Lq, B, Sq, KV, G, hd = qm.shape
    Sk = km.shape[2]
    dev = qm.device
    s0 = pow2(exps[0] + exps[1])
    sdp = pow2(exps[3] + exps[2])
    sdq = pow2(exps[4] + exps[1])
    inv_ds = pow2(-exps[4])
    sc = torch.tensor(sc, dtype=torch.float32)
    qpos = (q_off.to(dev).reshape(B, 1) + torch.arange(Sq, device=dev)
            )[:, None, None, :, None]                     # (B, 1, 1, Sq, 1)
    lse_r = lse[..., None]                                # (B, KV, G, Sq, 1)
    del_r = delta.permute(0, 2, 3, 1)[..., None]
    acc = torch.zeros((B, KV, G, Sq, hd), device=dev)
    for k0 in range(0, Sk, BLOCK_K):
        kb = km[:, :, k0:k0 + BLOCK_K]
        vb = vm[:, :, k0:k0 + BLOCK_K]
        ok = _mask(qpos, k0 + torch.arange(kb.shape[2], device=dev), Sk,
                   causal, window)
        s = _limb_sum(qm, kb, "bqhgd,bkhd->bhgqk", s0)
        s = torch.where(ok, s * sc, _BIG_NEG)
        p = torch.where(ok, torch.exp(s - lse_r), 0.0)
        dp = _limb_sum(gm, vb, "bqhgd,bkhd->bhgqk", sdp)
        dsm = _round_clip((p * (dp - del_r)) * inv_ds, ds_bits)
        acc = acc + _limb_sum(split_planes(dsm, n_limbs(ds_bits)), kb,
                              "bhgqk,bkhd->bhgqd", sdq)
    return (acc * sc).permute(0, 3, 1, 2, 4).contiguous()


def int_attn_bwd_dkv_plain(qm, km, vm, gm, lse, delta, q_off, exps, *,
                           p_bits: int, ds_bits: int, causal: bool,
                           window: int | None, sc: float):
    """Plain PyTorch version of the dk / dv kernel: the same recurrence
    over blocks of ``q_block(Sq)`` query rows, group head by group head,
    vectorized over (B, KV, Sk).  Returns ``(dk, dv)``."""
    Lq, B, Sq, KV, G, hd = qm.shape
    Sk = km.shape[2]
    dev = qm.device
    s0 = pow2(exps[0] + exps[1])
    sdp = pow2(exps[3] + exps[2])
    sdk = pow2(exps[4] + exps[0])
    sdv = pow2(exps[3])
    inv_ds = pow2(-exps[4])
    sc = torch.tensor(sc, dtype=torch.float32)
    kpos = torch.arange(Sk, device=dev)
    bq = q_block(Sq)
    dk = torch.zeros((B, KV, Sk, hd), device=dev)
    dv = torch.zeros((B, KV, Sk, hd), device=dev)
    for g in range(G):
        for q0 in range(0, Sq, bq):
            qb = qm[:, :, q0:q0 + bq, :, g]               # (L, B, nr, KV, hd)
            gb = gm[:, :, q0:q0 + bq, :, g]
            nr = qb.shape[2]
            qpos = (q_off.to(dev).reshape(B, 1)
                    + torch.arange(q0, q0 + nr, device=dev))[:, None, :, None]
            ok = _mask(qpos, kpos, Sk, causal, window)   # (B, 1, nr, Sk)
            s = _limb_sum(qb, km, "bqhd,bkhd->bhqk", s0)
            s = torch.where(ok, s * sc, _BIG_NEG)
            lse_b = lse[:, :, g, q0:q0 + nr, None]        # (B, KV, nr, 1)
            p = torch.where(ok, torch.exp(s - lse_b), 0.0)
            pm = _round_clip(p * float(2 ** (p_bits - 1)), p_bits)
            dv = dv + _limb_sum(split_planes(pm, n_limbs(p_bits)), gb,
                                "bhqk,bqhd->bhkd", sdv, -(p_bits - 1))
            dp = _limb_sum(gb, vm, "bqhd,bkhd->bhqk", sdp)
            del_b = delta[:, q0:q0 + nr, :, g].permute(0, 2, 1)[..., None]
            dsm = _round_clip((p * (dp - del_b)) * inv_ds, ds_bits)
            dk = dk + _limb_sum(split_planes(dsm, n_limbs(ds_bits)), qb,
                                "bhqk,bqhd->bhkd", sdk)
    return ((dk * sc).permute(0, 2, 1, 3).contiguous(),
            dv.permute(0, 2, 1, 3).contiguous())


def _check_bwd(name, qm, km, vm, gm, lse, delta, p_bits, ds_bits):
    Lq, B, Sq, KV, G, hd = qm.shape
    Sk = km.shape[2]
    if (km.dim() != 5 or km.shape[1] != B or km.shape[3:] != (KV, hd)
            or vm.shape[1:] != km.shape[1:] or gm.shape[1:] != qm.shape[1:]
            or lse.shape != (B, KV, G, Sq) or delta.shape != (B, Sq, KV, G)):
        raise ValueError(f"{name} shapes q {tuple(qm.shape)}, k "
                         f"{tuple(km.shape)}, v {tuple(vm.shape)}, g "
                         f"{tuple(gm.shape)}, lse {tuple(lse.shape)}, delta "
                         f"{tuple(delta.shape)}")
    if km.shape[0] != Lq or vm.shape[0] != n_limbs(p_bits):
        raise ValueError("q/k planes share one limb count; v's must be "
                         "n_limbs(p_bits)")
    if not all(1 <= n <= 3 for n in (Lq, vm.shape[0], gm.shape[0],
                                     n_limbs(ds_bits))):
        raise ValueError(f"{name} supports 1..3 limb planes")
    for t in (qm, km, vm, gm):
        if t.dtype != torch.int8:
            raise TypeError(f"{name} takes int8 limb planes, got {t.dtype}")
    devs = {t.device for t in (qm, km, vm, gm, lse, delta)}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    if qm.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {qm.device}")
    return qm.device.type == "cpu"


def _bwd_args(qm, km, vm, gm, lse, delta, q_off, exps):
    dev = qm.device
    return ([t.contiguous() for t in (qm, km, vm, gm)]
            + [t.to(device=dev, dtype=torch.float32).contiguous()
               for t in (lse, delta)]
            + [t.to(device=dev, dtype=torch.int32).contiguous()
               for t in (q_off, exps)])


def _launch_dq(lib, q, k, v, g, lse, delta, off, exps, ds_bits, causal,
               window, sc, stream):
    Lq, B, Sq, KV, G, hd = q.shape
    dq = torch.empty((B, Sq, KV, G, hd), dtype=torch.float32, device=q.device)
    err = lib.int_attn_bwd_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), off.data_ptr(), exps.data_ptr(),
        dq.data_ptr(), B, Sq, k.shape[2], KV, G, hd, Lq, v.shape[0],
        g.shape[0], n_limbs(ds_bits), ds_bits, int(causal),
        -1 if window is None else int(window), float(sc), stream)
    _lib.check(err, "int_attn_bwd_dq")
    int_attn_bwd_dq.launches += 1
    return dq


def _launch_dkv(lib, q, k, v, g, lse, delta, off, exps, p_bits, ds_bits,
                causal, window, sc, stream):
    Lq, B, Sq, KV, G, hd = q.shape
    Sk = k.shape[2]
    dk = torch.empty((B, Sk, KV, hd), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    err = lib.int_attn_bwd_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), off.data_ptr(), exps.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, Sk, KV, G, hd, Lq, v.shape[0],
        g.shape[0], n_limbs(ds_bits), p_bits, ds_bits, q_block(Sq),
        int(causal), -1 if window is None else int(window), float(sc), stream)
    _lib.check(err, "int_attn_bwd_dkv")
    int_attn_bwd_dkv.launches += 1
    return dk, dv


def int_attn_bwd_dq(qm: torch.Tensor, km: torch.Tensor, vm: torch.Tensor,
                    gm: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                    q_off: torch.Tensor, exps: torch.Tensor, *, p_bits: int,
                    ds_bits: int, causal: bool, window: int | None,
                    sc: float) -> torch.Tensor:
    """Fused dq (B, Sq, KV, G, hd) f32.  gm: the quantized upstream
    gradient's planes in q's layout; lse (B, KV, G, Sq) and delta
    (B, Sq, KV, G) f32; q_off (B,) int32; exps (5,) int32 [q, k, v, g, dS]
    exponents.  CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if _check_bwd("int_attn_bwd_dq", qm, km, vm, gm, lse, delta, p_bits,
                  ds_bits):
        return int_attn_bwd_dq_plain(qm, km, vm, gm, lse, delta, q_off,
                                     exps, ds_bits=ds_bits, causal=causal,
                                     window=window, sc=sc)
    return _launch_dq(_lib.load(), *_bwd_args(qm, km, vm, gm, lse, delta,
                                              q_off, exps), ds_bits, causal,
                      window, sc, _lib.stream_of(qm))


def int_attn_bwd_dkv(qm: torch.Tensor, km: torch.Tensor, vm: torch.Tensor,
                     gm: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                     q_off: torch.Tensor, exps: torch.Tensor, *, p_bits: int,
                     ds_bits: int, causal: bool, window: int | None,
                     sc: float):
    """Fused ``(dk, dv)``, each (B, Sk, KV, hd) f32, summed over the G
    query heads of each kv head.  Arguments as ``int_attn_bwd_dq``.  CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if _check_bwd("int_attn_bwd_dkv", qm, km, vm, gm, lse, delta, p_bits,
                  ds_bits):
        return int_attn_bwd_dkv_plain(qm, km, vm, gm, lse, delta, q_off,
                                      exps, p_bits=p_bits, ds_bits=ds_bits,
                                      causal=causal, window=window, sc=sc)
    return _launch_dkv(_lib.load(), *_bwd_args(qm, km, vm, gm, lse, delta,
                                               q_off, exps), p_bits, ds_bits,
                       causal, window, sc, _lib.stream_of(qm))


int_attn_bwd_dq.launches = 0
int_attn_bwd_dkv.launches = 0
