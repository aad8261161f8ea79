"""Integer flash-attention forward over int8 limb planes.

Counterpart of ``repro/kernels/int_attention.py::int_attn_fwd``; the CUDA
kernel is ``csrc/int_attention.cu``.  Per 128-wide block of keys (the
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
"""
from __future__ import annotations

import torch

from repro_torch.core.dfx import pow2
from repro_torch.kernels import _lib
from repro_torch.kernels.dfx_quant import LIMB_BITS, n_limbs, split_planes

#: keys per online-softmax update (the reference kernel's bk)
BLOCK_K = 128
_BIG_NEG = -1e30


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
