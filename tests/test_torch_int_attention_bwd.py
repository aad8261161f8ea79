"""Port parity: integer flash-attention backward (the plain versions of
``int_attn_bwd_dq`` / ``int_attn_bwd_dkv`` in
repro_torch.kernels.int_attention) against the JAX Pallas kernels in
interpret mode and the f64 oracle ``kernels/ref.py::int_attention_bwd_ref``,
and ``int_ops.int_attention``'s gradients against ``jax.vjp``.

Stated tolerances.  Integer inputs (limb planes) are the same on both
sides; the f32 outputs dq, dk and dv within 1e-4 of max|ref| against the
Pallas kernels, with every exponent and every product's output exponent
inside XLA:CPU's exact-``exp2`` window (measured: bit for bit, the exp of
the p recompute agreeing on these inputs).  Against the f64 oracle, which
rounds P and dS from f64 scores, a mantissa can move by one step at a
rounding boundary: within 2^-(bits-1) of max|ref| there.  Through
``int_attention`` (quantize, forward, backward) against ``jax.vjp`` on the
pallas backend, the reference's stochastic noise ``u`` fed in through a
callable key: within 1e-4 of max|ref|.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import int_ops as jint_ops  # noqa: E402
from repro.core.qconfig import QuantConfig as JQuantConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import int_ops  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.kernels import int_attention as ia  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

#: q, k, v, g, dS exponents: q+k = -10, g+v = -12, dS+k = dS+q = -11
_EXPS = (-5, -5, -6, -6, -6)
_G_BITS = 8

CASES = {
    # name: (B, Sq, Sk, KV, G, hd, offsets, causal, window)
    "bidirectional_gqa3": (2, 9, 9, 1, 3, 16, [0, 0], False, None),
    "causal_training": (2, 40, 40, 2, 1, 16, [0, 0], True, None),
    "causal_gqa3_two_blocks": (1, 136, 136, 1, 3, 8, [0], True, None),
    "ragged_prefill": (2, 20, 150, 2, 2, 16, [100, 37], True, None),
    "window": (1, 17, 260, 1, 2, 24, [200], True, 40),
}


def _exact_exp2(n: int) -> bool:
    return float(jnp.exp2(jnp.float32(n))) == float(np.ldexp(1.0, n))


def _mantissas(rng, bits, shape, sigma=40.0):
    lim = 2 ** (bits - 1) - 1
    return np.clip(np.round(rng.standard_normal(shape) * sigma), -lim,
                   lim).astype(np.int32)


def _inputs(case, qk_bits, pv_bits, seed):
    B, Sq, Sk, KV, G, hd, off, causal, window = CASES[case]
    rng = np.random.default_rng(seed)
    m = [_mantissas(rng, qk_bits, (B, Sq, KV, G, hd)),
         _mantissas(rng, qk_bits, (B, Sk, KV, hd)),
         _mantissas(rng, pv_bits, (B, Sk, KV, hd)),
         _mantissas(rng, _G_BITS, (B, Sq, KV, G, hd), sigma=30.0)]
    planes = [ops.split_limbs_stacked(torch.from_numpy(x), b)
              for x, b in zip(m, (qk_bits, qk_bits, pv_bits, _G_BITS))]
    e = [torch.tensor(x, dtype=torch.int32) for x in _EXPS]
    offt = torch.tensor(off, dtype=torch.int32)
    _, lse = ops.attention_fwd(planes[0], e[0], planes[1], e[1], planes[2],
                               e[2], offt, pv_bits, causal=causal,
                               window=window)
    delta = torch.from_numpy(
        (0.05 * rng.standard_normal((B, Sq, KV, G))).astype(np.float32))
    return m, planes, e, offt, lse, delta


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("qk_bits,pv_bits", [(8, 8), (12, 12)])
def test_attention_bwd_matches_pallas(case, qk_bits, pv_bits):
    B, Sq, Sk, KV, G, hd, off, causal, window = CASES[case]
    ds_bits = qk_bits
    _, planes, e, offt, lse, delta = _inputs(
        case, qk_bits, pv_bits, sorted(CASES).index(case) + qk_bits)
    for a, b in ((0, 1), (3, 2), (4, 1), (4, 0)):
        assert _exact_exp2(_EXPS[a] + _EXPS[b])
    dq, dk, dv = ops.attention_bwd(planes[0], e[0], planes[1], e[1],
                                   planes[2], e[2], planes[3], e[3], lse,
                                   delta, e[4], offt, pv_bits, ds_bits,
                                   causal=causal, window=window)
    jp = [jnp.asarray(p.numpy()) for p in planes]
    refs = jops.attention_bwd(
        jp[0], jnp.int32(_EXPS[0]), jp[1], jnp.int32(_EXPS[1]), jp[2],
        jnp.int32(_EXPS[2]), jp[3], jnp.int32(_EXPS[3]),
        jnp.asarray(lse.numpy()), jnp.asarray(delta.numpy()),
        jnp.int32(_EXPS[4]), jnp.asarray(off, jnp.int32), pv_bits, ds_bits,
        causal=causal, window=window, interpret=True)
    assert dq.shape == (B, Sq, KV, G, hd)
    assert dk.shape == dv.shape == (B, Sk, KV, hd)
    for got, ref in zip((dq, dk, dv), refs):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("case", ["bidirectional_gqa3", "causal_training",
                                  "window"])
def test_attention_bwd_matches_f64_oracle(case):
    B, Sq, Sk, KV, G, hd, off, causal, window = CASES[case]
    m, planes, e, offt, lse, delta = _inputs(case, 12, 12, 7)
    got = ops.attention_bwd(planes[0], e[0], planes[1], e[1], planes[2],
                            e[2], planes[3], e[3], lse, delta, e[4], offt,
                            12, 12, causal=causal, window=window)
    refs = jref.int_attention_bwd_ref(
        *(jnp.asarray(x) if i % 2 == 0 else jnp.int32(x)
          for i, x in enumerate((m[0], _EXPS[0], m[1], _EXPS[1], m[2],
                                 _EXPS[2], m[3], _EXPS[3]))),
        jnp.asarray(lse.numpy()), jnp.asarray(delta.numpy()),
        jnp.int32(_EXPS[4]), 12, 12, jnp.asarray(off), causal=causal,
        window=window)
    for g, r in zip(got, refs):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 2.0 ** -11 * np.abs(r).max()


def test_gqa_dkv_sums_the_group_in_order():
    """dk / dv of a kv head shared by G = 3 query heads are the ordered sums
    of the per-head results (each head alone as G = 1, added in head order;
    one q block per head, and sc = 1/4 scales exactly)."""
    B, Sq, Sk, KV, G, hd, off, causal, window = CASES["bidirectional_gqa3"]
    _, planes, e, offt, lse, delta = _inputs("bidirectional_gqa3", 12, 12,
                                             3)
    exps = torch.stack(e)
    kw = dict(p_bits=12, ds_bits=12, causal=causal, window=window,
              sc=1 / hd ** 0.5)
    dk, dv = ia.int_attn_bwd_dkv(planes[0], planes[1], planes[2], planes[3],
                                 lse, delta, offt, exps, **kw)
    assert kw["sc"] == 0.25
    parts = [ia.int_attn_bwd_dkv(
        planes[0][..., g:g + 1, :], planes[1], planes[2],
        planes[3][..., g:g + 1, :], lse[:, :, g:g + 1], delta[..., g:g + 1],
        offt, exps, **kw) for g in range(G)]
    dk_sum, dv_sum = parts[0]
    for pk, pv in parts[1:]:
        dk_sum, dv_sum = dk_sum + pk, dv_sum + pv
    assert torch.equal(dv, dv_sum) and torch.equal(dk, dk_sum)


def test_bwd_wrappers_check_their_arguments():
    _, planes, e, offt, lse, delta = _inputs("causal_training", 12, 12, 1)
    exps = torch.stack(e)
    kw = dict(p_bits=12, ds_bits=8, causal=True, window=None, sc=0.25)
    with pytest.raises(ValueError):          # v planes != n_limbs(p_bits)
        ia.int_attn_bwd_dq(planes[0], planes[1], planes[2][:1], planes[3],
                           lse, delta, offt, exps, **kw)
    with pytest.raises(ValueError):          # lse of the wrong shape
        ia.int_attn_bwd_dkv(planes[0], planes[1], planes[2], planes[3],
                            lse[..., :-1], delta, offt, exps, **kw)
    with pytest.raises(TypeError):
        ia.int_attn_bwd_dq(planes[0].to(torch.int16), planes[1], planes[2],
                           planes[3], lse, delta, offt, exps, **kw)


def _keys(seed, shape, stochastic):
    if not stochastic:
        return None, None
    key = jax.random.PRNGKey(seed)
    u = np.array(jax.random.uniform(key, shape, dtype=jnp.float32))

    def port_key(shape_, device):
        assert tuple(shape_) == u.shape
        return torch.from_numpy(u).to(device)
    return key, port_key


@pytest.mark.parametrize("stochastic", [True, False])
@pytest.mark.parametrize("causal,G", [(True, 1), (False, 3), (True, 3)])
def test_int_attention_grads_match_jax_vjp(stochastic, causal, G):
    rng = np.random.default_rng([stochastic, causal, G])
    B, S, KV, hd = 2, 12, 2, 16
    q = rng.standard_normal((B, S, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    cot = (4.0 * rng.standard_normal((B, S, KV, G, hd))).astype(np.float32)
    jcfg = dataclasses.replace(JQuantConfig.int8(), backend="pallas",
                               stochastic_grad=stochastic)
    tcfg = dataclasses.replace(QuantConfig.int8(),
                               stochastic_grad=stochastic)
    jkey, tkey = _keys(5, (B * S * KV * G, hd), stochastic)
    o_ref, vjp = jax.vjp(lambda a, b, c: jint_ops.int_attention(
        a, b, c, 0, jkey, jcfg, jcfg, causal, None),
        *map(jnp.asarray, (q, k, v)))
    refs = [np.asarray(r) for r in vjp(jnp.asarray(cot))]
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = int_ops.int_attention(*ts, 0, tkey, tcfg, tcfg, causal, None)
    o.backward(torch.from_numpy(cot))
    assert np.abs(o.detach().numpy() - np.asarray(o_ref)).max() <= \
        2.0 ** -11 * np.abs(v).max()
    for t, r in zip(ts, refs):
        assert np.abs(t.grad.numpy() - r).max() <= 1e-4 * np.abs(r).max()


def test_ds_exponent_is_the_reference_bound():
    """``ceil(log2(2·‖dO‖·‖v‖)) - (ds_bits - 1)``, a power of two included
    (no round-up past it)."""
    for gn, vn in ((1.0, 0.5), (3.0, 0.7), (1e-4, 2.5), (2.0 ** -12, 4.0),
                   (0.0, 0.0)):
        got = int_ops._ds_exp(torch.tensor(gn, dtype=torch.float32),
                              torch.tensor(vn, dtype=torch.float32), 8)
        ref = jint_ops._ds_exp(jnp.float32(gn), jnp.float32(vn), 8)
        assert int(got) == int(ref), (gn, vn)
    x = np.random.default_rng(0).standard_normal((3, 5, 7)).astype(
        np.float32)
    np.testing.assert_allclose(
        float(int_ops._max_row_norm(torch.from_numpy(x))),
        float(jint_ops._max_row_norm(jnp.asarray(x))), rtol=1e-6)
