"""Port parity of ``kept_ops="integer"`` and stochastic forward rounding:
the five kernels' integer bodies (plain versions, flag set) against the
JAX Pallas kernels in interpret mode with ``integer_exp`` /
``integer_rsqrt``; ``int_activation`` / ``int_softmax`` with their
gradients; a reduced BERT and a reduced qwen kept-int training step; a
reduced MoE step's router gradient; ``stochastic_fwd`` with a key.

Every comparison with the reference runs with ``jnp.exp2`` made exact for
integer arguments (XLA:CPU's is exact only in about [-12, 12], and every
``i_exp`` scales by 2^(q-14), q - 14 in [-58, 29]; caveat A), the jit
caches cleared before and after.  Stated tolerances:

* RMS-norm / layer-norm forward: rstd (the Newton iterate times an exact
  power of two) bit for bit, mu within 2 ulp, y within 4 ulp of its row's
  max|y|;
* attention forward: o within 2^-12 of max|o| (the row sum l runs in
  another order, which can move i_recip's rounded d by one Q.14 step),
  lse within 1e-5;
* attention backward: dq, dk and dv within 1e-4 of max|ref| (the
  recomputed p is bit for bit the reference's; the f32 sums as the FP32
  body's test), at causal, windowed, ragged, GQA shapes and head dim 256;
* ``int_activation``: forward and gradient bit for bit;
* the reduced kept-int steps: the loss within 1e-6 relative and every
  parameter's gradient within 2e-3 of its largest magnitude (the bound the
  int8 steps are held to; the FP32 kept ops left, the loss's log-softmax,
  RoPE, delta's row sums, round differently and can move a g8 mantissa);
* ``stochastic_fwd``: the reference's forward and gradient noise fed in
  through a callable key: ``int_linear`` and kept-int attention bit for
  bit; the norms' y within 8 ulp of its row's max|y| and dx within 64 ulp
  of max|dx| (f32 row sums in another order); FP32 attention's o within
  one P step (2^-11 of max|o|: XLA's exp against PyTorch's) and its
  gradients within 1e-4 of max.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.core import int_ops as jint_ops  # noqa: E402
from repro.core.qconfig import QuantConfig as JQuantConfig  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import paper_models as jpm  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import int_ops  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels import int_norm, ops  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import paper_models as pm  # noqa: E402
from repro_torch.train import finetune as tf  # noqa: E402
from repro_torch.train import trainer  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several files at once, and
    small ops on many threads oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ULP = 2.0 ** -23


def _exact_exp2_of(orig):
    def exp2(x):
        x = jnp.asarray(x)
        if x.dtype != jnp.float32:
            return orig(x)
        n = x.astype(jnp.int32)
        bits = jnp.left_shift(jnp.clip(n, -126, 127) + 127, 23)
        return jnp.where(n.astype(jnp.float32) == x,
                         jax.lax.bitcast_convert_type(bits, jnp.float32),
                         orig(x))
    return exp2


@pytest.fixture
def exact_jax():
    mp = pytest.MonkeyPatch()
    jax.clear_caches()
    mp.setattr(jnp, "exp2", _exact_exp2_of(jnp.exp2))
    assert float(jnp.exp2(jnp.float32(-40))) == 2.0 ** -40
    yield
    mp.undo()
    jax.clear_caches()


def _kept_int(jax_side: bool, **kw):
    base = dict(weight_bits=8, act_bits=12, grad_bits=8,
                stochastic_grad=False, kept_ops="integer", **kw)
    if jax_side:
        return JQuantConfig(backend="pallas", **base)
    return QuantConfig(**base)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}.")
        else:
            yield prefix + k, tree[k]


# =========================================================================
# the kernels' integer bodies (plain versions) against Pallas
# =========================================================================

@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
@pytest.mark.parametrize("bits,R,D", [(12, 37, 96), (8, 16, 300),
                                      (16, 9, 64)])
def test_norm_integer_rsqrt_matches_pallas(kind, bits, R, D, exact_jax):
    rng = np.random.default_rng([bits, R, D])
    lim = 2 ** (bits - 1) - 1
    xm = np.clip(np.round(rng.standard_normal((R, D)) * lim / 3), -lim,
                 lim).astype(np.int16 if bits > 8 else np.int8)
    xm[0, :] = xm[0, 0]                              # a constant row: var 0
    x_exp = -bits - 3
    gamma = (1 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(D)).astype(np.float32)
    args = (jnp.asarray(xm), jnp.int32(x_exp), jnp.asarray(gamma))
    targs = (torch.from_numpy(xm), torch.tensor(x_exp, dtype=torch.int32),
             torch.from_numpy(gamma))
    if kind == "layernorm":
        ref = jops.layernorm_pallas(*args, jnp.asarray(beta),
                                    interpret=True, integer_rsqrt=True)
        got = int_norm.int_layernorm_fwd(*targs, torch.from_numpy(beta),
                                         integer_rsqrt=True)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                                   rtol=2 * ULP, atol=1e-30)
    else:
        ref = jops.rmsnorm_pallas(*args, interpret=True, integer_rsqrt=True)
        got = ops.rmsnorm(*targs, integer_rsqrt=True)
    y, rstd = got[0].numpy(), got[-1].numpy()
    y0, rstd0 = np.asarray(ref[0]), np.asarray(ref[-1])
    np.testing.assert_array_equal(rstd, rstd0)
    row = np.abs(y0).max(-1, keepdims=True)
    assert np.all(np.abs(y - y0) <= 4 * ULP * row)
    # and the body differs from the FP32 one by the Newton form's error
    fp = (int_norm.int_layernorm_fwd(*targs, torch.from_numpy(beta))
          if kind == "layernorm" else ops.rmsnorm(*targs))
    rel = np.abs(rstd / fp[-1].numpy() - 1)
    assert rel.max() <= 4e-4 and rel.max() > 0


def _mantissas(rng, bits, shape, sigma=40.0):
    lim = 2 ** (bits - 1) - 1
    return np.clip(np.round(rng.standard_normal(shape) * sigma), -lim,
                   lim).astype(np.int32)


#: q, k, v, g, dS exponents (every product's exponent in XLA's window too)
_EXPS = (-5, -5, -6, -6, -6)

ATTN_CASES = {
    # name: (B, Sq, Sk, KV, G, hd, offsets, causal, window)
    "decode": (3, 1, 200, 2, 1, 32, [150, 60, 199], True, None),
    "causal_training": (2, 40, 40, 2, 1, 16, [0, 0], True, None),
    "causal_two_blocks_gqa3": (1, 136, 136, 1, 3, 8, [0], True, None),
    "ragged_prefill_gqa": (2, 20, 150, 2, 2, 16, [100, 37], True, None),
    "window": (1, 17, 260, 1, 2, 24, [200], True, 40),
    "bidirectional_gqa3": (2, 9, 9, 1, 3, 16, [0, 0], False, None),
}


def _attn_inputs(case, seed, qk_bits=12, pv_bits=12, g_bits=8):
    B, Sq, Sk, KV, G, hd, off, causal, window = ATTN_CASES.get(
        case, HD256)
    rng = np.random.default_rng(seed)
    m = [_mantissas(rng, qk_bits, (B, Sq, KV, G, hd)),
         _mantissas(rng, qk_bits, (B, Sk, KV, hd)),
         _mantissas(rng, pv_bits, (B, Sk, KV, hd)),
         _mantissas(rng, g_bits, (B, Sq, KV, G, hd), sigma=30.0)]
    planes = [ops.split_limbs_stacked(torch.from_numpy(x), b)
              for x, b in zip(m, (qk_bits, qk_bits, pv_bits, g_bits))]
    e = [torch.tensor(x, dtype=torch.int32) for x in _EXPS]
    delta = torch.from_numpy(
        (0.05 * rng.standard_normal((B, Sq, KV, G))).astype(np.float32))
    return planes, e, torch.tensor(off, dtype=torch.int32), delta


#: head dim 256: the backward kernels' widest body
HD256 = (1, 40, 40, 1, 2, 256, [0], True, None)


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_fwd_integer_exp_matches_pallas(case, exact_jax):
    B, Sq, Sk, KV, G, hd, off, causal, window = ATTN_CASES[case]
    planes, e, offt, _ = _attn_inputs(case, sorted(ATTN_CASES).index(case))
    o, lse = ops.attention_fwd(planes[0], e[0], planes[1], e[1], planes[2],
                               e[2], offt, 12, causal=causal, window=window,
                               integer_exp=True)
    jp = [jnp.asarray(p.numpy()) for p in planes]
    o_ref, lse_ref = jops.attention_fwd(
        jp[0], jnp.int32(_EXPS[0]), jp[1], jnp.int32(_EXPS[1]), jp[2],
        jnp.int32(_EXPS[2]), jnp.asarray(off, jnp.int32), 12, causal=causal,
        window=window, interpret=True, integer_exp=True)
    o_ref, lse_ref = np.asarray(o_ref), np.asarray(lse_ref)
    assert np.abs(o.numpy() - o_ref).max() <= 2.0 ** -12 * np.abs(o_ref).max()
    np.testing.assert_allclose(lse.numpy(), lse_ref, rtol=0, atol=1e-5)
    # the FP32 body is another function: P's mantissas move
    o32, _ = ops.attention_fwd(planes[0], e[0], planes[1], e[1], planes[2],
                               e[2], offt, 12, causal=causal, window=window)
    assert not torch.equal(o32, o)


@pytest.mark.parametrize("case", sorted(ATTN_CASES) + ["head_dim_256"])
def test_attention_bwd_integer_exp_matches_pallas(case, exact_jax):
    B, Sq, Sk, KV, G, hd, off, causal, window = ATTN_CASES.get(case, HD256)
    planes, e, offt, delta = _attn_inputs(case, 11 + len(case))
    _, lse = ops.attention_fwd(planes[0], e[0], planes[1], e[1], planes[2],
                               e[2], offt, 12, causal=causal, window=window,
                               integer_exp=True)
    dq, dk, dv = ops.attention_bwd(planes[0], e[0], planes[1], e[1],
                                   planes[2], e[2], planes[3], e[3], lse,
                                   delta, e[4], offt, 12, 8, causal=causal,
                                   window=window, integer_exp=True)
    jp = [jnp.asarray(p.numpy()) for p in planes]
    refs = jops.attention_bwd(
        jp[0], jnp.int32(_EXPS[0]), jp[1], jnp.int32(_EXPS[1]), jp[2],
        jnp.int32(_EXPS[2]), jp[3], jnp.int32(_EXPS[3]),
        jnp.asarray(lse.numpy()), jnp.asarray(delta.numpy()),
        jnp.int32(_EXPS[4]), jnp.asarray(off, jnp.int32), 12, 8,
        causal=causal, window=window, interpret=True, integer_exp=True)
    assert dq.shape == (B, Sq, KV, G, hd) and dk.shape == (B, Sk, KV, hd)
    for got, ref in zip((dq, dk, dv), refs):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


# =========================================================================
# the layers
# =========================================================================

@pytest.mark.parametrize("kind", ["gelu", "silu", "tanh"])
def test_int_activation_matches_reference_vjp(kind, exact_jax):
    rng = np.random.default_rng(len(kind))
    x = (4 * rng.standard_normal((6, 33))).astype(np.float32)
    g = rng.standard_normal((6, 33)).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda a: jint_ops.int_activation(
        a, _kept_int(True), kind), jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = int_ops.int_activation(xt, _kept_int(False), kind)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(dx_ref))
    # the FP32 op under the paper's setting (or with quantization off)
    for cfg in (QuantConfig.int8(), dataclasses.replace(
            _kept_int(False), enabled=False)):
        assert torch.equal(int_ops.int_activation(torch.from_numpy(x), cfg,
                                                  kind),
                           int_ops._ACT_FNS[kind][0](torch.from_numpy(x)))


def test_int_softmax_matches_reference_and_carries_no_gradient(exact_jax):
    rng = np.random.default_rng(2)
    x = (3 * rng.standard_normal((40, 60))).astype(np.float32)
    ref = np.asarray(jint_ops.int_softmax(jnp.asarray(x), _kept_int(True)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = int_ops.int_softmax(xt, _kept_int(False))
    assert not got.requires_grad
    assert np.all(np.abs(got.numpy() - ref)
                  <= 4 * ULP * np.abs(ref).max(-1, keepdims=True)
                  + 2e-4 * ref)
    assert np.abs(got.numpy().sum(-1) - 1).max() <= 1e-3
    # the reference's gradient through it is zero as well
    (dx_ref,) = jax.grad(lambda a: jnp.sum(jint_ops.int_softmax(
        a, _kept_int(True)) * jnp.arange(60.0)), argnums=(0,))(
        jnp.asarray(x))
    assert not np.asarray(dx_ref).any()


def test_moe_router_gets_a_zero_gradient():
    """A reduced qwen2-moe-a2.7b ``lm_loss`` step under kept-int: the
    router's i_softmax passes no gradient, so the router weight's gradient
    is a tree leaf of zeros (as the reference's), and every other MoE
    weight's is not."""
    arch = "qwen2-moe-a2.7b"
    jcfg = jregistry.get_config(arch).reduced()
    cfg = registry.get_config(arch).reduced()
    init = jax.tree.map(np.asarray, jlm.lm_init(jax.random.PRNGKey(0), jcfg))
    data = pipeline.SyntheticLM(pipeline.DataConfig(batch_size=2, seq_len=16,
                                                    vocab=cfg.vocab))
    batch = next(data)
    _, _, grads = trainer.loss_and_grads(
        lm.lm_loss, params_from_jax(init), tf.to_device(batch, "cpu"), cfg,
        _kept_int(False), None)
    moe = grads["blocks"]["moe"]
    assert moe["router"].shape == init["blocks"]["moe"]["router"].shape
    assert not moe["router"].any()
    for name in ("wg_e", "wu_e", "wd_e"):
        assert moe[name].abs().max() > 0, name
    ref = jax.grad(lambda p: jlm.lm_loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
        _kept_int(True), None)[0])(jax.tree.map(jnp.asarray, init))
    assert not np.asarray(ref["blocks"]["moe"]["router"]).any()


def _jax_grads(loss_fn, init, batch, cfg):
    qcfg = _kept_int(True)
    loss, g = jax.jit(jax.value_and_grad(
        lambda p, b: loss_fn(p, b, cfg, qcfg, None)[0]))(
        jax.tree.map(jnp.asarray, init),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), jax.tree.map(np.asarray, g)


def _check_step(loss, grads, ref_loss, ref_grads):
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)
    got, ref = dict(_leaves(grads)), dict(_leaves(ref_grads))
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        g = got[name].numpy()
        assert g.shape == r.shape and np.all(np.isfinite(g)), name
        assert np.abs(g - r).max() <= 2e-3 * np.abs(r).max(), name


def test_bert_kept_int_step_matches_reference(exact_jax):
    """bert-tiny's shape cut to 2 layers (d 64): one cls step's loss and
    every gradient under int8 + kept-int (integer attention, GELU, tanh
    pooler, layer-norm rsqrt)."""
    small = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=128,
                 name="bert-2l-d64")
    jcfg = jpm.bert_config(**small)
    init = jax.tree.map(np.asarray, jpm.bert_init(jax.random.PRNGKey(0),
                                                  jcfg, num_labels=4))
    batch = tf.make_cls_task(vocab=128, seq=16)(4, 0)
    ref_loss, ref_grads = _jax_grads(jpm.bert_cls_loss, init, batch, jcfg)
    loss, _, grads = trainer.loss_and_grads(
        pm.bert_cls_loss, params_from_jax(init), tf.to_device(batch, "cpu"),
        pm.bert_config(**small), _kept_int(False), None)
    _check_step(float(loss), grads, ref_loss, ref_grads)


def test_qwen_kept_int_step_matches_reference(exact_jax):
    """The reduced qwen1.5-0.5b (2 layers): one ``lm_loss`` step under
    int8 + kept-int (integer attention, SiLU, RMS-norm rsqrt)."""
    arch = "qwen1.5-0.5b"
    jcfg = jregistry.get_config(arch).reduced()
    cfg = registry.get_config(arch).reduced()
    init = jax.tree.map(np.asarray, jlm.lm_init(jax.random.PRNGKey(0), jcfg))
    batch = next(pipeline.SyntheticLM(pipeline.DataConfig(
        batch_size=2, seq_len=24, vocab=cfg.vocab)))
    ref_loss, ref_grads = _jax_grads(jlm.lm_loss, init, batch, jcfg)
    loss, _, grads = trainer.loss_and_grads(
        lm.lm_loss, params_from_jax(init), tf.to_device(batch, "cpu"), cfg,
        _kept_int(False), None)
    _check_step(float(loss), grads, ref_loss, ref_grads)


# =========================================================================
# stochastic forward rounding with a key
# =========================================================================

def _noise_key(draws):
    """A callable key handing in ``draws`` in order, checking each
    shape."""
    it = iter(draws)

    def key(shape, device):
        u = next(it)
        assert tuple(shape) == u.shape, (shape, u.shape)
        return torch.from_numpy(u).to(device)
    return key


def _uniform(key, shape):
    return np.array(jax.random.uniform(key, shape, dtype=jnp.float32))


@pytest.mark.parametrize("layer", ["linear", "layernorm", "rmsnorm"])
def test_stochastic_fwd_matches_reference(layer, exact_jax):
    """The reference splits its key: activation noise from the first half
    (over the 2-D view), the gradient's from the rest; the port draws the
    same two arrays in that order through a callable key.  Every exponent
    in XLA's exact window (inputs of max-abs near 4)."""
    rng = np.random.default_rng(len(layer))
    x = (2 * rng.standard_normal((3, 5, 16))).astype(np.float32)
    cot = (2 * rng.standard_normal((3, 5, 16 if layer != "linear" else 8))
           ).astype(np.float32)
    w = (2 * rng.standard_normal((16, 8))).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(16)).astype(np.float32)
    jcfg = dataclasses.replace(JQuantConfig.int8(), backend="pallas",
                               stochastic_fwd=True)
    tcfg = dataclasses.replace(QuantConfig.int8(), stochastic_fwd=True)
    key = jax.random.PRNGKey(9)
    rest, kf = jax.random.split(key)
    draws = [_uniform(kf, (15, 16)), _uniform(rest, (15, cot.shape[-1]))]
    if layer == "linear":
        args = (x, w)
        jfn = lambda a, b: jint_ops.int_linear(a, b, None, key, jcfg)  # noqa
        tfn = lambda a, b, k: int_ops.int_linear(a, b, None, k, tcfg)  # noqa
    elif layer == "layernorm":
        args = (x, gamma, beta)
        jfn = lambda a, g, b: jint_ops.int_layernorm(a, g, b, key, jcfg)  # noqa
        tfn = lambda a, g, b, k: int_ops.int_layernorm(a, g, b, k, tcfg)  # noqa
    else:
        args = (x, gamma)
        jfn = lambda a, g: jint_ops.int_rmsnorm(a, g, key, jcfg)  # noqa
        tfn = lambda a, g, k: int_ops.int_rmsnorm(a, g, k, tcfg)  # noqa
    y_ref, vjp = jax.vjp(jfn, *map(jnp.asarray, args))
    refs = vjp(jnp.asarray(cot))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    y = tfn(*ts, _noise_key(draws))
    y.backward(torch.from_numpy(cot))
    if layer == "linear":
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
        np.testing.assert_array_equal(ts[0].grad.numpy(), np.asarray(refs[0]))
        np.testing.assert_array_equal(ts[1].grad.numpy(), np.asarray(refs[1]))
    else:
        y_ref = np.asarray(y_ref)
        row = np.abs(y_ref).max(-1, keepdims=True)
        assert np.all(np.abs(y.detach().numpy() - y_ref) <= 8 * ULP * row)
        dx = np.asarray(refs[0])
        assert np.abs(ts[0].grad.numpy() - dx).max() <= 64 * ULP * np.abs(
            dx).max()
    # a round-to-nearest forward is another result
    y_rn = tfn(*[torch.from_numpy(a) for a in args], None)
    assert not torch.equal(y_rn, y.detach())


@pytest.mark.parametrize("kept_ops", ["fp32", "integer"])
def test_stochastic_fwd_attention_draws_q_k_v_then_gradient(kept_ops,
                                                             exact_jax):
    """Attention's forward noise: q, k, v in that order (the reference's
    three-way split of its forward key), then the gradient's.  Kept-int:
    bit for bit; FP32 (XLA's exp against PyTorch's): o within one P step,
    2^-11 of max|o|, the gradients within 1e-4 of max (as
    test_torch_int_attention_bwd.py's)."""
    rng = np.random.default_rng(4)
    B, S, KV, G, hd = 2, 10, 1, 2, 8
    q = rng.standard_normal((B, S, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    cot = rng.standard_normal((B, S, KV, G, hd)).astype(np.float32)
    jcfg = dataclasses.replace(JQuantConfig.int8(), backend="pallas",
                               stochastic_fwd=True, kept_ops=kept_ops)
    tcfg = dataclasses.replace(QuantConfig.int8(), stochastic_fwd=True,
                               kept_ops=kept_ops)
    key = jax.random.PRNGKey(5)
    rest, kf = jax.random.split(key)
    kq, kk, kv = jax.random.split(kf, 3)
    draws = [_uniform(kq, (B * S * KV * G, hd)),
             _uniform(kk, (B * S * KV, hd)), _uniform(kv, (B * S * KV, hd)),
             _uniform(rest, (B * S * KV * G, hd))]
    o_ref, vjp = jax.vjp(lambda a, b, c: jint_ops.int_attention(
        a, b, c, 0, key, jcfg, jcfg, True, None),
        *map(jnp.asarray, (q, k, v)))
    refs = vjp(jnp.asarray(cot))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = int_ops.int_attention(*ts, 0, _noise_key(draws), tcfg, tcfg, True,
                              None)
    o.backward(torch.from_numpy(cot))
    o_ref = np.asarray(o_ref)
    if kept_ops == "integer":
        np.testing.assert_array_equal(o.detach().numpy(), o_ref)
        for t, r in zip(ts, refs):
            np.testing.assert_array_equal(t.grad.numpy(), np.asarray(r))
        return
    assert np.abs(o.detach().numpy() - o_ref).max() <= 2.0 ** -11 * np.abs(
        o_ref).max()
    for t, r in zip(ts, refs):
        r = np.asarray(r)
        assert np.abs(t.grad.numpy() - r).max() <= 1e-4 * np.abs(r).max()
