"""Port parity of the MoE slice: ``int_batched_linear`` (forward, dX, dW),
``blocks.moe_apply`` (the drop-free and the capacity dispatch, a forced
top-k tie) and the reduced qwen2-moe-a2.7b (2 layers, d 128, 4 experts
top-2, a shared expert of 128) end to end, from the reference's own
weights (``convert.params_from_jax``), against the JAX package on the
pallas backend (kernels in interpret mode); the launchers.

XLA:CPU's ``exp2`` is exact only for integers in about [-12, 12], and the
experts' product exponents sit near -19, so the tight comparisons run with
``jnp.exp2`` made exact for integer arguments (patched around the traced
call, the jit caches cleared before and after), as in
``test_torch_lm_train.py``.  Stated tolerances:

* ``int_batched_linear`` with exact scales: y, dX and dW bit for bit,
  round to nearest and with the reference's own stochastic-rounding noise
  fed in (every integer is exact, the combine order is the reference's);
* ``moe_apply`` under int8 with exact scales: the output within 1e-3 of
  max|y|, at most one token in eight off by more than 1e-5 of it, and aux
  within 1e-5 relative.  The FP32 kept ops (the router softmax's exp, the
  SiLU, the mean over tokens) round differently on the two sides: the
  gates differ by ulps, and now and then an a12 mantissa of the SwiGLU's
  product moves by one step, which moves that token's output row by
  ~2^-11 of the slice's scale (measured 1.4e-4 of max|y|, on one token of
  32).  Under FP32 (the capacity regime, kept FP32 so the test stays
  seconds long, as the reference's own test of it): within 1e-5 of
  max|y|, aux within 1e-5;
* the reduced model's served logits within 5e-3 of max|logits| (the
  reference's scales as they run here, as ``test_torch_serve.py``); decode
  equal to prefill within 2e-4 (FP32, as the reference's test); one
  ``lm_loss`` step: under FP32 the loss within 1e-6 relative, aux within
  1e-5 and every gradient within 1e-4 of its max; under int8 with exact
  scales the loss within 1e-6 relative, aux within 1e-5, the head's and
  the final norm's gradients within 2e-3 of their max (as
  ``test_torch_lm_train.py``) and every other gradient within 10% of its
  norm (the attention q / k projections within 50%).  The wider bounds
  are the one-step flips above at work: a forward that moves the logits
  by ~1e-4 moves the 8-bit mantissas of the upstream gradient by one step
  here and there (a step is 1/127 of the tensor's max), and every
  gradient below the head feels them (measured 1-4% of the norm); the
  8-bit dS of attention's backward amplifies them in the q / k
  projections (measured 21%; see ``PERF.md``).  ``moe_apply``'s own
  backward is held tight (the block's gradients, same inputs, within
  2e-3 of their max; measured exact but for one flip of 5e-4).
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
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import int_ops  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import blocks, lm  # noqa: E402
from repro_torch.train import trainer  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several files at once, and
    small ops on many threads oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "qwen2-moe-a2.7b"
KEY = jax.random.PRNGKey(0)


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


def _exact_scales(fn):
    """``fn()`` with ``jnp.exp2`` exact at integer arguments."""
    mp = pytest.MonkeyPatch()
    jax.clear_caches()
    mp.setattr(jnp, "exp2", _exact_exp2_of(jnp.exp2))
    assert float(jnp.exp2(jnp.float32(-21))) == 2.0 ** -21
    try:
        return fn()
    finally:
        mp.undo()
        jax.clear_caches()


def _jq(**kw):
    return dataclasses.replace(JQuantConfig.int8(), backend="pallas", **kw)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}.")
        else:
            yield prefix + k, tree[k]


# =========================================================================
# int_batched_linear
# =========================================================================

@pytest.mark.parametrize("stochastic", [False, True])
def test_int_batched_linear_matches_reference(stochastic):
    rng = np.random.default_rng(11 + stochastic)
    E, C, K, N = 4, 12, 24, 20
    x = rng.standard_normal((E, C, K)).astype(np.float32)
    x[2] = 0.0                                         # an empty expert
    w = (0.02 * rng.standard_normal((E, K, N))).astype(np.float32)
    g = (1e-3 * rng.standard_normal((E, C, N))).astype(np.float32)
    key = jax.random.PRNGKey(7) if stochastic else None
    jq = _jq(stochastic_grad=stochastic)

    def run_jax():
        y, vjp = jax.vjp(lambda a, b: jint_ops.int_batched_linear(
            a, b, key, jq), jnp.asarray(x), jnp.asarray(w))
        return [np.asarray(t) for t in (y,) + vjp(jnp.asarray(g))]
    ref = _exact_scales(run_jax)

    tkey = None
    if stochastic:                # the reference's draw, one over the stack
        u = np.array(jax.random.uniform(key, g.shape, dtype=jnp.float32))
        tkey = lambda shape, device: torch.from_numpy(u)  # noqa: E731
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    y = int_ops.int_batched_linear(
        xt, wt, tkey, dataclasses.replace(QuantConfig.int8(),
                                          stochastic_grad=stochastic))
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))
    for got, r in zip((y.detach(), dx, dw), ref):
        assert got.shape == r.shape
        np.testing.assert_array_equal(got.numpy(), r)
    assert not dw[2].any()                      # no token, no gradient

    # FP32 (quantization disabled): plain einsums, gradients by autograd
    y32 = int_ops.int_batched_linear(xt, wt, None, QuantConfig.fp32())
    dx32, dw32 = torch.autograd.grad(y32, (xt, wt), torch.from_numpy(g))
    y, vjp = jax.vjp(lambda a, b: jint_ops.int_batched_linear(
        a, b, None, JQuantConfig.fp32()), jnp.asarray(x), jnp.asarray(w))
    for got, r in zip((y32.detach(), dx32, dw32), (y,) + vjp(jnp.asarray(g))):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6 * np.abs(np.asarray(r)).max())


def test_int_softmax_is_the_fp32_softmax():
    x = torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(
        int_ops.int_softmax(x, QuantConfig.int8()).numpy(),
        np.asarray(jint_ops.int_softmax(jnp.asarray(x.numpy()),
                                        JQuantConfig.int8())), rtol=1e-6)
    # kept ops "integer": the reference's i_softmax (held against it in
    # test_torch_kept_ops.py); rows sum to 1 within its bound
    xi = int_ops.int_softmax(x, QuantConfig(kept_ops="integer"))
    assert not torch.equal(xi, torch.softmax(x, -1))
    assert (xi.sum(-1) - 1).abs().max() <= 1e-3


# =========================================================================
# moe_apply
# =========================================================================

def _moe_setup(seed=0):
    jcfg = jregistry.get_config(ARCH).reduced()
    cfg = registry.get_config(ARCH).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    tree = jax.tree.map(np.array,
                        jblocks.moe_init(jax.random.PRNGKey(seed), jcfg))
    return jcfg, cfg, tree


def _moe_both(tree, x, jcfg, cfg, jq, q):
    ref = jax.jit(lambda p, xx: jblocks.moe_apply(p, xx, jcfg, jq, None))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    ref = [np.asarray(t) for t in ref]
    with torch.no_grad():
        got = blocks.moe_apply(params_from_jax(tree), torch.from_numpy(x),
                               cfg, q, None)
    return [t.numpy() for t in got], ref


def _close(y, ry):
    """The int8 ``moe_apply`` tolerance (module docstring)."""
    scale = np.abs(ry).max()
    assert np.abs(y - ry).max() <= 1e-3 * scale
    rows = np.abs(y - ry).reshape(-1, y.shape[-1]).max(-1) > 1e-5 * scale
    assert rows.sum() <= rows.size // 8


def _routing(tree, x, cfg):
    """Each token's chosen experts under FP32 router logits, and the
    capacity of the dispatch."""
    xf = torch.from_numpy(x.reshape(-1, x.shape[-1]))
    probs = torch.softmax(xf @ torch.from_numpy(tree["router"]), -1)
    _, sel = blocks.top_k(probs, cfg.moe_topk)
    return sel, blocks.capacity(cfg, xf.shape[0])


def test_moe_apply_int8_drop_free_matches_reference():
    jcfg, cfg, tree = _moe_setup(1)
    x = np.random.default_rng(2).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    sel, cap = _routing(tree, x, cfg)
    assert cap == 2 * 16 * cfg.moe_topk            # T·K <= 4096: drop-free
    # the block's backward too, round to nearest: x's and every weight's
    # gradient of <y, gy> + aux
    gy = (1e-3 * np.random.default_rng(3).standard_normal(x.shape)).astype(
        np.float32)
    jq = _jq(stochastic_grad=False)

    def run_jax():
        def f(p, xx):
            y, aux = jblocks.moe_apply(p, xx, jcfg, jq, None)
            return jnp.sum(y * gy) + aux
        grads = jax.jit(jax.grad(f, argnums=(0, 1)))(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
        return (_moe_both(tree, x, jcfg, cfg, _jq(), QuantConfig.int8()),
                jax.tree.map(np.asarray, grads))
    ((y, aux), (ry, raux)), (rp, rx) = _exact_scales(run_jax)
    assert y.shape == x.shape and np.isfinite(y).all()
    _close(y, ry)
    np.testing.assert_allclose(aux, raux, rtol=1e-5)
    p = {n: t.requires_grad_(True) for n, t in
         _leaves(params_from_jax(tree))}
    xt = torch.from_numpy(x).requires_grad_(True)
    nested = {n: t for n, t in p.items() if "." not in n}
    nested["shared"] = {n.split(".")[1]: t for n, t in p.items() if "." in n}
    y, aux = blocks.moe_apply(nested, xt, cfg, dataclasses.replace(
        QuantConfig.int8(), stochastic_grad=False), None)
    gs = torch.autograd.grad((y * torch.from_numpy(gy)).sum() + aux,
                             [xt] + list(p.values()))
    ref = dict(_leaves(rp), x=rx)
    for name, g in zip(["x"] + list(p), gs):
        assert np.abs(g.numpy() - ref[name]).max() <= 2e-3 * np.abs(
            ref[name]).max(), name


def test_moe_apply_capacity_dispatch_drops_like_reference():
    """T·K = 4160 > 4096: capacity 1408 rows per expert, and a router tilted
    to expert 0 sends every token there first, so choices are dropped."""
    jcfg, cfg, tree = _moe_setup(2)
    tree["router"][:, 0] += 0.05
    x = (np.random.default_rng(3).standard_normal((4, 520, cfg.d_model))
         + 1.0).astype(np.float32)
    sel, cap = _routing(tree, x, cfg)
    assert cap == 1408
    assert int((sel == 0).sum()) > cap                      # drops happen
    (y, aux), (ry, raux) = _moe_both(tree, x, jcfg, cfg, JQuantConfig.fp32(),
                                     QuantConfig.fp32())
    assert np.abs(y - ry).max() <= 1e-5 * np.abs(ry).max()
    np.testing.assert_allclose(aux, raux, rtol=1e-5)


def test_moe_top_k_breaks_ties_like_jax():
    """Experts 1 and 2 get equal router logits for every token and share
    the k-th place: the lower index is taken, as ``jax.lax.top_k`` does."""
    jcfg, cfg, tree = _moe_setup(3)
    tree["router"][:, 0] = 0.05
    tree["router"][:, 1] = 0.0
    tree["router"][:, 2] = 0.0
    tree["router"][:, 3] = -0.05
    x = (np.random.default_rng(4).standard_normal((2, 8, cfg.d_model))
         + 1.0).astype(np.float32)
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, cfg.d_model))
                          @ torch.from_numpy(tree["router"]), -1)
    assert torch.equal(probs[:, 1], probs[:, 2])
    vals, sel = blocks.top_k(probs, 2)
    rvals, rsel = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(rsel))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(rvals))
    assert (sel[:, 1] == 1).all()
    (y, aux), (ry, raux) = _exact_scales(
        lambda: _moe_both(tree, x, jcfg, cfg, _jq(), QuantConfig.int8()))
    _close(y, ry)
    np.testing.assert_allclose(aux, raux, rtol=1e-5)


# =========================================================================
# The reduced qwen2-moe-a2.7b end to end
# =========================================================================

def _lm_setup():
    jcfg = jregistry.get_config(ARCH).reduced()
    cfg = registry.get_config(ARCH).reduced()
    init = jax.tree.map(np.asarray, jlm.lm_init(KEY, jcfg))
    return jcfg, cfg, init


def test_params_from_jax_carries_the_moe_tree():
    _, cfg, init = _lm_setup()
    got = dict(_leaves(params_from_jax(init)))
    ref = dict(_leaves(init))
    assert sorted(got) == sorted(ref)
    assert {"blocks.moe.router", "blocks.moe.wg_e", "blocks.moe.wd_e",
            "blocks.moe.shared.wg"} <= set(ref)
    for name, r in ref.items():
        np.testing.assert_array_equal(got[name].numpy(), r)
    own = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in _leaves(own)} == {
        k: r.shape for k, r in ref.items()}


def test_prefill_and_decode_match_jax_int8_pallas():
    jcfg, cfg, init = _lm_setup()
    rng = np.random.default_rng(1)
    B, S, Smax = 2, 9, 32
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    dec = rng.integers(0, cfg.vocab, (3, B, 1)).astype(np.int32)
    jq = _jq()
    jp = jax.tree.map(jnp.asarray, init)
    jc = jlm.init_cache(jcfg, B, Smax, dtype=jnp.float32)
    logits, jc = jax.jit(lambda p, t, c: jlm.lm_prefill_cache(
        p, t, c, jcfg, jq))(jp, toks, jc)
    ref = [np.asarray(logits)]
    step = jax.jit(lambda p, t, c: jlm.lm_decode_step(p, t, c, jcfg, jq))
    for i in range(3):
        logits, jc = step(jp, dec[i], jc)
        ref.append(np.asarray(logits))

    params = params_from_jax(init, "cpu")
    cache = lm.init_cache(cfg, B, Smax, device="cpu")
    got = []
    with torch.no_grad():
        logits, cache = lm.lm_prefill_cache(params, torch.from_numpy(toks),
                                            cache, cfg, QuantConfig.int8())
        got.append(logits.numpy())
        for i in range(3):
            logits, cache = lm.lm_decode_step(params, torch.from_numpy(dec[i]),
                                              cache, cfg, QuantConfig.int8())
            got.append(logits.numpy())
    np.testing.assert_array_equal(cache["index"].numpy(),
                                  np.asarray(jc["index"]))
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (B, 1, lm.padded_vocab(cfg))
        g, r = g[..., :cfg.vocab], r[..., :cfg.vocab]
        assert np.isfinite(g).all()
        assert np.abs(g - r).max() <= 5e-3 * np.abs(r).max()


def test_decode_matches_prefill():
    """The port's counterpart of the reference's cache test: stepping the
    tokens one by one reproduces the whole prompt's prefill (FP32)."""
    _, cfg, init = _lm_setup()
    params = params_from_jax(init)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, 8)).astype(np.int32))
    q = QuantConfig.fp32()
    with torch.no_grad():
        pre, _ = lm.lm_prefill_cache(params, toks,
                                     lm.init_cache(cfg, 2, 16, device="cpu"),
                                     cfg, q)
        cache = lm.init_cache(cfg, 2, 16, device="cpu")
        for t in range(8):
            dec, cache = lm.lm_decode_step(params, toks[:, t:t + 1], cache,
                                           cfg, q)
    np.testing.assert_allclose(pre.numpy(), dec.numpy(), atol=2e-4)


@pytest.mark.parametrize("quant", ["int8", "fp32"])
def test_lm_loss_step_matches_reference(quant):
    jcfg, cfg, init = _lm_setup()
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    batch["labels"][:, -1] = -1
    if quant == "int8":
        jq = _jq(stochastic_grad=False)
        q = dataclasses.replace(QuantConfig.int8(), stochastic_grad=False)
    else:
        jq, q = JQuantConfig.fp32(), QuantConfig.fp32()

    def run_jax():
        (loss, m), g = jax.jit(jax.value_and_grad(
            lambda p, b: jlm.lm_loss(p, b, jcfg, jq, None), has_aux=True))(
            jax.tree.map(jnp.asarray, init),
            {k: jnp.asarray(v) for k, v in batch.items()})
        return float(loss), float(m["aux"]), jax.tree.map(np.asarray, g)
    ref_loss, ref_aux, ref_grads = _exact_scales(run_jax)

    loss, m, grads = trainer.loss_and_grads(
        lm.lm_loss, params_from_jax(init),
        {k: torch.from_numpy(v) for k, v in batch.items()}, cfg, q, None)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-6)
    np.testing.assert_allclose(float(m["aux"]), ref_aux, rtol=1e-5)
    assert float(m["aux"]) > 0
    got, ref = dict(_leaves(grads)), dict(_leaves(ref_grads))
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        g = got[name].numpy()
        assert g.shape == r.shape and np.isfinite(g).all(), name
        err = np.abs(g - r).max() / np.abs(r).max()
        if quant == "fp32":
            assert err <= 1e-4, name
        elif name in ("lm_head", "final_norm.g"):
            assert err <= 2e-3, name
        else:
            rel = np.linalg.norm(g - r) / np.linalg.norm(r)
            assert rel <= (0.5 if name in ("blocks.attn.wq", "blocks.attn.wk")
                           else 0.1), (name, rel)


def test_launchers_run_qwen2_moe_on_cpu(caplog):
    caplog.set_level("INFO")
    launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--requests", "2", "--prompt-len", "4", "--max-new",
                       "2"])
    assert "served 2 requests, 4 tokens" in caplog.text
    losses = launch_train.main(["--arch", ARCH, "--reduced", "--device",
                                "cpu", "--steps", "3", "--batch", "2",
                                "--seq", "16", "--log-every", "1"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "arch=qwen2-moe-a2.7b-smoke" in caplog.text


def test_train_step_leaves_no_reference_cycle():
    """A training step frees its gradients when it returns: no tensor is
    left in a reference cycle for the cyclic collector (a recursive
    closure in ``optimizer.tree_unflatten`` once kept a whole gradient tree
    alive that way — at qwen2-moe-a2.7b's width 6.6 GiB a step)."""
    import gc
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.train import optimizer as topt
    cfg = registry.get_config(ARCH).reduced()
    gen = torch.Generator().manual_seed(0)
    params = lm.lm_init(gen, cfg, device="cpu")
    step = trainer.make_train_step(lm.lm_loss, cfg, QuantConfig.int8(),
                                   topt.OptimizerConfig(lr=1e-4))
    batch = {k: torch.as_tensor(v) for k, v in next(SyntheticLM(DataConfig(
        batch_size=2, seq_len=16, vocab=cfg.vocab))).items()}
    opt = topt.init(params)
    gc.collect()
    enabled, flags = gc.isenabled(), gc.get_debug()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        params, opt, _ = step(params, opt, batch, gen)
        gc.collect()
        leaked = [x for x in gc.garbage if isinstance(x, torch.Tensor)]
    finally:
        gc.garbage.clear()
        gc.set_debug(flags)
        if enabled:
            gc.enable()
    assert not leaked
