"""Port parity of mixtral-8x7b, mistral-nemo-12b and mistral-large-123b and
of the reference's FP32 attention: the three configs field for field;
``blocks.flash_attention`` (the online softmax over KV chunks: ragged last
chunk, causal, windowed, per-row query offsets) and ``_decode_attention``
against the reference's on the same inputs; ``lm.lm_prefill`` and one
``lm_loss`` step of each arch at a test size that keeps the arch's trait,
under FP32 and int8, from the reference's own weights
(``convert.params_from_jax``) against the JAX package on the pallas
backend (kernels in interpret mode); decode against prefill with the
window biting; ``moe_apply`` above the drop-free threshold.

``ArchConfig.reduced()`` sets 4 heads of 32 on d_model 128, which would
hide two of the traits, so the test configs are ``dataclasses.replace``d
on both sides: nemo with head_dim 48 (4 x 48 = 192 != d_model 128) and an
untied head, large with 12 query heads over one kv head of 16 (G = 12),
mixtral as reduced (window 64, 4 experts top-2) driven by sequences of 80
tokens, so the window masks keys.

Stated tolerances:

* the attention functions: within 1e-5 absolute (both sides run the same
  f32 operations in the same order; the exps and sums round differently
  in the last ulps), ``flash_attention``'s gradients too (the port's
  flash backward recomputes the probabilities where the reference
  differentiates its scan: the same function, summed in another order),
  and that backward against finite differences in float64;
* ``lm_prefill``'s logits: under FP32 within 1e-5 of max|logits|; under
  int8 with exact scales (``jnp.exp2`` made exact for integer arguments,
  as in ``test_torch_lm_train.py``, caveat A) within 2e-3 of max|logits|
  — the FP32 kept ops (RMS-norm's rsqrt, RoPE, softmax, SiLU) round
  differently on the two sides and now and then move an a12 mantissa by
  one step;
* one ``lm_loss`` step: under FP32 the loss within 1e-6 relative and
  every gradient within 1e-4 of its max (as ``test_torch_moe.py``); under
  int8 with exact scales the loss within 1e-6 relative (mixtral's aux
  within 1e-5), the head's and the final norm's gradients within 2e-3 of
  their max, and every other gradient within 2e-3 of its max for nemo
  (``test_torch_lm_train.py``'s band) and, for mixtral and large, within
  10% of its norm (the attention q / k projections 50%), the band
  ``test_torch_moe.py`` states (caveat B): a forward that moves the
  logits by ulps moves g8 mantissas of the upstream gradient by one step
  here and there, and the 8-bit dS of attention's backward amplifies them
  in every gradient below it (measured: large 0.5-2.5% of the norm, wq /
  wk 8.6% / 7.7%; mixtral 1-8%, wq / wk 23% / 19%);
* decode against prefill (FP32, 80 tokens over a window of 64): within
  2e-4 absolute, the reference's own test's bound;
* ``moe_apply`` in the capacity regime (FP32): within 1e-5 of max|y|, aux
  within 1e-5 relative.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.core.qconfig import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
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


ARCHS = ("mixtral-8x7b", "mistral-nemo-12b", "mistral-large-123b")
#: published sizes (the reference's test_param_counts_match_published_scale)
PUBLISHED = {"mixtral-8x7b": 46.7e9, "mistral-nemo-12b": 12.2e9,
             "mistral-large-123b": 123e9}
#: the test size's changes from ``reduced()``, keeping each arch's trait
TRAIT = {"mixtral-8x7b": {},
         "mistral-nemo-12b": dict(head_dim=48),
         "mistral-large-123b": dict(n_heads=12, n_kv_heads=1, head_dim=16)}
#: archs whose int8 gradients below the head are held within 2e-3 of their
#: max; the others within test_torch_moe.py's band (module docstring)
TIGHT_INT8_GRADS = ("mistral-nemo-12b",)
#: tokens per sequence: past mixtral's reduced window of 64
SEQ = {"mixtral-8x7b": 80, "mistral-nemo-12b": 24, "mistral-large-123b": 24}
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


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}.")
        else:
            yield prefix + k, tree[k]


def _configs(arch):
    """The trait-keeping test configs (reference, port)."""
    jcfg = dataclasses.replace(jregistry.get_config(arch).reduced(),
                               **TRAIT[arch])
    cfg = dataclasses.replace(registry.get_config(arch).reduced(),
                              **TRAIT[arch])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _setup(arch):
    """The test configs and the reference's own init."""
    jcfg, cfg = _configs(arch)
    return jcfg, cfg, jax.tree.map(np.asarray, jlm.lm_init(KEY, jcfg))


def _quants(quant):
    if quant == "int8":
        return (dataclasses.replace(JQuantConfig.int8(), backend="pallas",
                                    stochastic_grad=False),
                dataclasses.replace(QuantConfig.int8(),
                                    stochastic_grad=False))
    return JQuantConfig.fp32(), QuantConfig.fp32()


# =========================================================================
# Configs
# =========================================================================

@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_reference_config(arch):
    cfg = registry.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jregistry.get_config(arch))
    assert abs(cfg.param_count() - PUBLISHED[arch]) / PUBLISHED[arch] < 0.15
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
        jregistry.get_config(arch).reduced())


def test_test_configs_keep_the_traits():
    _, nemo = _configs("mistral-nemo-12b")
    assert nemo.n_heads * nemo.head_dim != nemo.d_model
    assert not nemo.tie_embeddings
    _, large = _configs("mistral-large-123b")
    assert large.n_heads // large.n_kv_heads == 12
    _, mixtral = _configs("mixtral-8x7b")
    assert SEQ["mixtral-8x7b"] > mixtral.sliding_window


# =========================================================================
# FP32 attention
# =========================================================================

#: (B, Sq, Sk, KV, G, hd, q_offset, causal, window, chunk)
FLASH_CASES = {
    "causal, ragged chunk 16, per-row offsets": (2, 37, 70, 2, 2, 16,
                                                 [33, 10], True, None, 16),
    "causal, window 20, chunk 32": (2, 70, 70, 2, 3, 16, 0, True, 20, 32),
    "window, ragged chunk 32, per-row offsets": (2, 9, 75, 1, 4, 8, [66, 40],
                                                 True, 24, 32),
    "bidirectional, ragged chunk 16": (3, 45, 45, 2, 1, 16, 0, False, None,
                                       16),
    "one chunk (chunk > Sk)": (2, 20, 20, 2, 2, 16, 0, True, None, 1024),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_matches_reference(case):
    """The output, and the gradients of q, k and v (the port's flash
    backward against ``jax.vjp`` through the reference's scan)."""
    B, Sq, Sk, KV, G, hd, off, causal, window, chunk = FLASH_CASES[case]
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, Sq, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, KV, hd)).astype(np.float32)
    g = rng.standard_normal((B, Sq, KV, G, hd)).astype(np.float32)
    off = np.asarray(off, np.int32)
    ref, vjp = jax.vjp(lambda a, b, c: jblocks.flash_attention(
        a, b, c, causal=causal, q_offset=jnp.asarray(off), window=window,
        chunk=chunk), *map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    got = blocks.flash_attention(*ts, causal=causal,
                                 q_offset=torch.from_numpy(off),
                                 window=window, chunk=chunk)
    assert got.shape == ref.shape == (B, Sq, KV, G, hd)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=0)
    grads = torch.autograd.grad(got, ts, torch.from_numpy(g))
    for name, a, r in zip("qkv", grads, vjp(jnp.asarray(g))):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-5,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("case", list(FLASH_CASES)[:3])
def test_flash_attention_backward_is_the_gradient(case):
    """``_FlashAttention``'s backward (recomputed probabilities, ``dS = P ∘
    (dP - rowsum(dO ∘ O))``) against finite differences, in float64."""
    B, Sq, Sk, KV, G, hd, off, causal, window, chunk = FLASH_CASES[case]
    # small enough for finite differences: 2 heads in a group of width 2,
    # a ragged last chunk of 4 keys
    Sq, Sk, KV, G, hd, chunk = min(Sq, 6), min(Sk, 10), 1, 2, 2, 4
    window = window and 3
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(shape, generator=gen, dtype=torch.float64)
               for shape in ((B, Sq, KV, G, hd), (B, Sk, KV, hd),
                             (B, Sk, KV, hd)))
    pad = -(-Sk // chunk) * chunk - Sk
    k, v = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
            .requires_grad_(True) for t in (k, v))
    qpos = (torch.as_tensor(off).reshape(-1, 1) % Sk
            + torch.arange(Sq)).clamp(max=Sk - 1)
    assert torch.autograd.gradcheck(
        lambda a, b, c: blocks._FlashAttention.apply(
            a, b, c, qpos, Sk, chunk, causal, window),
        (q.requires_grad_(True), k, v))


def test_sliding_window_masks_distant_tokens():
    """The reference's test on the port: a key outside the window (64) must
    not move the output of the queries past it."""
    cfg = registry.get_config("mixtral-8x7b").reduced()
    assert cfg.sliding_window == 64
    gen = torch.Generator().manual_seed(0)
    B, S, H, hd = 1, 128, 2, 16
    q = torch.randn((B, S, H, 1, hd), generator=gen)
    k = torch.randn((B, S, H, hd), generator=gen)
    v = torch.randn((B, S, H, hd), generator=gen)
    out = blocks.flash_attention(q, k, v, causal=True, window=64, chunk=32)
    k2, v2 = k.clone(), v.clone()
    k2[:, 0] += 100.0
    v2[:, 0] -= 55.0
    out2 = blocks.flash_attention(q, k2, v2, causal=True, window=64,
                                  chunk=32)
    np.testing.assert_allclose(out[:, 64:].numpy(), out2[:, 64:].numpy(),
                               atol=1e-5)
    assert float((out[:, :64] - out2[:, :64]).abs().max()) > 1e-3


@pytest.mark.parametrize("window", [None, 8])
def test_decode_attention_matches_reference(window):
    rng = np.random.default_rng(1)
    B, Smax, KV, G, hd = 3, 40, 2, 3, 16
    q = rng.standard_normal((B, 1, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, Smax, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Smax, KV, hd)).astype(np.float32)
    index = np.asarray([5, 30, 39], np.int32)
    ref = np.asarray(jblocks._decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(index),
        window))
    got = blocks._decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   torch.from_numpy(index), window)
    assert got.shape == ref.shape == (B, 1, KV, G, hd)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


# =========================================================================
# The three archs end to end
# =========================================================================

@pytest.mark.parametrize("quant", ["fp32", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_loss_match_reference(arch, quant):
    jcfg, cfg, init = _setup(arch)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (2, SEQ[arch])).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    batch["labels"][:, -1] = -1
    jq, q = _quants(quant)

    def run_jax():
        jp = jax.tree.map(jnp.asarray, init)
        logits, x = jax.jit(lambda p, t: jlm.lm_prefill(p, t, jcfg, jq))(
            jp, jnp.asarray(toks))
        (loss, m), g = jax.jit(jax.value_and_grad(
            lambda p, b: jlm.lm_loss(p, b, jcfg, jq, None), has_aux=True))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
        return (np.asarray(logits), np.asarray(x), float(loss),
                float(m["aux"]), jax.tree.map(np.asarray, g))
    rlogits, rx, ref_loss, ref_aux, ref_grads = (
        _exact_scales(run_jax) if quant == "int8" else run_jax())

    params = params_from_jax(init)
    with torch.no_grad():
        logits, x = lm.lm_prefill(params, torch.from_numpy(toks), cfg, q)
    assert logits.shape == rlogits.shape == (2, 1, lm.padded_vocab(cfg))
    assert x.shape == rx.shape == (2, SEQ[arch], cfg.d_model)
    got, ref = logits.numpy()[..., :cfg.vocab], rlogits[..., :cfg.vocab]
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= (1e-5 if quant == "fp32" else 2e-3) \
        * np.abs(ref).max()

    loss, m, grads = trainer.loss_and_grads(
        lm.lm_loss, params_from_jax(init),
        {k: torch.from_numpy(v) for k, v in batch.items()}, cfg, q, None)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-6)
    if cfg.moe_experts:
        np.testing.assert_allclose(float(m["aux"]), ref_aux, rtol=1e-5)
    got, ref = dict(_leaves(grads)), dict(_leaves(ref_grads))
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        g = got[name].numpy()
        assert g.shape == r.shape and np.isfinite(g).all(), name
        err = np.abs(g - r).max() / np.abs(r).max()
        if quant == "fp32":
            assert err <= 1e-4, (name, err)
        elif (name in ("lm_head", "final_norm.g")
              or arch in TIGHT_INT8_GRADS):
            assert err <= 2e-3, (name, err)
        else:
            rel = np.linalg.norm(g - r) / np.linalg.norm(r)
            assert rel <= (0.5 if name in ("blocks.attn.wq", "blocks.attn.wk")
                           else 0.1), (name, rel)


def test_mixtral_decode_matches_prefill_past_the_window():
    """The reference's cache test on the port, with the window biting: 80
    tokens stepped one by one through the cache (``_decode_attention``)
    against the whole prompt's ``lm_prefill`` (``flash_attention``),
    FP32."""
    _, cfg, init = _setup("mixtral-8x7b")
    params = params_from_jax(init)
    T = SEQ["mixtral-8x7b"]
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, T)).astype(np.int32))
    q = QuantConfig.fp32()
    with torch.no_grad():
        pre, _ = lm.lm_prefill(params, toks, cfg, q)
        cache = lm.init_cache(cfg, 2, 96, device="cpu")
        for t in range(T):
            dec, cache = lm.lm_decode_step(params, toks[:, t:t + 1], cache,
                                           cfg, q)
    np.testing.assert_allclose(pre.numpy(), dec.numpy(), atol=2e-4)


def test_mixtral_moe_capacity_dispatch_matches_reference():
    """T·K = 4160 > 4096: the capacity dispatch (ceil128(1.25 · 4160 / 4)
    = 1408 rows per expert) at mixtral's reduced config, FP32."""
    jcfg, cfg, init = _setup("mixtral-8x7b")
    tree = {k: np.asarray(v[0]) for k, v in init["blocks"]["moe"].items()}
    x = np.random.default_rng(4).standard_normal(
        (4, 520, cfg.d_model)).astype(np.float32)
    assert 4 * 520 * cfg.moe_topk > 4096
    assert blocks.capacity(cfg, 4 * 520) == 1408
    ry, raux = jblocks.moe_apply(jax.tree.map(jnp.asarray, tree),
                                 jnp.asarray(x), jcfg, JQuantConfig.fp32(),
                                 None)
    y, aux = blocks.moe_apply({k: torch.tensor(v) for k, v in
                               tree.items()}, torch.from_numpy(x), cfg,
                              QuantConfig.fp32(), None)
    ry = np.asarray(ry)
    assert y.shape == x.shape
    assert np.abs(y.numpy() - ry).max() <= 1e-5 * np.abs(ry).max()
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)


def test_launchers_run_the_three_archs_on_cpu(caplog):
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    caplog.set_level("INFO")
    for arch in ARCHS:
        launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--requests", "2", "--prompt-len", "4",
                           "--max-new", "2"])
        losses = launch_train.main(["--arch", arch, "--reduced", "--device",
                                    "cpu", "--steps", "2", "--batch", "2",
                                    "--seq", "16", "--log-every", "1"])
        assert len(losses) == 2 and all(np.isfinite(losses))
        assert f"arch={arch}-smoke" in caplog.text
