"""Port parity of the SSM family (mamba2-370m): ``int_conv1d_depthwise``,
the SSD scan (``models/ssm.py``), ``mamba2_apply`` in training and in
decode, the reduced model's loss and gradients, decode against prefill,
``Engine.generate`` and the batcher with SSM slots, remat under
stochastic rounding, the probe set, and the config — each against the JAX
package (``backend="pallas"``, kernels in interpret mode, round to
nearest unless stated) on the same numpy inputs or the reference's own
weights (``convert.params_from_jax``).

Stated tolerances:

* ``int_conv1d_depthwise``, int8 and int16, forward and backward: bit for
  bit, at amplitudes that keep every exponent inside XLA:CPU's exact
  ``exp2`` window (caveat A; the port's ``pow2`` is exact everywhere); the
  digit
  split bit for bit; ``stochastic_fwd`` (and ``stochastic_grad``) with the
  reference's own noise fed in through a callable key, bit for bit.
* ``_segsum``, ``ssd_chunked`` over several chunks with an initial state,
  and ``ssd_decode_step``: within rtol 1e-5 / atol 1e-5 (the same f32
  operations; einsum orders differ in the last ulps).
* ``mamba2_apply``: FP32 within 1e-5 of max|out|; int8 (exact scales)
  within 2e-3 of max|out| (softplus, exp and SiLU round differently on
  the two sides and move an a12 mantissa now and then, as in
  ``test_torch_archs.py``); the decode states within 1e-5 of their max.
* The reduced model: FP32 loss within 1e-6 relative, every gradient within
  1e-4 of its max; int8 (exact scales) loss within 1e-6 relative, the
  head's and the final norm's gradients within 2e-3 of their max, every
  other gradient within 10% of its norm (``test_torch_archs.py``'s bands,
  caveat B: g8 mantissas one step apart below the head).
* Decode against prefill, FP32: within 2e-4 absolute, the reference's own
  test's bound, over one chunk (8 tokens) and over two (32).
* ``Engine.generate``: greedy tokens equal, the teacher-forced prompt's
  last logits within 1e-5 (FP32) / 5e-3 (int8) of their max.
* Remat on against off under stochastic forward and gradient rounding:
  bit for bit, the generator's final state too.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.core import health as jhealth  # noqa: E402
from repro.core import int_ops as jint_ops  # noqa: E402
from repro.core.qconfig import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import health, int_ops  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.models import lm, ssm  # noqa: E402
from repro_torch.serve.engine import (ContinuousBatcher, Engine,  # noqa: E402
                                      ServeConfig)
from repro_torch.train import trainer  # noqa: E402
from test_torch_archs import _exact_scales, _leaves  # noqa: E402
from test_torch_serve import _run_tracked  # noqa: E402

ARCH = "mamba2-370m"
KEY = jax.random.PRNGKey(0)
#: amplitude that keeps every conv exponent (quantization and product) in
#: XLA:CPU's exact exp2 window
AMP = {"int8": 8.0, "int16": 300.0}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many tiny ops: one intra-op thread keeps them from stalling on a CPU
    that other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quants(quant, **kw):
    if quant == "fp32":
        return JQuantConfig.fp32(), QuantConfig.fp32()
    kw = {"stochastic_grad": False, **kw}
    return (dataclasses.replace(JQuantConfig.preset(quant), backend="pallas",
                                **kw),
            dataclasses.replace(QuantConfig.preset(quant), **kw))


@functools.lru_cache(maxsize=None)
def _setup(arch=ARCH):
    """The reduced configs (reference, port) and the reference's own init
    as numpy arrays (read only: ``params_from_jax`` copies)."""
    jcfg = jregistry.get_config(arch).reduced()
    cfg = registry.get_config(arch).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg, jax.tree.map(np.asarray, jlm.lm_init(KEY, jcfg))


# =========================================================================
# Config
# =========================================================================

def test_config_is_the_reference_config():
    cfg = registry.get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jregistry.get_config(ARCH))
    assert (cfg.d_inner, cfg.ssm_nheads) == (2048, 32)
    assert abs(cfg.param_count() - 370e6) / 370e6 < 0.15
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
        jregistry.get_config(ARCH).reduced())


# =========================================================================
# int_conv1d_depthwise
# =========================================================================

def _conv_inputs(preset, seed):
    rng = np.random.default_rng(seed)
    a = AMP[preset]
    x = (a * rng.standard_normal((2, 12, 8))).astype(np.float32)
    w = (a * rng.standard_normal((4, 8))).astype(np.float32)
    cot = (a * rng.standard_normal((2, 12, 8))).astype(np.float32)
    return x, w, cot


def _conv_both(preset, x, w, cot, jkey=None, tkey=None, **kw):
    jq, q = _quants(preset, **kw)

    def run():
        y, vjp = jax.vjp(lambda a, b: jint_ops.int_conv1d_depthwise(
            a, b, jkey, jq), jnp.asarray(x), jnp.asarray(w))
        return (np.asarray(y),) + tuple(
            np.asarray(r) for r in vjp(jnp.asarray(cot)))
    ref = run()
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    y = int_ops.int_conv1d_depthwise(xt, wt, tkey, q)
    y.backward(torch.from_numpy(cot))
    return ref, (y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy())


@pytest.mark.parametrize("preset", ["int8", "int16"])
def test_conv_forward_and_backward_bit_for_bit(preset):
    x, w, cot = _conv_inputs(preset, len(preset))
    ref, got = _conv_both(preset, x, w, cot)
    for name, g, r in zip(("y", "dx", "dw"), got, ref):
        assert np.abs(r).max() > 0, name
        np.testing.assert_array_equal(g, r, err_msg=name)


def test_conv_digits_match_reference():
    m = np.arange(-32767, 32768, 7, dtype=np.int16)
    hi, lo = int_ops._conv_digits(torch.from_numpy(m))
    rhi, rlo = jint_ops._conv_digits(jnp.asarray(m))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(rhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(rlo))
    assert int(lo.abs().max()) <= 128 and int(hi.abs().max()) <= 128
    np.testing.assert_array_equal(hi.numpy() * 256 + lo.numpy(), m)


@pytest.mark.parametrize("grad", [False, True])
def test_conv_stochastic_with_reference_noise(grad):
    """``stochastic_fwd`` (and ``stochastic_grad``): the reference splits its
    key, the forward noise from the split-off half over x's 2-D view, the
    gradient's from the rest; the port draws the same arrays through a
    callable key, forward first."""
    x, w, cot = _conv_inputs("int8", 7)
    key = jax.random.PRNGKey(11)
    rest, kf = jax.random.split(key)
    noise = [np.array(jax.random.uniform(kf, (24, 8), dtype=jnp.float32))]
    if grad:
        noise.append(np.array(jax.random.uniform(rest, (24, 8),
                                                 dtype=jnp.float32)))
    draws = iter(noise)

    def tkey(shape, device):
        u = next(draws)
        assert tuple(shape) == u.shape
        return torch.from_numpy(u)
    ref, got = _conv_both("int8", x, w, cot, key, tkey, stochastic_fwd=True,
                          stochastic_grad=grad)
    assert next(draws, None) is None                    # every draw taken
    for name, g, r in zip(("y", "dx", "dw"), got, ref):
        np.testing.assert_array_equal(g, r, err_msg=name)
    rn, _ = _conv_both("int8", x, w, cot)
    assert np.abs(got[0] - rn[0]).max() > 0             # the noise bit


def test_conv_disabled_is_the_plain_sum():
    x, w, _ = _conv_inputs("int8", 3)
    ref = jint_ops.int_conv1d_depthwise(jnp.asarray(x), jnp.asarray(w), None,
                                        JQuantConfig.fp32())
    got = int_ops.int_conv1d_depthwise(torch.from_numpy(x),
                                       torch.from_numpy(w), None,
                                       QuantConfig.fp32())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


# =========================================================================
# The SSD scan
# =========================================================================

def test_segsum_matches_reference():
    x = np.random.default_rng(0).standard_normal((3, 2, 9)).astype(
        np.float32)
    got = ssm._segsum(torch.from_numpy(x)).numpy()
    ref = np.asarray(jssm._segsum(jnp.asarray(x)))
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=1e-5)


def _ssd_inputs(b=2, L=48, H=3, P=4, N=5, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, L, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, L, H)))).astype(np.float32)
    A = -np.arange(1, H + 1, dtype=np.float32) * 0.3
    B = rng.standard_normal((b, L, N)).astype(np.float32)
    C = rng.standard_normal((b, L, N)).astype(np.float32)
    s0 = rng.standard_normal((b, H, P, N)).astype(np.float32)
    return x, dt, A, B, C, s0


def test_ssd_chunked_over_chunks_with_init_state():
    args = _ssd_inputs()
    y, s = ssm.ssd_chunked(*map(torch.from_numpy, args[:5]), 16,
                           torch.from_numpy(args[5]))
    ry, rs = jssm.ssd_chunked(*map(jnp.asarray, args[:5]), 16,
                              jnp.asarray(args[5]))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(AssertionError):
        ssm.ssd_chunked(*map(torch.from_numpy, args[:5]), 20)


def test_ssd_decode_step_matches_reference_and_the_scan():
    x, dt, A, B, C, s0 = _ssd_inputs(L=16)
    state = torch.from_numpy(s0)
    rstate = jnp.asarray(s0)
    ys = []
    for t in range(16):
        args = (x[:, t], dt[:, t], A, B[:, t], C[:, t])
        state, y = ssm.ssd_decode_step(state, *map(torch.from_numpy, args))
        rstate, ry = jssm.ssd_decode_step(rstate, *map(jnp.asarray, args))
        np.testing.assert_allclose(y.numpy(), np.asarray(ry), rtol=1e-5,
                                   atol=1e-5)
        ys.append(y)
    np.testing.assert_allclose(state.numpy(), np.asarray(rstate), rtol=1e-5,
                               atol=1e-5)
    # the chunked scan over the same tokens from the same state
    yc, sc = ssm.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)), 8,
                             torch.from_numpy(s0))
    np.testing.assert_allclose(yc.numpy(), torch.stack(ys, 1).numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sc.numpy(), state.numpy(), rtol=1e-4,
                               atol=1e-4)


# =========================================================================
# mamba2_apply
# =========================================================================

def _layer(init, i=0):
    return {k: v[i] for k, v in init["blocks"]["mamba"].items()}


@pytest.mark.parametrize("quant", ["fp32", "int8"])
def test_mamba2_apply_training_and_decode(quant):
    jcfg, cfg, init = _setup()
    jq, q = _quants(quant)
    p = _layer(init)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    states = [rng.standard_normal(s.shape).astype(np.float32) for s in
              ssm.mamba2_init_state(cfg, 2, "cpu")]

    @jax.jit
    def both(jp, x, x1, states):
        y, (fin, _, _) = jssm.mamba2_apply(jp, x, jcfg, jq, None)
        yd, sd = jssm.mamba2_apply(jp, x1, jcfg, jq, None, state=states,
                                   decode=True)
        return y, fin, yd, sd

    def run():
        out = both(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                   jnp.asarray(x1), tuple(map(jnp.asarray, states)))
        return jax.tree.map(np.asarray, out)
    ry, rfin, ryd, rsd = _exact_scales(run) if quant != "fp32" else run()
    tp = params_from_jax(p)
    with torch.no_grad():
        y, (fin, n1, n2) = ssm.mamba2_apply(tp, torch.from_numpy(x), cfg, q,
                                            None)
        yd, sd = ssm.mamba2_apply(tp, torch.from_numpy(x1), cfg, q, None,
                                  state=tuple(map(torch.from_numpy, states)),
                                  decode=True)
    assert n1 is None and n2 is None
    tol = 1e-5 if quant == "fp32" else 2e-3
    for g, r in ((y, ry), (yd, ryd)):
        assert g.shape == r.shape
        assert np.abs(g.numpy() - r).max() <= tol * np.abs(r).max()
    for g, r in zip((fin,) + tuple(sd), (rfin,) + tuple(rsd)):
        assert g.shape == r.shape
        assert np.abs(g.numpy() - r).max() <= 1e-5 * np.abs(r).max() + 1e-6


# =========================================================================
# The reduced model
# =========================================================================

def _batch(cfg, S=32, seed=2):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (2, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": toks, "labels": labels}


def check_loss_and_grads(arch, quant, extra=None):
    """One ``lm_loss`` step of ``arch``'s reduced config against the
    reference's, both from the reference's weights (shared with
    ``test_torch_hybrid_vlm.py``)."""
    jcfg, cfg, init = _setup(arch)
    batch = dict(_batch(cfg), **(extra or {}))
    jq, q = _quants(quant)

    def run():
        (loss, _), g = jax.jit(jax.value_and_grad(
            lambda p, b: jlm.lm_loss(p, b, jcfg, jq, None), has_aux=True))(
            jax.tree.map(jnp.asarray, init),
            {k: jnp.asarray(v) for k, v in batch.items()})
        return float(loss), jax.tree.map(np.asarray, g)
    ref_loss, ref_grads = _exact_scales(run) if quant != "fp32" else run()
    loss, _, grads = trainer.loss_and_grads(
        lm.lm_loss, params_from_jax(init),
        {k: torch.from_numpy(v) for k, v in batch.items()}, cfg, q, None)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-6)
    got, ref = dict(_leaves(grads)), dict(_leaves(ref_grads))
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        g = got[name].numpy()
        assert g.shape == r.shape and np.isfinite(g).all(), name
        err = np.abs(g - r).max() / np.abs(r).max()
        if quant == "fp32":
            assert err <= 1e-4, (name, err)
        elif name in ("lm_head", "final_norm.g"):
            assert err <= 2e-3, (name, err)
        else:
            rel = np.linalg.norm(g - r) / np.linalg.norm(r)
            assert rel <= 0.1, (name, rel)
    return got


@pytest.mark.parametrize("quant", ["fp32", "int8"])
def test_loss_and_grads_match_reference(quant):
    got = check_loss_and_grads(ARCH, quant)
    assert any(k.startswith("blocks.mamba.conv_x") for k in got)


@pytest.mark.parametrize("T", [8, 32])
def test_decode_matches_prefill(T):
    """The reference's cache test on the port, over one chunk and two."""
    _, cfg, init = _setup()
    params = params_from_jax(init)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, T)).astype(np.int32))
    q = QuantConfig.fp32()
    with torch.no_grad():
        pre, _ = lm.lm_prefill(params, toks, cfg, q)
        cache = lm.init_cache(cfg, 2, 40, device="cpu")
        assert set(cache) == {"ssm", "conv_x", "conv_BC", "index"}
        assert all(v.dtype == torch.float32 for k, v in cache.items()
                   if k != "index")
        for t in range(T):
            dec, cache = lm.lm_decode_step(params, toks[:, t:t + 1], cache,
                                           cfg, q)
    np.testing.assert_allclose(pre.numpy(), dec.numpy(), atol=2e-4)
    assert cache["index"].tolist() == [T, T]
    with pytest.raises(ValueError):
        lm.lm_prefill_cache(params, toks, cache, cfg, q)


@pytest.mark.parametrize("preset,tol", [("fp32", 1e-5), ("int8", 5e-3)])
def test_greedy_generate_matches_reference(preset, tol):
    jcfg, cfg, init = _setup()
    B, S, NEW, SMAX = 2, 5, 4, 16
    prompts = np.random.default_rng(4).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    jq = JQuantConfig.preset(preset)
    if jq.enabled:
        jq = dataclasses.replace(jq, backend="pallas")
    ref = jengine.Engine(jax.tree.map(jnp.asarray, init), jcfg, jq,
                         jengine.ServeConfig(max_seq=SMAX, batch_slots=B))
    assert ref._prefill is None
    ref_tokens = np.asarray(ref.generate(prompts, NEW))
    cache = jlm.init_cache(jcfg, B, SMAX, dtype=jnp.float32)
    for t in range(S):
        ref_logits, cache = ref._decode(ref.params,
                                        jnp.asarray(prompts[:, t:t + 1]),
                                        cache)
    ref_logits = np.asarray(ref_logits)
    eng = Engine(params_from_jax(init), cfg, QuantConfig.preset(preset),
                 ServeConfig(max_seq=SMAX, batch_slots=B), device="cpu")
    assert eng.steps_prompts
    tokens = eng.generate(prompts, NEW)
    np.testing.assert_array_equal(tokens, ref_tokens)
    cache = eng.init_cache(B)
    for t in range(S):
        logits, cache = eng._decode(eng.params,
                                    torch.from_numpy(prompts[:, t:t + 1]),
                                    cache)
    assert np.abs(logits.numpy() - ref_logits).max() <= \
        tol * np.abs(ref_logits).max()


def test_batcher_with_ssm_slots_interleaved_matches_sequential():
    """Admission teacher-forces the prompt through decode steps and
    restores the other slots' SSM and conv states from its snapshot: with
    rows independent (FP32) interleaved decoding equals each request run
    alone, logits rows included."""
    _, cfg, init = _setup()
    engine = Engine(params_from_jax(init), cfg, QuantConfig.fp32(),
                    ServeConfig(max_seq=32, batch_slots=2), device="cpu")
    rng = np.random.default_rng(1)
    pa = rng.integers(0, cfg.vocab, 6)
    pb = rng.integers(0, cfg.vocab, 4)
    (ra,), ta, res_a = _run_tracked(engine, cfg, [(pa, 5, 0)])
    (rb,), tb, res_b = _run_tracked(engine, cfg, [(pb, 5, 0)])
    (ia, ib), ti, res = _run_tracked(engine, cfg, [(pa, 5, 0), (pb, 5, 2)])
    np.testing.assert_array_equal(res[ia], res_a[ra])
    np.testing.assert_array_equal(res[ib], res_b[rb])
    for solo, inter in [(ta[ra], ti[ia]), (tb[rb], ti[ib])]:
        assert len(solo) == len(inter)
        for ls, li in zip(solo, inter):
            torch.testing.assert_close(ls, li, rtol=0, atol=1e-6)


def test_int8_batcher_with_ssm_slots_drains():
    _, cfg, init = _setup()
    engine = Engine(params_from_jax(init), cfg, registry.get_quant("int8"),
                    ServeConfig(max_seq=32, batch_slots=2), device="cpu")
    b = ContinuousBatcher(engine)
    rng = np.random.default_rng(0)
    ids = [b.submit(rng.integers(0, cfg.vocab, 5), 3) for _ in range(3)]
    res = b.run_until_drained()
    assert sorted(res) == ids and all(len(res[i]) == 3 for i in ids)
    assert not b.failed


# =========================================================================
# Remat, probes, conversion
# =========================================================================

STOCHASTIC = dataclasses.replace(QuantConfig.int8(), stochastic_grad=True,
                                 stochastic_fwd=True)


def remat_step(monkeypatch, arch, remat, S=32):
    """One ``lm_loss`` forward and backward with remat as given: (loss,
    {name: gradient}, the generator's final state, calls of
    ``mamba2_apply``)."""
    cfg = registry.get_config(arch).reduced()
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    leaves = dict(_leaves(params))
    for t in leaves.values():
        t.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (2, S),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    gen = torch.Generator().manual_seed(2)
    calls = []
    apply = ssm.mamba2_apply

    def counted(*a, **kw):
        calls.append(1)
        return apply(*a, **kw)
    monkeypatch.setattr(ssm, "mamba2_apply", counted)
    monkeypatch.setattr(lm, "_backbone_train", functools.partial(
        lm._backbone_train, remat=remat))
    loss, _ = lm.lm_loss(params, batch, cfg, STOCHASTIC, gen)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    monkeypatch.undo()
    return (loss.detach(), dict(zip(leaves, grads)), gen.get_state(),
            len(calls))


def test_remat_replays_the_forward_noise_bit_for_bit(monkeypatch):
    loss, grads, state, calls = remat_step(monkeypatch, ARCH, True)
    loss0, grads0, state0, calls0 = remat_step(monkeypatch, ARCH, False)
    n = registry.get_config(ARCH).reduced().n_layers
    assert (calls, calls0) == (2 * n, n)
    assert torch.equal(loss, loss0)
    for name, g in grads.items():
        assert torch.isfinite(g).all() and g.abs().max() > 0, name
        assert torch.equal(g, grads0[name]), name
    assert torch.equal(state, state0)


def test_probe_set_is_the_reference_set():
    """The SSM stack runs with probes suspended, as the reference's: the
    embedding, the final norm and the head report, no layer does."""
    jcfg, cfg, init = _setup()
    b = _batch(cfg)
    jq, q = _quants("int8")

    def probed(p, batch):
        with jhealth.collect() as hp:
            jlm.lm_loss(p, batch, jcfg, jq, None)
        return hp
    ref = jax.jit(probed)(jax.tree.map(jnp.asarray, init),
                          {k: jnp.asarray(v) for k, v in b.items()})
    with health.collect() as hp:
        lm.lm_loss(params_from_jax(init),
                   {k: torch.from_numpy(v) for k, v in b.items()}, cfg, q,
                   None)
    assert sorted(hp) == sorted(ref) == ["embed", "final_norm", "lm_head"]
    for tag in hp:
        assert float(hp[tag]["exp"]) == float(ref[tag]["exp"]), tag


def test_params_from_jax_carries_the_ssm_tree():
    _, cfg, init = _setup()
    params = params_from_jax(init)
    ref = dict(_leaves(init))
    got = dict(_leaves(params))
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        np.testing.assert_array_equal(got[name].numpy(), r, err_msg=name)
    own = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in _leaves(own)} == {
        k: r.shape for k, r in ref.items()}
