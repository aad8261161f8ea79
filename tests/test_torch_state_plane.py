"""Port parity of the state plane's training pieces: AdamW with int8
QTensor moments (``OptimizerConfig.state_bits``) and the int8 parameter
image (``TrainConfig.gather_bits``), against ``repro.train.optimizer`` and
``repro.train.trainer`` on the same numpy-seeded inputs.

* Three ``state_bits=8`` AdamW steps, the reference's stochastic-rounding
  noise (its ``fold_in(PRNGKey(seed), step)`` keys, split per leaf) fed in
  through ``update``'s ``noise`` callable.  The moments' exponents sit near
  -10 (m) and -20 (v), outside the window where XLA:CPU's ``exp2`` is
  exact, so the reference runs once with ``jnp.exp2`` made exact for
  integer arguments — planes and exponents then bit for bit, params
  within 1e-6 relative (f32 op order) — and once as it is: params within
  64 ulp of their magnitude, moment mantissa flips at most 1%.
* A reduced model's ``gather_bits=8`` gradient step (round to nearest,
  ``backend="pallas"`` on the reference side, exact scales): the loss
  within 1e-6 relative and each gradient within 2e-3 of its largest
  magnitude, the bound of ``test_torch_lm_train.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import qtensor as jq  # noqa: E402
from repro.core.qconfig import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import qtensor  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import finetune as tf  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from test_torch_lm_train import (_batches, _check_grads,  # noqa: E402
                                 _exact_exp2_of, _leaves, _lm_setup)

_KW = dict(lr=1e-2, weight_decay=0.01, grad_clip=1.0, state_bits=8, seed=3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many tiny ops: one intra-op thread keeps them from stalling on a CPU
    that other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng):
    return {"emb": rng.standard_normal((12, 8)).astype(np.float32),
            "blocks": {"w": rng.standard_normal((3, 8, 6)).astype(np.float32),
                       "g": rng.standard_normal((3, 8)).astype(np.float32)},
            "b": rng.standard_normal(6).astype(np.float32)}


def _ref_noise(seed):
    """The reference's SR noise for ``update(..., noise=...)``."""
    def noise(step, i, which):
        base = jax.random.fold_in(jax.random.PRNGKey(seed), step)
        km, kv = jax.random.split(jax.random.fold_in(base, i))
        k = km if which == "m" else kv
        return lambda shape, device: torch.from_numpy(np.array(
            jax.random.uniform(k, shape, jnp.float32)))
    return noise


def _steps(exact_exp2):
    """(reference params and state, port params and state) after three
    ``state_bits=8`` steps from the same tree and gradients."""
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) *
                                     0.3).astype(np.float32), tree)
             for _ in range(3)]
    mp = pytest.MonkeyPatch()
    jax.clear_caches()
    if exact_exp2:
        mp.setattr(jnp, "exp2", _exact_exp2_of(jnp.exp2))
    try:
        update = jax.jit(jopt.update, static_argnums=0)
        jp = jax.tree.map(jnp.asarray, tree)
        js = jopt.init(jp, jopt.OptimizerConfig(**_KW))
        for g in grads:
            jp, js, _ = update(jopt.OptimizerConfig(**_KW),
                               jax.tree.map(jnp.asarray, g), js, jp)
    finally:
        mp.undo()
        jax.clear_caches()
    tp = params_from_jax(tree)
    ts = topt.init(tp, topt.OptimizerConfig(**_KW))
    for g in grads:
        tp, ts, _ = topt.update(topt.OptimizerConfig(**_KW),
                                params_from_jax(g), ts, tp,
                                noise=_ref_noise(_KW["seed"]))
    return jp, js, tp, ts


def _pairs(js, ts):
    """(port QTensor, reference QTensor) for every moment leaf (a QTensor
    is a leaf of both nested dicts)."""
    out = []
    for jt, tt in ((js.m, ts.m), (js.v, ts.v)):
        ref, got = dict(_leaves(jt)), dict(_leaves(tt))
        assert sorted(ref) == sorted(got)
        out += [(got[k], ref[k]) for k in sorted(ref)]
    return out


def test_state_bits_steps_match_reference_with_exact_scales():
    jp, js, tp, ts = _steps(exact_exp2=True)
    assert int(ts.step) == int(js.step) == 3
    for got, ref in _pairs(js, ts):
        assert qtensor.is_qtensor(got) and got.bits == 8
        assert got.exp.shape == tuple(ref.exp.shape)
        np.testing.assert_array_equal(got.m.numpy(), np.asarray(ref.m))
        np.testing.assert_array_equal(got.exp.numpy(), np.asarray(ref.exp))
    ref = dict(_leaves(jax.tree.map(np.asarray, jp)))
    for name, p in _leaves(tp):
        np.testing.assert_allclose(p.numpy(), ref[name], rtol=1e-6,
                                   atol=1e-7, err_msg=name)


def test_state_bits_steps_track_reference_as_it_runs():
    jp, js, tp, ts = _steps(exact_exp2=False)
    flips = total = 0
    for got, ref in _pairs(js, ts):
        np.testing.assert_array_equal(got.exp.numpy(), np.asarray(ref.exp))
        flips += int((got.m.numpy() != np.asarray(ref.m)).sum())
        total += got.m.numel()
    assert flips <= 0.01 * total, (flips, total)
    ref = dict(_leaves(jax.tree.map(np.asarray, jp)))
    for name, p in _leaves(tp):
        r = ref[name]
        assert np.abs(p.numpy() - r).max() <= 64 * 2.0 ** -23 * \
            np.abs(r).max(), name


def test_state_bits_layout_and_default_noise_replays():
    """Moments group per leading slice for ndim >= 2; the default noise is
    a function of (seed, step, leaf, m | v), so an update from a copy of
    the state draws the same."""
    rng = np.random.default_rng(1)
    tp = params_from_jax(_tree(rng))
    cfg = topt.OptimizerConfig(**_KW)
    ts = topt.init(tp, cfg)
    assert ts.m["emb"].exp.shape == (12, 1) and ts.m["b"].exp.shape == ()
    assert ts.v["blocks"]["w"].exp.shape == (3, 1, 1)
    g = params_from_jax(_tree(rng))

    def run():
        p = topt.tree_map(torch.clone, tp)
        s = topt.OptState(ts.step.clone(), ts.m, ts.v)
        for _ in range(2):
            p, s, _ = topt.update(cfg, g, s, p)
        return p, s
    (p1, s1), (p2, s2) = run(), run()
    for (_, a), (_, b) in zip(_leaves(p1), _leaves(p2)):
        assert torch.equal(a, b)
    for (_, a), (_, b) in zip(_leaves(s1.m), _leaves(s2.m)):
        assert torch.equal(a.m, b.m) and torch.equal(a.exp, b.exp)
    g8 = topt.moment_generator(3, 1, 0, "m", "cpu")
    assert not torch.equal(torch.rand(4, generator=g8), torch.rand(
        4, generator=topt.moment_generator(3, 1, 0, "v", "cpu")))


def test_moment_tree_mismatch_raises():
    params = {"a": torch.zeros(3), "b": torch.zeros(2)}
    cfg = topt.OptimizerConfig(state_bits=8)
    state = topt.init(params, cfg)
    with pytest.raises(ValueError, match="gradient"):
        topt.update(cfg, {"a": torch.zeros(3)}, state, params)
    with pytest.raises(ValueError, match="moment"):
        topt.update(cfg, params, topt.OptState(state.step,
                                               {"a": state.m["a"]}, state.v),
                    params)


def test_quantized_moments_converge_quadratic():
    """state_bits=8 AdamW still optimizes a quadratic: the SR EMA keeps the
    moments unbiased and the v floor keeps sub-step entries from exploding
    the denominator."""
    cfg = topt.OptimizerConfig(lr=0.1, weight_decay=0.0, grad_clip=0,
                               state_bits=8)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = topt.init(params, cfg)
    target = torch.tensor([1.0, 2.0])
    for _ in range(300):
        params, state, _ = topt.update(
            cfg, {"w": 2 * (params["w"] - target)}, state, params)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=0.05)
    assert qtensor.is_qtensor(state.m["w"]) and state.v["w"].bits == 8


def test_gather_bits_step_matches_reference():
    jcfg, cfg, init = _lm_setup("smollm-135m")
    b = _batches(cfg.vocab, 1)[0]
    qj = dataclasses.replace(JQuantConfig.int8(), backend="pallas",
                             stochastic_grad=False)

    def jloss(p, batch):
        qp = jax.tree.map(lambda x: jq.fake_quant_ste(x, 8), p)
        return jlm.lm_loss(qp, batch, jcfg, qj, None)[0]

    mp = pytest.MonkeyPatch()
    jax.clear_caches()
    mp.setattr(jnp, "exp2", _exact_exp2_of(jnp.exp2))
    try:
        ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(
            jax.tree.map(jnp.asarray, init),
            {k: jnp.asarray(v) for k, v in b.items()})
        ref_grads = jax.tree.map(np.asarray, ref_grads)
    finally:
        mp.undo()
        jax.clear_caches()
    q = dataclasses.replace(QuantConfig.int8(), stochastic_grad=False)
    grads, m = trainer.make_grads_fn(lm.lm_loss, cfg, q, 1, gather_bits=8)(
        params_from_jax(init), tf.to_device(b, "cpu"), None)
    np.testing.assert_allclose(float(m["loss"]), float(ref_loss), rtol=1e-6)
    _check_grads(grads, ref_grads)
    # the train step with the same config runs the same gradient and
    # updates the FP32 masters
    step = trainer.make_train_step(
        lm.lm_loss, cfg, q, topt.OptimizerConfig(lr=1e-3),
        trainer.TrainConfig(gather_bits=8))
    p = params_from_jax(init)
    p, _, m2 = step(p, topt.init(p), tf.to_device(b, "cpu"), None)
    assert float(m2["loss"]) == float(m["loss"])
    assert not torch.equal(p["embed"], params_from_jax(init)["embed"])
