"""Port parity of LM training: the reduced qwen1.5-0.5b and smollm-135m
(2 layers, d 128, 4 query heads over 2 kv heads, QKV bias and a tied head
on qwen) under ``int8`` (w8·a12·g8, integer RMS-norm and attention forward
and backward), round to nearest, from the reference's own ``lm_init``
weights (``convert.params_from_jax``), against the JAX ``value_and_grad(
lm.lm_loss)`` + ``optimizer.update`` loop on the pallas backend (kernels in
interpret mode).  ``test_torch_train_paths.py`` holds the reduced BERT
step under the plain ``int8`` preset, the data pipeline, microbatches and
the training launcher.

As in ``test_torch_finetune.py``, XLA:CPU's ``exp2`` is exact only for
integers in about [-12, 12] while gradient scales sit near -20, so:

* against the reference with ``jnp.exp2`` made exact for integer
  arguments (patched around one traced step, the jit caches cleared before
  and after): the first step's loss within 1e-6 relative and every
  parameter's first-step gradient within 2e-3 of its largest magnitude;
  the three steps' losses within 1e-4 relative.  The FP32 kept ops round
  differently on the two sides — XLA:CPU's ``rsqrt`` against the port's
  IEEE ``1 / sqrt`` in the RMS-norm, the SiLU's sigmoid — and an ulp there
  can move an a12 or g8 mantissa by one step; AdamW then carries that
  into the next steps' weights (measured: the third loss 3.0e-6 relative
  apart on qwen, 4.8e-5 on smollm; the first step's matmul gradients bit
  for bit);
* against the reference as it runs here: the three steps' losses within
  1e-3 relative.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.core.qconfig import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import finetune as tf  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import trainer  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several files at once, and
    small ops on many threads oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_OPT = dict(lr=1e-3, weight_decay=0.01)
_BATCH, _SEQ = 2, 24


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


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}.")
        else:
            yield prefix + k, tree[k]


def _batches(vocab, n):
    data = pipeline.SyntheticLM(pipeline.DataConfig(batch_size=_BATCH,
                                                    seq_len=_SEQ,
                                                    vocab=vocab))
    return [next(data) for _ in range(n)]


def _jax_loop(loss_fn, params, batches, cfg, steps, exact_exp2):
    """Losses of ``steps`` JAX steps and the first step's gradients."""
    qcfg = dataclasses.replace(JQuantConfig.int8(), backend="pallas",
                               stochastic_grad=False)
    ocfg = jopt.OptimizerConfig(**_OPT)

    @jax.jit
    def step(p, o, b):
        (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(
            p, b, cfg, qcfg, None)
        p, o, _ = jopt.update(ocfg, g, o, p)
        return p, o, loss, g

    mp = pytest.MonkeyPatch()
    jax.clear_caches()
    if exact_exp2:
        mp.setattr(jnp, "exp2", _exact_exp2_of(jnp.exp2))
        assert float(jnp.exp2(jnp.float32(-21))) == 2.0 ** -21
    try:
        p, o, losses, grads = params, jopt.init(params), [], None
        for b in batches[:steps]:
            p, o, loss, g = step(p, o, {k: jnp.asarray(v)
                                        for k, v in b.items()})
            losses.append(float(loss))
            grads = grads or jax.tree.map(np.asarray, g)
    finally:
        mp.undo()
        jax.clear_caches()
    return losses, grads


def _port_loop(loss_fn, init, batches, cfg, steps):
    step = trainer.make_train_step(
        loss_fn, cfg, dataclasses.replace(QuantConfig.int8(),
                                          stochastic_grad=False),
        topt.OptimizerConfig(**_OPT))
    grads_fn = trainer.make_grads_fn(
        loss_fn, cfg, dataclasses.replace(QuantConfig.int8(),
                                          stochastic_grad=False), 1)
    p = params_from_jax(init)
    grads, _ = grads_fn(p, tf.to_device(batches[0], "cpu"), None)
    o, losses = topt.init(p), []
    for b in batches[:steps]:
        p, o, m = step(p, o, tf.to_device(b, "cpu"), None)
        losses.append(float(m["loss"]))
    return losses, grads


@functools.lru_cache(maxsize=None)
def _lm_setup(arch):
    """The reduced arch's configs and the reference's ``lm_init`` weights
    (numpy; ``params_from_jax`` copies them), made once a module."""
    jcfg = jregistry.get_config(arch).reduced()
    init = jax.tree.map(np.asarray, jlm.lm_init(jax.random.PRNGKey(0), jcfg))
    return jcfg, registry.get_config(arch).reduced(), init


@functools.lru_cache(maxsize=None)
def _port_run(arch):
    """The port's three steps from the reference's weights, with the first
    step's gradients, run once a module: the exact-scale and the tracking
    tests hold the same port run against two reference runs."""
    jcfg, cfg, init = _lm_setup(arch)
    batches = _batches(cfg.vocab, 3)
    return batches, _port_loop(lm.lm_loss, init, batches, cfg, 3)


def _check_grads(grads, ref_grads):
    got = dict(_leaves(grads))
    ref = dict(_leaves(ref_grads))
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        g = got[name].numpy()
        assert g.shape == r.shape, name
        assert np.all(np.isfinite(g)), name
        assert np.abs(g - r).max() <= 2e-3 * np.abs(r).max(), name


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "smollm-135m"])
def test_lm_steps_match_reference_with_exact_scales(arch):
    jcfg, cfg, init = _lm_setup(arch)
    batches, (losses, grads) = _port_run(arch)
    ref_losses, ref_grads = _jax_loop(jlm.lm_loss, init, batches, jcfg, 3,
                                      exact_exp2=True)
    np.testing.assert_allclose(losses[0], ref_losses[0], rtol=1e-6)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    _check_grads(grads, ref_grads)


def test_lm_losses_track_reference():
    jcfg, cfg, init = _lm_setup("qwen1.5-0.5b")
    batches, (losses, _) = _port_run("qwen1.5-0.5b")
    ref_losses, _ = _jax_loop(jlm.lm_loss, init, batches, jcfg, 3,
                              exact_exp2=False)
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-3)


def test_params_from_jax_carries_lm_training_tree():
    for arch in ("qwen1.5-0.5b", "smollm-135m"):
        _, cfg, init = _lm_setup(arch)
        got = dict(_leaves(params_from_jax(init)))
        ref = dict(_leaves(init))
        assert sorted(got) == sorted(ref)
        for name, r in ref.items():
            np.testing.assert_array_equal(got[name].numpy(), r)
        own = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
        assert {k: tuple(v.shape) for k, v in _leaves(own)} == {
            k: r.shape for k, r in ref.items()}


