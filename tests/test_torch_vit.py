"""Port parity of ViT (the paper's Table 3 model): a reduced ViT (2
layers, d 64, 16 x 16 images in 8 x 8 patches: 5 tokens) from the
reference's own weights (``convert.params_from_jax``), against the JAX
package on the pallas backend (kernels in interpret mode).

* ``int_patch_embed``: the patch order and the integer product bit for
  bit (with ``jnp.exp2`` made exact for integer arguments, caveat A's
  window checked at run time), FP32 within f32 rounding;
* ``vit_apply``'s logits under int8, and two int8 round-to-nearest
  training steps, held as ``test_torch_finetune.py`` holds BERT's: with
  exact ``exp2`` patched in, the logits within 1e-5 of their largest
  magnitude, the losses within 1e-6 relative and the first step's
  gradients within 2e-3 of each one's largest magnitude; as the reference
  runs here, the losses within 1e-3;
* ``params_from_jax`` carries the ViT tree, and the port's own init has
  the same tree.
"""
import contextlib
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import int_ops as jint_ops  # noqa: E402
from repro.core.qconfig import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import paper_models as jpm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import int_ops  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.models import paper_models as pm  # noqa: E402
from repro_torch.train import finetune as tf  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402

IMG, PATCH = 16, 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several files at once, and
    small ops on many threads oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, img=IMG,
             patch=PATCH, name="vit-2l-d64")
SAMPLER = tf.make_img_task(img=IMG, patch=PATCH)
OPT = dict(lr=1e-3, weight_decay=0.0)


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


class _ExactExp2:
    """``jnp.exp2`` exact at integer arguments inside the block (every jit
    cache cleared on the way in and out)."""

    def __enter__(self):
        self.mp = pytest.MonkeyPatch()
        jax.clear_caches()
        self.mp.setattr(jnp, "exp2", _exact_exp2_of(jnp.exp2))
        assert float(jnp.exp2(jnp.float32(-21))) == 2.0 ** -21

    def __exit__(self, *exc):
        self.mp.undo()
        jax.clear_caches()


def _jq(base=None):
    return dataclasses.replace(base or JQuantConfig.int8(), backend="pallas",
                               stochastic_grad=False)


def _q():
    return dataclasses.replace(QuantConfig.int8(), stochastic_grad=False)


def _init(seed=0, num_classes=4):
    cfg = jpm.vit_config(**SMALL)
    return cfg, jpm.vit_init(jax.random.PRNGKey(seed), cfg,
                             num_classes=num_classes, img=IMG, patch=PATCH)


def test_window_of_exact_exp2_is_as_documented():
    """Caveat A at run time: inside [-12, 12] XLA:CPU's exp2 is exact, so
    the bit-for-bit claims below rest on the patch only outside it."""
    for n in range(-12, 13):
        assert float(jnp.exp2(jnp.float32(n))) == np.ldexp(1.0, n)


@pytest.mark.parametrize("preset", ["int8", "int16", "fp32"])
def test_int_patch_embed_matches_reference(preset):
    rng = np.random.default_rng(1)
    images = rng.standard_normal((3, IMG, IMG, 3)).astype(np.float32)
    w = (0.02 * rng.standard_normal((PATCH * PATCH * 3, 64))).astype(
        np.float32)
    b = (0.01 * rng.standard_normal(64)).astype(np.float32)
    jq = _jq(JQuantConfig.preset(preset))
    with _ExactExp2():
        ref = np.asarray(jint_ops.int_patch_embed(
            jnp.asarray(images), jnp.asarray(w), jnp.asarray(b), None, jq,
            PATCH))
    got = int_ops.int_patch_embed(
        torch.from_numpy(images), torch.from_numpy(w), torch.from_numpy(b),
        None, dataclasses.replace(QuantConfig.preset(preset),
                                  stochastic_grad=False), PATCH).numpy()
    assert got.shape == ref.shape == (3, (IMG // PATCH) ** 2, 64)
    if preset == "fp32":
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, ref)


def _jax_steps(steps, exact_exp2):
    cfg, params = _init()
    jq = _jq()
    ocfg = jopt.OptimizerConfig(**OPT)

    @jax.jit
    def step(p, o, b):
        (loss, aux), g = jax.value_and_grad(lambda p: jpm.vit_cls_loss(
            p, b, cfg, jq, None, patch=PATCH), has_aux=True)(p)
        p, o, _ = jopt.update(ocfg, g, o, p)
        return p, o, loss, g, aux["logits"]

    init = jax.tree.map(np.asarray, params)
    losses, grads, logits = [], None, None
    with _ExactExp2() if exact_exp2 else contextlib.nullcontext():
        p, o = params, jopt.init(params)
        for i in range(steps):
            b = {k: jnp.asarray(v) for k, v in SAMPLER(4, i).items()}
            p, o, loss, g, lg = step(p, o, b)
            losses.append(float(loss))
            grads = grads or jax.tree.map(np.asarray, g)
            logits = np.asarray(lg) if logits is None else logits
    return init, losses, grads, logits


def _port_steps(init, steps):
    cfg = pm.vit_config(**SMALL)
    loss_fn = functools.partial(pm.vit_cls_loss, patch=PATCH)
    ocfg = topt.OptimizerConfig(**OPT)
    p = params_from_jax(init)
    o, losses, grads = topt.init(p), [], None
    for i in range(steps):
        batch = tf.to_device(SAMPLER(4, i), "cpu")
        assert batch["images"].dtype == torch.float32
        p, o, loss, g, _ = tf.train_step(p, o, batch, cfg, _q(), loss_fn,
                                         ocfg, None)
        losses.append(float(loss))
        grads = grads or g
    return losses, grads


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}.")
        else:
            yield prefix + k, tree[k]


def test_vit_steps_match_reference_with_exact_scales():
    init, ref_losses, ref_grads, ref_logits = _jax_steps(2, exact_exp2=True)
    logits = pm.vit_apply(params_from_jax(init),
                          torch.from_numpy(SAMPLER(4, 0)["images"]),
                          pm.vit_config(**SMALL), _q(), None,
                          patch=PATCH).detach().numpy()
    assert logits.shape == ref_logits.shape == (4, 4)
    assert np.abs(logits - ref_logits).max() <= 1e-5 * np.abs(
        ref_logits).max()
    losses, grads = _port_steps(init, 2)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-6)
    got, ref = dict(_leaves(grads)), dict(_leaves(ref_grads))
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        g = got[name].numpy()
        assert g.shape == r.shape, name
        assert np.abs(g - r).max() <= 2e-3 * np.abs(r).max(), name


def test_vit_losses_track_reference():
    init, ref_losses, _, _ = _jax_steps(2, exact_exp2=False)
    losses, _ = _port_steps(init, 2)
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-3)


def test_params_from_jax_carries_vit_tree():
    _, jparams = _init(seed=1, num_classes=10)
    ref = dict(_leaves(jax.tree.map(np.asarray, jparams)))
    got = dict(_leaves(params_from_jax(jax.tree.map(np.asarray, jparams))))
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(), r)
    own = pm.vit_init(torch.Generator().manual_seed(0),
                      pm.vit_config(**SMALL), num_classes=10, img=IMG,
                      patch=PATCH, device="cpu")
    assert {k: tuple(v.shape) for k, v in _leaves(own)} == {
        k: r.shape for k, r in ref.items()}
    assert pm.vit_config(**SMALL).max_position_embeddings == 5
    assert tf.vit_patch(pm.vit_config(**SMALL), IMG) == PATCH
    with pytest.raises(ValueError):
        tf.vit_patch(pm.vit_config(**SMALL), 17)
