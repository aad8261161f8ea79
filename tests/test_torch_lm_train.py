"""Port parity of LM training: the reduced qwen1.5-0.5b and smollm-135m
(2 layers, d 128, 4 query heads over 2 kv heads, QKV bias and a tied head
on qwen) under ``int8`` (w8·a12·g8, integer RMS-norm and attention forward
and backward), round to nearest, from the reference's own ``lm_init``
weights (``convert.params_from_jax``), against the JAX ``value_and_grad(
lm.lm_loss)`` + ``optimizer.update`` loop on the pallas backend (kernels in
interpret mode); a reduced BERT step under the plain ``int8`` preset
(integer attention); the data pipeline and the training launcher.

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

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.core.qconfig import QuantConfig as JQuantConfig  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import paper_models as jpm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import paper_models as pm  # noqa: E402
from repro_torch.train import finetune as tf  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

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


def _lm_setup(arch):
    jcfg = jregistry.get_config(arch).reduced()
    init = jax.tree.map(np.asarray, jlm.lm_init(jax.random.PRNGKey(0), jcfg))
    return jcfg, registry.get_config(arch).reduced(), init


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
    batches = _batches(cfg.vocab, 3)
    ref_losses, ref_grads = _jax_loop(jlm.lm_loss, init, batches, jcfg, 3,
                                      exact_exp2=True)
    losses, grads = _port_loop(lm.lm_loss, init, batches, cfg, 3)
    np.testing.assert_allclose(losses[0], ref_losses[0], rtol=1e-6)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    _check_grads(grads, ref_grads)


def test_lm_losses_track_reference():
    jcfg, cfg, init = _lm_setup("qwen1.5-0.5b")
    batches = _batches(cfg.vocab, 3)
    ref_losses, _ = _jax_loop(jlm.lm_loss, init, batches, jcfg, 3,
                              exact_exp2=False)
    losses, _ = _port_loop(lm.lm_loss, init, batches, cfg, 3)
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-3)


def test_bert_int8_step_matches_reference():
    """The plain ``int8`` preset quantizes attention's QKᵀ and PV too: one
    reduced-BERT step's loss and gradients, integer attention under
    grad, against JAX (exact scales)."""
    small = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=128,
                 name="bert-2l-d64")
    jcfg = jpm.bert_config(**small)
    init = jax.tree.map(np.asarray, jpm.bert_init(jax.random.PRNGKey(0),
                                                  jcfg, num_labels=4))
    b = tf.make_cls_task(vocab=128, seq=16)(4, 0)

    def jloss(p, batch, cfg, qcfg, key):
        return jpm.bert_cls_loss(p, batch, cfg, qcfg, key)
    ref_losses, ref_grads = _jax_loop(jloss, init, [b], jcfg, 1,
                                      exact_exp2=True)
    losses, grads = _port_loop(pm.bert_cls_loss, init, [b],
                               pm.bert_config(**small), 1)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-6)
    _check_grads(grads, ref_grads)


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


def test_pipeline_is_the_reference_pipeline(tmp_path):
    cfg = dict(batch_size=3, seq_len=20, vocab=300, seed=4, num_hosts=2,
               host_id=1)
    mine = pipeline.SyntheticLM(pipeline.DataConfig(**cfg))
    ref = jpipe.SyntheticLM(jpipe.DataConfig(**cfg))
    for _ in range(2):
        a, b = next(mine), next(ref)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    assert mine.state() == ref.state()
    path = tmp_path / "tokens.bin"
    np.arange(200, dtype=np.int32).tofile(path)
    mine = pipeline.MmapTokens(str(path), pipeline.DataConfig(**cfg))
    ref = jpipe.MmapTokens(str(path), jpipe.DataConfig(**cfg))
    for _ in range(3):                        # the third batch wraps around
        a, b = next(mine), next(ref)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    assert mine.state() == ref.state()


def test_microbatches_average_the_gradients():
    cfg = registry.get_config("smollm-135m").reduced()
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = tf.to_device(_batches(cfg.vocab, 1)[0], "cpu")
    q = QuantConfig.fp32()
    g1, m1 = trainer.make_grads_fn(lm.lm_loss, cfg, q, 1)(params, batch,
                                                          None)
    g2, m2 = trainer.make_grads_fn(lm.lm_loss, cfg, q, 2)(params, batch,
                                                          None)
    halves = [{k: v[i:i + 1] for k, v in batch.items()} for i in range(2)]
    ls = [float(lm.lm_loss(params, h, cfg, q, None)[0]) for h in halves]
    np.testing.assert_allclose(float(m2["loss"]), np.mean(ls), rtol=1e-6)
    for (name, a), (_, b) in zip(_leaves(g1), _leaves(g2)):
        # equal token counts per half: the mean of the halves' gradients
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6 * float(a.abs().max()))
    with pytest.raises(ValueError):
        trainer.make_grads_fn(lm.lm_loss, cfg, q, 3)(params, batch, None)


def test_unported_train_paths_raise():
    cfg = registry.get_config("smollm-135m").reduced()
    ocfg = topt.OptimizerConfig()
    with pytest.raises(NotImplementedError):
        trainer.make_train_step(lm.lm_loss, cfg, QuantConfig.int8(), ocfg,
                                trainer.TrainConfig(grad_compress_bits=8))
    with pytest.raises(NotImplementedError):
        trainer.make_train_step(lm.lm_loss, cfg, QuantConfig.int8(), ocfg,
                                mesh=object())
    with pytest.raises(NotImplementedError):
        trainer.make_compressed_train_step()
    for flag in (["--pods", "2"], ["--model-parallel", "2"],
                 ["--grad-compress-bits", "8"]):
        with pytest.raises(NotImplementedError, match=flag[0]):
            launch_train.parse_args(flag)
    with pytest.raises(NotImplementedError):
        launch_train.main(["--arch", "mamba2-370m", "--device", "cpu"])


def test_launcher_trains_on_cpu(caplog):
    caplog.set_level("INFO")
    losses = launch_train.main(["--reduced", "--device", "cpu", "--steps",
                                "3", "--batch", "2", "--seq", "16",
                                "--log-every", "1"])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "step 2 loss=" in caplog.text and "done: 3 steps" in caplog.text
    args = launch_train.parse_args([])
    assert (args.arch, args.quant, args.batch, args.seq, args.lr,
            args.steps, args.device) == ("qwen1.5-0.5b", "int8", 8, 256,
                                         1e-3, 100, "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            launch_train.main(["--reduced", "--steps", "1"])
