"""Port parity of the bit-width sweep on the GLUE-proxy cls task: a reduced
BERT (2 layers, d 64, vocab 128, batch 4) from the reference's own weights
(``convert.params_from_jax``), two AdamW steps under each of the presets
int16, int12, int10 and fp32, against the JAX ``value_and_grad`` +
``optimizer.update`` loop on the pallas backend (kernels in interpret
mode) with round-to-nearest gradients (``stochastic_grad=False``: the
port's stochastic rounding draws from a ``torch.Generator``, not from
the reference's keys).  Step 0's loss within 1e-6 relative, step 1's
within 1e-4 (XLA:CPU's inexact ``exp2`` moves a gradient mantissa now and
then; measured: equal, and at most 2.3e-5); ``evaluate`` gives the
reference's metric on the trained params (at int16 and fp32).  Also the
harness's own pieces: the samplers (the img one too), ``sweep`` and
``step_stats``.
The span task's parity is in ``test_torch_sweep_span.py``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.qconfig import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import paper_models as jpm  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.kernels.ops import WRAPPERS  # noqa: E402
from repro_torch.models import paper_models as pm  # noqa: E402
from repro_torch.train import finetune as tf  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402

SMALL = dict(n_layers=2, d_model=64, n_heads=4, d_ff=128, vocab=128,
             name="bert-2l-d64")
TASKS = {"cls": (tf.make_cls_task(vocab=128, seq=16), jpm.bert_cls_loss,
                 pm.bert_cls_loss),
         "span": (tf.make_span_task(vocab=128, seq=24), jpm.bert_span_loss,
                  pm.bert_span_loss)}
OPT = dict(lr=1e-3, weight_decay=0.0)
EVAL_N = 16
EVAL_PRESETS = ("int16", "fp32")


def reference_metric(task, params, cfg, qcfg, sampler):
    """The reference harness's evaluation (``benchmarks.tasks.finetune``)
    on ``params``."""
    ev = sampler(EVAL_N, 10_000_001)
    out = jax.jit(lambda p, t: jpm.bert_apply(p, t, cfg, qcfg, None,
                                              pool=task == "cls"))(
        params, jnp.asarray(ev["tokens"]))
    if task == "cls":
        return 100 * float(jnp.mean(jnp.argmax(out, -1)
                                    == jnp.asarray(ev["labels"])))
    em = jnp.mean((jnp.argmax(out[..., 0], -1) == jnp.asarray(
        ev["span_start"])) & (jnp.argmax(out[..., 1], -1) == jnp.asarray(
            ev["span_end"])))
    return 100 * float(em)


def sweep_parity(task, preset, steps=2):
    """Both loops, ``steps`` steps each from the same weights: the
    reference's and the port's losses and eval metrics."""
    sampler, jloss, tloss = TASKS[task]
    jcfg = jpm.bert_config(**SMALL)
    jparams = jpm.bert_init(jax.random.PRNGKey(0), jcfg, num_labels=4,
                            span_head=task == "span")
    jq = dataclasses.replace(JQuantConfig.preset(preset), backend="pallas",
                             stochastic_grad=False)
    ocfg = jopt.OptimizerConfig(**OPT)

    @jax.jit
    def step(p, o, b):
        loss, g = jax.value_and_grad(
            lambda p: jloss(p, b, jcfg, jq, None)[0])(p)
        p, o, _ = jopt.update(ocfg, g, o, p)
        return p, o, loss

    p = params_from_jax(jax.tree.map(np.asarray, jparams))
    jo, ref_losses = jopt.init(jparams), []
    for i in range(steps):
        b = {k: jnp.asarray(v) for k, v in sampler(4, i).items()}
        jparams, jo, loss = step(jparams, jo, b)
        ref_losses.append(float(loss))
    # the eval forward costs a jit of its own: held at fp32 and int16 only
    ref_metric = (reference_metric(task, jparams, jcfg, jq, sampler)
                  if preset in EVAL_PRESETS else None)

    cfg = pm.bert_config(**SMALL)
    q = dataclasses.replace(QuantConfig.preset(preset), stochastic_grad=False)
    tcfg = topt.OptimizerConfig(**OPT)
    o, losses = topt.init(p), []
    for i in range(steps):
        batch = tf.to_device(sampler(4, i), "cpu")
        p, o, loss, _, _ = tf.train_step(p, o, batch, cfg, q, tloss, tcfg,
                                         None)
        losses.append(float(loss))
    metric = (tf.evaluate(task, p, cfg, q, sampler, EVAL_N, "cpu")
              if preset in EVAL_PRESETS else None)
    return losses, ref_losses, metric, ref_metric


@pytest.mark.parametrize("preset", ["int16", "int12", "int10", "fp32"])
def test_cls_sweep_matches_reference(preset):
    losses, ref, metric, ref_metric = sweep_parity("cls", preset)
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses[0], ref[0], rtol=1e-6)
    np.testing.assert_allclose(losses[1], ref[1], rtol=1e-4)
    assert metric == ref_metric


def test_samplers_are_the_reference_samplers():
    from benchmarks import tasks
    for mine, ref in ((tf.make_cls_task(vocab=300, seq=20),
                       tasks.make_cls_task(vocab=300, seq=20)),
                      (tf.make_span_task(vocab=300, seq=40),
                       tasks.make_span_task(vocab=300, seq=40)),
                      (tf.make_img_task(), tasks.make_img_task()),
                      (tf.make_img_task(img=24, patch=6, n_classes=4, seed=3),
                       tasks.make_img_task(img=24, patch=6, n_classes=4,
                                           seed=3))):
        a, b = mine(6, 3), ref(6, 3)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_img_task_is_the_references_vit_tiny():
    from benchmarks import tasks
    gen = torch.Generator().manual_seed(0)
    cfg, params, sampler, _, lr = tf._task_setup("img", gen, tf.FtConfig())
    rcfg, rparams, _, _, rlr = tasks._task_setup(
        "img", jax.random.PRNGKey(0), tasks.FtConfig())
    for f in ("name", "family", "n_layers", "d_model", "n_heads", "d_ff",
              "vocab", "norm", "act", "max_position_embeddings", "frontend"):
        assert getattr(cfg, f) == getattr(rcfg, f), f
    assert lr == rlr == 1e-3
    shapes = {k: tuple(v.shape) for k, v in _leaves(params)}
    assert shapes == {k: tuple(v.shape)
                      for k, v in _leaves(jax.tree.map(np.asarray, rparams))}
    assert sampler(2, 0)["images"].shape == (2, 32, 32, 3)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}.")
        else:
            yield prefix + k, tree[k]


def test_sweep_and_step_stats_return_their_keys(capsys):
    ft = tf.FtConfig(steps=2, batch=4, eval_n=8)
    arch = pm.bert_config(**SMALL)
    res = tf.sweep("cls", ["fp32", "int8"], ft, device="cpu", arch=arch)
    assert sorted(res) == ["fp32", "int8"]
    assert all(0.0 <= m <= 100.0 for m in res.values())
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[:2] for line in out] == [["cls", "fp32"],
                                                  ["cls", "int8"]]
    for p in ("fp32", "int16"):
        st = tf.step_stats("cls", QuantConfig.preset(p), ft, repeats=2,
                           device="cpu", arch=arch)
        assert sorted(st) == ["by_kernel", "launches", "step_us"]
        assert sorted(st["by_kernel"]) == sorted(WRAPPERS)
        # only CUDA launches count: none on the CPU, none ever under FP32
        assert st["launches"] == 0 == sum(st["by_kernel"].values())
        assert st["step_us"] > 0
