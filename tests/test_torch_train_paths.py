"""Port parity of the training paths beside the LM steps of
``test_torch_lm_train.py`` (whose helpers they share): a reduced BERT step
under the plain ``int8`` preset (integer attention) against the JAX
package's, the data pipeline against the reference's, microbatches, the
paths that stay refused, and the training launcher on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import paper_models as jpm  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import paper_models as pm  # noqa: E402
from repro_torch.train import finetune as tf  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import trainer  # noqa: E402

from test_torch_lm_train import (_batches, _check_grads, _jax_loop,  # noqa: E402
                                 _leaves, _port_loop)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several files at once, and
    small ops on many threads oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    """The distributed paths are ported (``tests/test_torch_distributed.py``
    runs them); what stays refused is what the reference refuses: a
    mesh step without the specs of its blocks, the compressed step
    without a pod axis, ``--grad-compress-bits`` without ``--pods > 1``,
    and a mesh without a distributed world."""
    from repro_torch import sharding
    cfg = registry.get_config("smollm-135m").reduced()
    ocfg = topt.OptimizerConfig()
    mesh = sharding.Mesh((2, 1), ("data", "model"))
    with pytest.raises(ValueError, match="param_specs"):
        trainer.jit_train_step(trainer.make_train_step(
            lm.lm_loss, cfg, QuantConfig.int8(), ocfg), mesh, None)
    with pytest.raises(ValueError, match="pod"):
        trainer.make_compressed_train_step(lm.lm_loss, cfg,
                                           QuantConfig.int8(), ocfg, mesh)
    with pytest.raises(SystemExit):
        launch_train.parse_args(["--grad-compress-bits", "8"])
    for flag in (["--pods", "2"], ["--model-parallel", "2"]):
        with pytest.raises(ValueError, match="torchrun"):
            launch_train.init_world(launch_train.parse_args(
                ["--device", "cpu"] + flag))
    # the enc-dec arch trains through the launcher (models/encdec.py)
    losses = launch_train.main(["--arch", "whisper-large-v3", "--reduced",
                                "--device", "cpu", "--steps", "2", "--batch",
                                "2", "--seq", "16"])
    assert len(losses) == 2 and all(np.isfinite(losses))


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
