"""Port parity of the hybrid (zamba2-2.7b: Mamba2 groups, each followed by
the one shared attention block) and VLM (llava-next-mistral-7b: projected
patch embeddings in front of the tokens) families against the JAX
package (``backend="pallas"``, kernels in interpret mode, round to
nearest), from the reference's own weights (``convert.params_from_jax``):
the configs, one ``lm_loss`` step at the reduced configs, the VLM's
prefill and its loss over the text positions only, the hybrid's decode
against prefill and its batcher, remat under stochastic rounding, the
scope rule the hybrid refuses, the probe set, the weight trees and the
launchers.

Stated tolerances (``test_torch_ssm.py``'s, which hold the SSM parts):

* one ``lm_loss`` step: FP32 loss within 1e-6 relative and every gradient
  within 1e-4 of its max; int8 (``jnp.exp2`` exact at integer arguments,
  caveat A) loss within 1e-6 relative, the head's and the final norm's
  gradients within 2e-3 of their max, every other gradient within 10% of
  its norm (caveat B, as ``test_torch_archs.py``);
* the VLM's ``lm_prefill`` logits with the prefix: FP32 within 1e-5 of
  max|logits|, int8 within 2e-3;
* the hybrid's decode against prefill, FP32: within 2e-4 absolute (the
  reference's own test's bound); its interleaved batcher within 1e-6 of
  each request run alone;
* remat on against off under stochastic forward and gradient rounding:
  bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.core import health as jhealth  # noqa: E402
from repro.core import qpolicy as jqpolicy  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import health, qpolicy  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from test_torch_archs import _exact_scales, _leaves  # noqa: E402
from test_torch_serve import _run_tracked  # noqa: E402
from test_torch_ssm import (_batch, _quants, _setup,  # noqa: E402
                            check_loss_and_grads, remat_step)

HYBRID, VLM = "zamba2-2.7b", "llava-next-mistral-7b"
#: published sizes (arXiv:2411.15242; the llava-v1.6-mistral-7b card)
PUBLISHED = {HYBRID: 2.7e9, VLM: 7.57e9}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many tiny ops: one intra-op thread keeps them from stalling on a CPU
    that other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _patches(cfg, seed=6):
    return np.random.default_rng(seed).standard_normal(
        (2, cfg.vlm_prefix, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("arch", [HYBRID, VLM])
def test_config_is_the_reference_config(arch):
    cfg = registry.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jregistry.get_config(arch))
    assert abs(cfg.param_count() - PUBLISHED[arch]) / PUBLISHED[arch] < 0.15
    assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
        jregistry.get_config(arch).reduced())
    if arch == HYBRID:
        assert (cfg.head_dim, cfg.n_heads // cfg.n_kv_heads,
                cfg.n_layers // cfg.hybrid_attn_every) == (80, 1, 9)
    else:
        assert (cfg.vlm_prefix, cfg.n_heads // cfg.n_kv_heads) == (2880, 4)


@pytest.mark.parametrize("quant", ["fp32", "int8"])
@pytest.mark.parametrize("arch", [HYBRID, VLM])
def test_loss_and_grads_match_reference(arch, quant):
    cfg = registry.get_config(arch).reduced()
    extra = {"patch_embeds": _patches(cfg)} if cfg.vlm_prefix else None
    got = check_loss_and_grads(arch, quant, extra)
    if arch == HYBRID:
        assert any(k.startswith("shared_attn.attn.wq") for k in got)
    else:
        # the projector learns through the prefix the loss leaves out
        g = got["mm_proj"].numpy()
        assert np.isfinite(g).all() and np.abs(g).max() > 0


@pytest.mark.parametrize("quant", ["fp32", "int8"])
def test_vlm_prefill_with_prefix_matches_reference(quant):
    jcfg, cfg, init = _setup(VLM)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 12)).astype(
        np.int32)
    pe = _patches(cfg)
    jq, q = _quants(quant)

    def run():
        logits, x = jax.jit(lambda p, t, e: jlm.lm_prefill(
            p, t, jcfg, jq, prefix_embeds=e))(
            jax.tree.map(jnp.asarray, init), jnp.asarray(toks),
            jnp.asarray(pe))
        return np.asarray(logits), np.asarray(x)
    rlogits, rx = _exact_scales(run) if quant != "fp32" else run()
    with torch.no_grad():
        logits, x = lm.lm_prefill(params_from_jax(init), torch.from_numpy(toks),
                                  cfg, q, prefix_embeds=torch.from_numpy(pe))
    assert x.shape == rx.shape == (2, cfg.vlm_prefix + 12, cfg.d_model)
    tol = 1e-5 if quant == "fp32" else 2e-3
    assert np.abs(logits.numpy() - rlogits).max() <= tol * np.abs(
        rlogits).max()


def test_vlm_loss_counts_the_text_positions_only():
    """The prefix's positions carry no label: the loss with patch
    embeddings equals the cross entropy of the text positions' logits
    computed by hand from the same forward."""
    _, cfg, init = _setup(VLM)
    params = params_from_jax(init)
    b = _batch(cfg, S=10)
    pe = torch.from_numpy(_patches(cfg))
    toks = torch.from_numpy(b["tokens"])
    labels = torch.from_numpy(b["labels"]).long()
    q = QuantConfig.fp32()
    loss, _ = lm.lm_loss(params, {"tokens": toks, "labels": labels,
                                  "patch_embeds": pe}, cfg, q, None)
    x = lm._embed(params, toks, cfg, q, None, prefix_embeds=pe)
    x, _ = lm._backbone_train(params, x, cfg, q, None)
    assert x.shape[1] == cfg.vlm_prefix + 10
    logits = lm._logits(params, x[:, cfg.vlm_prefix:], cfg, q, None)
    valid = labels >= 0
    ll = torch.log_softmax(logits, -1).gather(
        -1, labels.clamp(min=0)[..., None])[..., 0]
    want = -(ll * valid).sum() / valid.sum()
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=0)
    # the prefix changes the text's loss (attention sees it)
    loss0, _ = lm.lm_loss(params, {"tokens": toks, "labels": labels,
                                   "patch_embeds": pe * 0}, cfg, q, None)
    assert float(loss0) != float(loss)


@pytest.mark.parametrize("T", [8, 32])
def test_hybrid_decode_matches_prefill(T):
    """The reference's cache test on the port, over one chunk and two: the
    shared block's calls each with a KV cache of their own."""
    _, cfg, init = _setup(HYBRID)
    params = params_from_jax(init)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, T)).astype(np.int32))
    q = QuantConfig.fp32()
    with torch.no_grad():
        pre, _ = lm.lm_prefill(params, toks, cfg, q)
        cache = lm.init_cache(cfg, 2, 40, device="cpu")
        G = cfg.n_layers // cfg.hybrid_attn_every
        assert cache["k"].shape == (G, 2, 40, cfg.n_kv_heads, cfg.head_dim)
        assert cache["ssm"].shape[:2] == (cfg.n_layers, 2)
        for t in range(T):
            dec, cache = lm.lm_decode_step(params, toks[:, t:t + 1], cache,
                                           cfg, q)
    np.testing.assert_allclose(pre.numpy(), dec.numpy(), atol=2e-4)
    with pytest.raises(ValueError):
        lm.lm_prefill_cache(params, toks, cache, cfg, q)


def test_hybrid_batcher_interleaved_matches_sequential():
    _, cfg, init = _setup(HYBRID)
    engine = Engine(params_from_jax(init), cfg, QuantConfig.fp32(),
                    ServeConfig(max_seq=32, batch_slots=2), device="cpu")
    rng = np.random.default_rng(1)
    pa = rng.integers(0, cfg.vocab, 5)
    pb = rng.integers(0, cfg.vocab, 3)
    (ra,), ta, res_a = _run_tracked(engine, cfg, [(pa, 4, 0)])
    (rb,), tb, res_b = _run_tracked(engine, cfg, [(pb, 4, 0)])
    (ia, ib), ti, res = _run_tracked(engine, cfg, [(pa, 4, 0), (pb, 4, 2)])
    np.testing.assert_array_equal(res[ia], res_a[ra])
    np.testing.assert_array_equal(res[ib], res_b[rb])
    for solo, inter in [(ta[ra], ti[ia]), (tb[rb], ti[ib])]:
        assert len(solo) == len(inter)
        for ls, li in zip(solo, inter):
            torch.testing.assert_close(ls, li, rtol=0, atol=1e-6)


def test_hybrid_remat_replays_the_forward_noise_bit_for_bit(monkeypatch):
    loss, grads, state, calls = remat_step(monkeypatch, HYBRID, True)
    loss0, grads0, state0, calls0 = remat_step(monkeypatch, HYBRID, False)
    n = registry.get_config(HYBRID).reduced().n_layers
    assert (calls, calls0) == (2 * n, n)
    assert torch.equal(loss, loss0)
    for name, g in grads.items():
        assert torch.isfinite(g).all() and g.abs().max() > 0, name
        assert torch.equal(g, grads0[name]), name
    assert torch.equal(state, state0)


def test_hybrid_refuses_a_per_layer_rule_as_the_reference():
    jcfg, cfg, init = _setup(HYBRID)
    b = _batch(cfg, S=16)
    with pytest.raises(jqpolicy.PolicyScopeError) as ref:
        jlm.lm_loss(jax.tree.map(jnp.asarray, init),
                    {k: jnp.asarray(v) for k, v in b.items()}, jcfg,
                    jqpolicy.preset("int8_firstlast16"), None)
    with pytest.raises(qpolicy.PolicyScopeError) as got:
        lm.lm_loss(params_from_jax(init),
                   {k: torch.from_numpy(v) for k, v in b.items()}, cfg,
                   qpolicy.preset("int8_firstlast16"), None)
    assert str(got.value) == str(ref.value)
    # a rule uniform over the stack is taken
    loss, _ = lm.lm_loss(params_from_jax(init),
                         {k: torch.from_numpy(v) for k, v in b.items()}, cfg,
                         qpolicy.preset("int8_embed16"), None)
    assert torch.isfinite(loss)


def test_hybrid_probe_set_is_the_reference_set():
    """Probes report whether or not a leaf quantizes: FP32 keeps the
    reference's trace small."""
    jcfg, cfg, init = _setup(HYBRID)
    b = _batch(cfg, S=16)
    jq, q = _quants("fp32")

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


@pytest.mark.parametrize("arch", [HYBRID, VLM])
def test_params_from_jax_carries_the_tree(arch):
    _, cfg, init = _setup(arch)
    got = dict(_leaves(params_from_jax(init)))
    ref = dict(_leaves(init))
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        np.testing.assert_array_equal(got[name].numpy(), r, err_msg=name)
    own = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in _leaves(own)} == {
        k: r.shape for k, r in ref.items()}
    assert ("shared_attn.attn.wq" in ref) == (arch == HYBRID)
    assert ("mm_proj" in ref) == (arch == VLM)


def test_launchers_run_the_three_archs_on_cpu(caplog):
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train
    caplog.set_level("INFO")
    for arch in ("mamba2-370m", HYBRID, VLM):
        launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--requests", "2", "--prompt-len", "4",
                           "--max-new", "2"])
        losses = launch_train.main(["--arch", arch, "--reduced", "--device",
                                    "cpu", "--steps", "2", "--batch", "2",
                                    "--seq", "16", "--log-every", "1"])
        assert len(losses) == 2 and all(np.isfinite(losses))
        assert f"arch={arch}-smoke" in caplog.text
    assert launch_train.make_batch(registry.get_config(VLM).reduced(), {
        "tokens": np.zeros((2, 4), np.int32)})["patch_embeds"].shape == (
        2, 8, 128)
