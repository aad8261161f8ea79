"""Per-layer remat of the training stack (``lm._backbone_train``): with
stochastic rounding in the forward (``stochastic_fwd``) and of the
gradients (``stochastic_grad``), all drawn from one ``torch.Generator``,
a step with remat (each layer under ``torch.utils.checkpoint``, the
recompute drawing from a copy of the generator set to its state before the
layer) gives the same loss and every gradient bit for bit as the step
without, and leaves the generator in the same state.  A recompute that drew
from the shared generator instead (emulated by patching ``_replay_key``)
breaks both, so the test sees the hazard.  Reduced qwen1.5-0.5b (dense,
QKV bias, tied head) and reduced mixtral-8x7b (MoE, a window of 64 keys
over 80 tokens), int8, on the CPU.  The BERT / ViT encoder
(``paper_models._encoder``) runs each layer under the same remat: its
step with remat equals the one without bit for bit, and its recompute's
kernel calls are counted (the layer's forward less its last product, which
the recompute skips as the reference's dead-code eliminated one does).
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import paper_models as pm  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several files at once, and
    small ops on many threads oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEQ = {"qwen1.5-0.5b": 24, "mixtral-8x7b": 80}
STOCHASTIC = dataclasses.replace(QuantConfig.int8(), stochastic_grad=True,
                                 stochastic_fwd=True)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}.")
        else:
            yield prefix + k, tree[k]


def _step(monkeypatch, arch, remat, key=None):
    """One ``lm_loss`` forward and backward with ``_backbone_train``'s remat
    set as given; returns (loss, {name: gradient}, the generator's state
    after the backward, calls of ``_attn_block``)."""
    cfg = registry.get_config(arch).reduced()
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    leaves = dict(_leaves(params))
    for t in leaves.values():
        t.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (2, SEQ[arch]),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    gen = torch.Generator().manual_seed(2)
    calls = []
    block = lm._attn_block

    def counted(*a, **kw):
        calls.append(1)
        return block(*a, **kw)
    monkeypatch.setattr(lm, "_attn_block", counted)
    monkeypatch.setattr(lm, "_backbone_train", functools.partial(
        lm._backbone_train, remat=remat))
    loss, _ = lm.lm_loss(params, batch, cfg, STOCHASTIC,
                         gen if key is None else key)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    monkeypatch.undo()
    return (loss.detach(), dict(zip(leaves, grads)), gen.get_state(),
            len(calls))


@pytest.mark.parametrize("arch", list(SEQ))
def test_remat_replays_the_forward_noise_bit_for_bit(monkeypatch, arch):
    loss, grads, state, calls = _step(monkeypatch, arch, remat=True)
    loss0, grads0, state0, calls0 = _step(monkeypatch, arch, remat=False)
    n = registry.get_config(arch).reduced().n_layers
    assert (calls, calls0) == (2 * n, n)           # each layer recomputed
    assert torch.equal(loss, loss0)
    assert sorted(grads) == sorted(grads0)
    for name, g in grads.items():
        assert torch.isfinite(g).all() and g.abs().max() > 0, name
        assert torch.equal(g, grads0[name]), name
    assert torch.equal(state, state0)


@pytest.mark.parametrize("arch", list(SEQ))
def test_recompute_from_the_shared_generator_is_caught(monkeypatch, arch):
    """The hazard, emulated: the recompute draws from the shared generator.
    Its activation noise is then not the forward's, and every gradient draw
    after it shifts: the gradients and the generator's final state differ
    from the step without remat."""
    loss0, grads0, state0, _ = _step(monkeypatch, arch, remat=False)
    monkeypatch.setattr(lm, "_replay_key", lambda key, state: key)
    loss, grads, state, calls = _step(monkeypatch, arch, remat=True)
    assert calls == 2 * registry.get_config(arch).reduced().n_layers
    assert torch.equal(loss, loss0)                # the forward is the same
    assert not torch.equal(state, state0)
    assert not all(torch.equal(g, grads0[n]) for n, g in grads.items())


def test_a_callable_key_runs_without_remat(monkeypatch):
    """A callable key hands in noise that cannot be replayed: its layers
    run once, and the step equals the step without remat."""
    def key(shape, device):
        return torch.rand(shape, generator=noise, device=device)
    noise = torch.Generator().manual_seed(3)
    loss, grads, _, calls = _step(monkeypatch, "qwen1.5-0.5b", remat=True,
                                  key=key)
    noise = torch.Generator().manual_seed(3)
    loss0, grads0, _, _ = _step(monkeypatch, "qwen1.5-0.5b", remat=False,
                                key=key)
    assert calls == registry.get_config("qwen1.5-0.5b").reduced().n_layers
    assert torch.equal(loss, loss0)
    assert all(torch.equal(g, grads0[n]) for n, g in grads.items())


def _enc_step(monkeypatch, which, remat):
    """One bert cls / vit img forward and backward (2 layers, stochastic
    forward and gradient rounding) with ``_encoder``'s remat set as given;
    returns (loss, {name: gradient}, the generator's state, kernel calls by
    wrapper, encoder layer calls)."""
    g = torch.Generator().manual_seed(0)
    if which == "bert":
        cfg = pm.bert_config(n_layers=2, d_model=64, n_heads=4, d_ff=128,
                             vocab=96, name="bert-remat")
        params = pm.bert_init(g, cfg, num_labels=3, device="cpu")
        batch = {"tokens": torch.randint(0, 96, (2, 16), generator=g),
                 "segment": torch.randint(0, 2, (2, 16), generator=g),
                 "labels": torch.tensor([0, 2])}
        loss_fn = pm.bert_cls_loss
    else:
        cfg = pm.vit_config(n_layers=2, d_model=64, n_heads=4, d_ff=128,
                            img=32, patch=8, name="vit-remat")
        params = pm.vit_init(g, cfg, num_classes=3, img=32, patch=8,
                             device="cpu")
        batch = {"images": torch.randn((2, 32, 32, 3), generator=g),
                 "labels": torch.tensor([1, 2])}
        loss_fn = functools.partial(pm.vit_cls_loss, patch=8)
    leaves = dict(_leaves(params))
    for t in leaves.values():
        t.requires_grad_(True)
    gen = torch.Generator().manual_seed(2)
    calls, layer = [], pm._enc_layer

    def counted(*a, **kw):
        calls.append(1)
        return layer(*a, **kw)
    monkeypatch.setattr(pm, "_enc_layer", counted)
    monkeypatch.setattr(pm, "_encoder", functools.partial(pm._encoder,
                                                          remat=remat))
    _lib.PLAIN_CALLS.clear()
    loss, _ = loss_fn(params, batch, cfg, STOCHASTIC, gen)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    monkeypatch.undo()
    return (loss.detach(), dict(zip(leaves, grads)), gen.get_state(),
            dict(_lib.PLAIN_CALLS), len(calls))


@pytest.mark.parametrize("which", ["bert", "vit"])
def test_encoder_remat_is_bit_for_bit_and_recomputes(monkeypatch, which):
    loss, grads, state, kern, calls = _enc_step(monkeypatch, which, True)
    loss0, grads0, state0, kern0, calls0 = _enc_step(monkeypatch, which,
                                                     False)
    assert (calls, calls0) == (4, 2)               # each layer recomputed
    assert torch.equal(loss, loss0)
    assert sorted(grads) == sorted(grads0)
    for name, g in grads.items():
        assert torch.isfinite(g).all(), name
        assert torch.equal(g, grads0[name]), name
    assert torch.equal(state, state0)
    # the recompute's calls: per layer the forward's 19 quantizes, its two
    # norms, its attention and the q / k / v / o and w1 matmuls; w2's
    # matmul, the layer's last product, is not run again, and no backward
    # kernel is
    extra = {n: kern.get(n, 0) - kern0.get(n, 0) for n in kern}
    assert extra == {"dfx_quantize": 2 * 19, "bfp_matmul": 2 * 5,
                     "int_layernorm_fwd": 2 * 2, "int_attn_fwd": 2,
                     **{n: 0 for n in kern if n not in (
                         "dfx_quantize", "bfp_matmul", "int_layernorm_fwd",
                         "int_attn_fwd")}}, extra
