"""Whisper's integer attention backward replayed layer by layer against
the reference's kernels.

The reduced whisper-large-v3 of ``tests/test_torch_encdec.py`` (2 + 2
layers, d_model 128, 4 heads of 32 over 2 kv heads, B = 2, T = 24 frames,
S = 10 tokens) runs one int8 ``encdec_loss`` backward in the port (round
to nearest, from the reference's own ``encdec_init`` weights).  Every
call of the fused attention backward (``kernels/ops.attention_bwd``) is
recorded with its inputs: the encoder's two bidirectional self-attentions
(Sq = Sk = 24), the decoder's two causal self-attentions (10 x 10) and
its two cross-attentions (Sq 10 != Sk 24, bidirectional).  Each call is
then replayed from those saved inputs through the port's plain
``int_attn_bwd_dq`` / ``int_attn_bwd_dkv`` and through the reference's
Pallas kernels (``repro.kernels.ops.attention_bwd``, interpret mode), with
one exp on both sides: XLA's, fed to the port's p recompute as
``tests/test_torch_int_attention_bwd.py`` does, and ``jnp.exp2`` exact at
integer arguments on the reference's side (caveat A).

Stated tolerance: dq, dk and dv bit for bit at every call.  So the
attention backward of every layer computes what the reference's kernels
compute on the same integers; the 9-15% by which the whole model's wq /
wk gradients differ from the reference's in ``test_torch_encdec.py``
enters upstream of these calls (caveat B: an ulp of the kept FP32 ops
flips an a12 or g8 mantissa, and the 8-bit dS amplifies it).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from test_torch_archs import _exact_scales  # noqa: E402
from test_torch_int_attention_bwd import _xla_exp  # noqa: E402

ARCH = "whisper-large-v3"
B, T, S = 2, 24, 10
#: the backward's calls in the order autograd makes them: decoder layer 1
#: (cross, then self), decoder layer 0, then the encoder's layers 1 and 0
CALLS = ("dec1_cross", "dec1_self", "dec0_cross", "dec0_self", "enc1_self",
         "enc0_self")
#: (Sq, Sk, causal) of each kind of call
SHAPES = {"cross": (S, T, False), "self_dec": (S, S, True),
          "self_enc": (T, T, False)}


def _inputs(cfg):
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return {"frames": torch.from_numpy(frames),
            "tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(labels)}


@pytest.fixture(scope="module")
def calls():
    """The recorded inputs of every attention backward call of one int8
    loss step, in call order."""
    jcfg = jregistry.get_config(ARCH).reduced()
    cfg = registry.get_config(ARCH).reduced()
    init = jax.tree.map(np.asarray, jencdec.encdec_init(
        jax.random.PRNGKey(0), jcfg))
    q = dataclasses.replace(QuantConfig.int8(), stochastic_grad=False)
    seen, orig = [], ops.attention_bwd

    def record(*args, **kw):
        seen.append((tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args), dict(kw)))
        return orig(*args, **kw)

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(ops, "attention_bwd", record)
    try:
        trainer.loss_and_grads(encdec.encdec_loss, params_from_jax(init),
                               _inputs(cfg), cfg, q, None)
    finally:
        mp.undo()
        torch.set_num_threads(n)
    return seen


def test_every_layer_records_one_backward_call(calls):
    assert len(calls) == len(CALLS)
    for name, (args, kw) in zip(CALLS, calls):
        kind = "cross" if "cross" in name else (
            "self_dec" if name.startswith("dec") else "self_enc")
        Sq, Sk, causal = SHAPES[kind]
        assert args[0].shape[2] == Sq and args[2].shape[2] == Sk, name
        assert kw["causal"] is causal and not kw["integer_exp"], name


@pytest.mark.parametrize("i", range(len(CALLS)), ids=CALLS)
def test_attention_backward_replays_bit_for_bit(calls, i, monkeypatch):
    args, kw = calls[i]
    with monkeypatch.context() as m:
        m.setattr(torch, "exp", _xla_exp)
        got = ops.attention_bwd(*args, **kw)
    j = [jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a
         for a in args]
    refs = _exact_scales(lambda: [np.asarray(r) for r in jops.attention_bwd(
        *j, causal=kw["causal"], window=kw["window"], interpret=True,
        integer_exp=kw["integer_exp"])])
    for name, g, r in zip(("dq", "dk", "dv"), got, refs):
        assert g.shape == r.shape, name
        assert np.abs(r).max() > 0, name
        np.testing.assert_array_equal(g.numpy(), r, err_msg=name)
