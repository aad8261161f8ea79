"""The ``"dots"`` checkpoint policy (``utils.CHECKPOINT_POLICY``) of the
per-layer remat (``lm._remat``), against the reference's
``dots_with_no_batch_dims_saveable``.

The reference's residuals come from ``jax.ad_checkpoint.
print_saved_residuals`` of ``repro.models.lm._attn_block`` (reduced
qwen1.5-0.5b, B 2 x S 16, the Pallas route the port matches), a trace
without compile.  The port's are the layer's input and parameters (what
``torch.utils.checkpoint`` keeps) and what the policy keeps
(``utils.RECORD``).

* int8: ``"dots"`` keeps what full remat keeps, the reference's list (the
  integer products are kernel calls, not FP32 ``aten.mm``s, as they are
  ``pallas_call``s in the reference).
* FP32 (``enabled=False``): ``"dots"`` keeps every 2-D product's output
  (``aten.mm``), which holds the reference's dot residuals
  (``blocks.py:228, 231, 233, 294, 320``: q, k, v, o and the up
  projection).  Named differences: the port also keeps the gate and down
  projections' outputs, which JAX's policy drops (SiLU's output takes the
  gate's place, and the down projection's output is not needed by the
  backward); JAX keeps SiLU's output (``int_ops.py:582``), which torch
  recomputes from the kept gate projection.
* Loss and every gradient bit for bit under full remat, ``"dots"`` and no
  remat, int8 with stochastic forward and gradient rounding from one
  generator, and FP32: reduced qwen1.5-0.5b through ``lm_loss`` and a
  reduced whisper-large-v3 through ``encdec_loss`` (its decoder layers:
  self-attention, the cross K/V from the encoder, cross-attention, the
  GELU MLP).
"""
import collections
import contextlib
import dataclasses
import functools
import io
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.ad_checkpoint  # noqa: E402

from repro_torch import utils  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.models import encdec, lm  # noqa: E402

B, S = 2, 16


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several files at once, and
    small ops on many threads oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


QUANT = {"int8": dataclasses.replace(QuantConfig.int8(),
                                     stochastic_grad=True,
                                     stochastic_fwd=True),
         "fp32": QuantConfig.fp32()}
POLICIES = (None, "dots")

#: the reference's dot residuals of the FP32 block: where each is made and
#: its (rows, cols)
REF_DOTS = {"blocks.py:228": (32, 128), "blocks.py:231": (32, 64),
            "blocks.py:233": (32, 64), "blocks.py:294": (32, 128),
            "blocks.py:320": (32, 256)}
#: what each side keeps beyond the other on the FP32 block
PORT_ONLY = [(32, 256), (32, 128)]          # the gate and down projections
REF_ONLY = ["int_ops.py:582"]               # SiLU's output


def _ref_residuals(quant: str, policy):
    """``[(shape, source)]`` the reference keeps of one ``_attn_block``:
    source the argument's path, or ``file:line`` of the op it is the
    output of."""
    from repro.configs import registry as rreg
    from repro.core.qconfig import QuantConfig as RQ
    from repro.models import lm as rlm
    cfg = rreg.get_config("qwen1.5-0.5b").reduced()
    q = dataclasses.replace(RQ.int8() if quant == "int8" else RQ.fp32(),
                            backend="pallas")
    bp = jax.tree.map(lambda a: a[0],
                      rlm.lm_init(jax.random.PRNGKey(0), cfg)["blocks"])
    x = jax.numpy.zeros((B, S, cfg.d_model), jax.numpy.float32)
    pol = (jax.checkpoint_policies.dots_with_no_batch_dims_saveable
           if policy == "dots" else None)
    f = jax.checkpoint(lambda bp, x: rlm._attn_block(
        bp, x, cfg, q, jax.random.PRNGKey(3))[0].sum(), policy=pol)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax.ad_checkpoint.print_saved_residuals(f, bp, x)
    out = []
    for line in buf.getvalue().splitlines():
        m = re.match(r"\w+\[([\d,]*)\] (from the argument (.*)|output of .* "
                     r"from \S*/(\w+\.py:\d+):\d+)", line)
        assert m, line
        shape = tuple(int(d) for d in m.group(1).split(",") if d)
        src = m.group(3) or m.group(4)
        if src.startswith("bp"):
            src = ".".join(re.findall(r"\['(\w+)'\]", src))
        out.append((shape, src))
    return out


@pytest.fixture(scope="module")
def reference():
    return {(qn, p): _ref_residuals(qn, p) for qn in QUANT for p in POLICIES}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}.")
        else:
            yield prefix + k, tree[k]


@contextlib.contextmanager
def _policy(policy, record=None):
    prev = utils.CHECKPOINT_POLICY, utils.RECORD
    utils.CHECKPOINT_POLICY, utils.RECORD = policy, record
    try:
        yield
    finally:
        utils.CHECKPOINT_POLICY, utils.RECORD = prev


def _port_layer(quant: str, policy):
    """The port's ``_remat_layer`` of reduced qwen's layer 0: (its
    checkpointed input and parameters as ``[(shape, name)]``, what the
    policy kept as ``[(shape, op)]``)."""
    cfg = registry.get_config("qwen1.5-0.5b").reduced()
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    bp = {k: v for k, v in _leaves(params["blocks"])}
    bp = {k: v[0].requires_grad_(True) for k, v in bp.items()}
    nested = {}
    for k, v in bp.items():
        a, b = k.split(".")
        nested.setdefault(a, {})[b] = v
    x = torch.zeros((B, S, cfg.d_model), requires_grad=True)
    kept = []
    with _policy(policy, kept):
        y, _ = lm._remat_layer(nested, x, cfg, QUANT[quant],
                               torch.Generator().manual_seed(3))
        y.sum().backward()
    held = [(tuple(x.shape), "x")] + [(tuple(v.shape), k)
                                      for k, v in bp.items()]
    return held, [(shape, op) for op, shape, _ in kept]


def test_int8_dots_keeps_what_full_remat_keeps(reference):
    """The reference keeps x and the block's 12 parameters under both
    policies; so does the port: the policy keeps nothing more."""
    ref_full, ref_dots = reference["int8", None], reference["int8", "dots"]
    assert sorted(ref_full) == sorted(ref_dots)
    for policy in POLICIES:
        held, kept = _port_layer("int8", policy)
        assert kept == [], policy
        assert sorted(held) == sorted(ref_full)


def test_fp32_dots_keeps_the_2d_products(reference):
    ref = reference["fp32", "dots"]
    args = [r for r in ref if ".py:" not in r[1]]
    assert sorted(args) == sorted(reference["fp32", None])
    outs = [(shape, src) for shape, src in ref if (shape, src) not in args]
    dots = {src: (int(np.prod(shape[:-1])), shape[-1])
            for shape, src in outs if src in REF_DOTS}
    assert dots == REF_DOTS
    assert sorted(src for _, src in outs if src not in REF_DOTS) == REF_ONLY

    held, kept = _port_layer("fp32", "dots")
    assert sorted(held) == sorted(reference["fp32", None])
    assert {op for _, op in kept} == {"mm"}    # no bmm, no integer wrapper
    got = collections.Counter(shape for shape, _ in kept)
    want = collections.Counter(REF_DOTS.values()) + collections.Counter(
        PORT_ONLY)
    assert got == want
    assert _port_layer("fp32", None)[1] == []


def _whisper_step(quant: str, remat: bool, policy):
    cfg = registry.get_config("whisper-large-v3").reduced()
    params = encdec.encdec_init(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
    leaves = dict(_leaves(params))
    for t in leaves.values():
        t.requires_grad_(True)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=g)
    batch = {"frames": torch.randn((B, 24, cfg.d_model), generator=g),
             "tokens": toks, "labels": torch.roll(toks, -1, 1)}
    gen = torch.Generator().manual_seed(2)
    kept = []
    call = encdec._remat_call
    with _policy(policy, kept), pytest.MonkeyPatch.context() as mp:
        mp.setattr(encdec, "_remat_call",
                   lambda fn, x, key, r: call(fn, x, key, r and remat))
        loss, _ = encdec.encdec_loss(params, batch, cfg, QUANT[quant], gen)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads)), gen.get_state(), kept


def _qwen_step(quant: str, remat: bool, policy):
    cfg = registry.get_config("qwen1.5-0.5b").reduced()
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    leaves = dict(_leaves(params))
    for t in leaves.values():
        t.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (B, S),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    gen = torch.Generator().manual_seed(2)
    kept = []
    with _policy(policy, kept), pytest.MonkeyPatch.context() as mp:
        mp.setattr(lm, "_backbone_train", functools.partial(
            lm._backbone_train, remat=remat))
        loss, _ = lm.lm_loss(params, batch, cfg, QUANT[quant], gen)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads)), gen.get_state(), kept


#: the FP32 2-D products reduced whisper's layers keep under "dots" (rows
#: x cols; 2 rows x 16 tokens, 2 x 24 frames, 4 heads over 2 kv heads of
#: 32): an encoder layer's q, k, v, o, w1, w2; a decoder layer's self q,
#: k, v, o, the cross K/V from the encoder, cross q and o, w1, w2
WHISPER_ENC = [(48, 128), (48, 64), (48, 64), (48, 128), (48, 256),
               (48, 128)]
WHISPER_DEC = [(32, 128), (32, 64), (32, 64), (32, 128), (48, 64), (48, 64),
               (32, 128), (32, 128), (32, 256), (32, 128)]
WHISPER_KEPT = (WHISPER_ENC + WHISPER_DEC) * 2


@pytest.mark.parametrize("quant", list(QUANT))
@pytest.mark.parametrize("model", ["qwen", "whisper"])
def test_loss_and_gradients_bit_for_bit(model, quant):
    step = _qwen_step if model == "qwen" else _whisper_step
    loss, grads, state, _ = step(quant, True, None)
    for remat, policy in ((True, "dots"), (False, None)):
        loss1, grads1, state1, kept = step(quant, remat, policy)
        assert torch.equal(loss, loss1), (remat, policy)
        assert torch.equal(state, state1)
        for name, g in grads.items():
            assert torch.equal(g, grads1[name]), (name, remat, policy)
        if policy == "dots":
            shapes = sorted(shape for _, shape, _ in kept)
            if quant == "int8":
                assert shapes == []
            elif model == "whisper":
                assert shapes == sorted(WHISPER_KEPT)
            else:
                n = registry.get_config("qwen1.5-0.5b").reduced().n_layers
                assert shapes == sorted(
                    (list(REF_DOTS.values()) + PORT_ONLY) * n)
