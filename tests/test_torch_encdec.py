"""Port parity of the encoder-decoder (whisper-large-v3,
``models/encdec.py``): the config field for field; cross-attention
through ``blocks.attention_apply``'s ``kv_override``; ``encode``, the cross
K/V (``_cross_kv`` inside training, ``encdec_precompute_cross``), one
``encdec_loss`` step's loss and every gradient, under FP32 and int8;
``encdec_decode_step`` teacher-forced against the training decoder, and
int8 decode steps against the reference's; the sinusoid rows at an offset
against the full table; the probe set; remat under stochastic rounding;
the launcher on the enc-dec tree.  The reference runs ``backend="pallas"``
(kernels in interpret mode), round to nearest, from its own
``encdec_init`` weights (``convert.params_from_jax``); each precision's
reference run is shared by the cases through a module fixture.

The config is ``reduced()`` (2 + 2 layers, d_model 128, 4 heads of 32 over
2 kv heads), at B = 2, T = 24 frames and S = 10 tokens: cross-attention
has Sq != Sk, and 24 keys end inside a key block of the plain versions.

Stated tolerances (``tests/test_torch_archs.py``'s):

* FP32: ``encode`` and the cross K/V within 1e-5 of their max; the loss
  within 1e-6 relative, every gradient within 1e-4 of its max.
* int8 with exact scales (``jnp.exp2`` exact at integer arguments, caveat
  A): ``encode`` and the cross K/V within 2e-3 of their max (layer
  norm's rsqrt and GELU round differently on the two sides and move an
  a12 mantissa now and then); the loss within 1e-6 relative; the tied
  head's (``embed``) and the final norm's gradients within 2e-3 of their
  max; every other gradient within 10% of its norm, the attention q / k
  projections 50% (caveat B: the 8-bit dS amplifies those flips in every
  gradient below it; measured: the self-attention wq / wk 9-15% of their
  norm, every other leaf under 1.4%), the band ``test_torch_archs.py`` and
  ``test_torch_ssm.py`` state for the same effect.  That the attention
  backward itself is not the cause is shown by
  ``tests/test_torch_encdec_replay.py``: each layer's integer attention
  backward, replayed from its own saved inputs with one exp on both sides,
  equals the reference's Pallas kernels bit for bit.
* Decode: FP32 teacher-forced decode steps against the training
  decoder's logits within 2e-4 absolute (the reference's own decode
  test's bound); int8 decode steps (bfloat16 self cache, the reference's
  default) against the reference's within 2e-3 of max|logits|.
* The sinusoid rows at an offset: bit for bit against the port's full
  table; against the reference's within 4 ulps of the largest angle
  (start + S): XLA's exp is an ulp off torch's in some of the
  frequencies, which moves an angle ``t · inv`` by an ulp of ``t``
  (measured 3.0e-5 at rows 1000-1009, where an ulp is 6.1e-5).
* Remat on against off under stochastic forward and gradient rounding:
  bit for bit, the generator's final state too.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.core import health as jhealth  # noqa: E402
from repro.core.qconfig import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import health  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import blocks, encdec, lm  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from test_torch_archs import _exact_scales, _leaves, _quants  # noqa: E402

ARCH = "whisper-large-v3"
B, T, S = 2, 24, 10
#: int8 decode steps held against the reference's
INT8_STEPS = 4
KEY = jax.random.PRNGKey(0)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs():
    jcfg = jregistry.get_config(ARCH).reduced()
    cfg = registry.get_config(ARCH).reduced()
    return jcfg, cfg


def _inputs(cfg):
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return {"frames": frames, "tokens": toks, "labels": labels}


def _reference(quant):
    """The reference's encode, cross K/V, loss, gradients, probe tags and
    ``INT8_STEPS`` decode steps' logits on the shared inputs."""
    jcfg, cfg = _configs()
    init = jax.tree.map(np.asarray, jencdec.encdec_init(KEY, jcfg))
    batch = _inputs(cfg)
    jq, q = _quants(quant)

    def run():
        jp = jax.tree.map(jnp.asarray, init)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        enc = jax.jit(lambda p, f: jencdec.encode(p, f, jcfg, jq, None))(
            jp, jb["frames"])
        xk, xv = jax.jit(lambda p, e: jencdec.encdec_precompute_cross(
            p, e, jcfg, jq))(jp, enc)

        def probed(p, b):
            with jhealth.collect() as hp:
                loss, _ = jencdec.encdec_loss(p, b, jcfg, jq, None)
            return loss, hp
        (loss, hp), grads = jax.jit(jax.value_and_grad(probed, has_aux=True))(
            jp, jb)
        logits = []
        if quant == "int8":
            step = jax.jit(lambda p, t, c, x: jencdec.encdec_decode_step(
                p, t, c, x, jcfg, jq))
            cache = jencdec.encdec_init_cache(jcfg, B, 16)
            for t in range(INT8_STEPS):
                lg, cache = step(jp, jb["tokens"][:, t:t + 1], cache,
                                 (xk, xv))
                logits.append(np.asarray(lg))
        return dict(enc=np.asarray(enc), xk=np.asarray(xk),
                    xv=np.asarray(xv), loss=float(loss),
                    grads=dict(_leaves(jax.tree.map(np.asarray, grads))),
                    probes={t: float(c["exp"]) for t, c in hp.items()},
                    logits=logits)
    ref = _exact_scales(run) if quant == "int8" else run()
    return dict(ref, init=init, batch=batch, q=q, cfg=cfg)


@pytest.fixture(scope="module")
def fp32():
    return _reference("fp32")


@pytest.fixture(scope="module")
def int8():
    return _reference("int8")


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# =========================================================================
# Config, tree, sinusoids
# =========================================================================

def test_config_is_the_reference_config():
    cfg = registry.get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jregistry.get_config(ARCH))
    jcfg, rcfg = _configs()
    assert dataclasses.asdict(rcfg) == dataclasses.asdict(jcfg)
    assert (cfg.n_enc_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab) == (32, 32, 1280, 20, 64,
                                                    5120, 51866)
    assert (cfg.enc_dec, cfg.norm, cfg.act, cfg.frontend) == (
        True, "layernorm", "gelu", "audio_stub")
    assert abs(cfg.param_count() - 1.55e9) / 1.55e9 < 0.05
    assert (rcfg.n_enc_layers, rcfg.n_heads, rcfg.n_kv_heads,
            rcfg.head_dim) == (2, 4, 2, 32)
    # the decoder-only model refuses it and points at models/encdec.py
    with pytest.raises(NotImplementedError, match="models/encdec.py"):
        lm.lm_init(torch.Generator(), rcfg, device="cpu")


def test_params_from_jax_carries_the_encdec_tree():
    jcfg, cfg = _configs()
    init = jax.tree.map(np.asarray, jencdec.encdec_init(KEY, jcfg))
    ref = dict(_leaves(init))
    got = dict(_leaves(params_from_jax(init)))
    assert sorted(got) == sorted(ref)
    for name, r in ref.items():
        np.testing.assert_array_equal(got[name].numpy(), r, err_msg=name)
    own = encdec.encdec_init(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    assert {k: tuple(v.shape) for k, v in _leaves(own)} == {
        k: r.shape for k, r in ref.items()}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            encdec.encdec_init(torch.Generator(), cfg)
        with pytest.raises(RuntimeError):
            encdec.encdec_init_cache(cfg, 1, 8)


@pytest.mark.parametrize("start", [0, 7, 1000, 4096 - 10])
def test_sinusoid_rows_at_an_offset_match_the_full_table(start):
    _, cfg = _configs()
    D, n = cfg.d_model, cfg.max_position_embeddings
    assert n == 4096
    full = encdec._sinusoids(n, D)
    ref = np.asarray(jencdec._sinusoids(n, D))
    rows = encdec._sinusoids(S, D, torch.tensor(start, dtype=torch.int32))
    assert rows.shape == (S, D)
    assert torch.equal(rows, full[start:start + S])
    # an ulp of exp in inv moves an angle t · inv by an ulp of the angle
    atol = 4 * float(np.spacing(np.float32(start + S)))
    np.testing.assert_allclose(rows.numpy(), ref[start:start + S], atol=atol,
                               rtol=0)
    # _dec_embed adds the rows of the positions index .. index + S
    params = params_from_jax(jax.tree.map(
        np.asarray, jencdec.encdec_init(KEY, _configs()[0])))
    toks = torch.from_numpy(_inputs(cfg)["tokens"])
    q = QuantConfig.fp32()
    x = encdec._dec_embed(params, toks, cfg, q, None, index=start)
    np.testing.assert_array_equal(
        x.numpy(), (params["embed"][toks] + full[start:start + S]).numpy())


# =========================================================================
# Cross-attention
# =========================================================================

@pytest.mark.parametrize("Sq", [1, 7])
def test_cross_attention_projects_q_only(Sq, monkeypatch):
    """``kv_override`` against the reference's, FP32: q alone projected
    (wk / wv get no gradient), RoPE on q only; a one-row query without a
    cache takes ``flash_attention``, not ``_decode_attention``."""
    _, cfg = _configs()
    rng = np.random.default_rng(5)
    D, KV, hd = cfg.d_model, cfg.n_kv_heads, cfg.head_dim
    p = {n: rng.standard_normal(s).astype(np.float32) * 0.05 for n, s in (
        ("wq", (D, 4 * hd)), ("wk", (D, KV * hd)), ("wv", (D, KV * hd)),
        ("wo", (4 * hd, D)))}
    x = rng.standard_normal((B, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, hd)).astype(np.float32)
    ref, _ = jblocks.attention_apply(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), cfg,
        JQuantConfig.fp32(), None, causal=False,
        kv_override=(jnp.asarray(k), jnp.asarray(v)), cache_index=3)
    monkeypatch.setattr(blocks, "_decode_attention", None)
    tp = {n: torch.from_numpy(a).requires_grad_(True) for n, a in p.items()}
    out, cache = blocks.attention_apply(
        tp, torch.from_numpy(x), cfg, QuantConfig.fp32(), None,
        causal=False, kv_override=(torch.from_numpy(k), torch.from_numpy(v)),
        cache_index=3)
    assert cache is None and out.shape == (B, Sq, D)
    ref = np.asarray(ref)
    assert np.abs(out.detach().numpy() - ref).max() <= 1e-5 * np.abs(
        ref).max()
    grads = torch.autograd.grad(out.sum(), list(tp.values()),
                                allow_unused=True)
    got = dict(zip(tp, grads))
    assert got["wk"] is None and got["wv"] is None
    assert got["wq"].abs().max() > 0


# =========================================================================
# Encode, cross K/V, one loss step
# =========================================================================

@pytest.mark.parametrize("quant", ["fp32", "int8"])
def test_encode_and_cross_kv_match_reference(quant, request):
    ref = request.getfixturevalue(quant)
    cfg, q = ref["cfg"], ref["q"]
    params = params_from_jax(ref["init"])
    tol = 1e-5 if quant == "fp32" else 2e-3
    with torch.no_grad():
        enc = encdec.encode(params, torch.from_numpy(ref["batch"]["frames"]),
                            cfg, q, None)
        xk, xv = encdec.encdec_precompute_cross(params, enc, cfg, q)
        k0, v0 = encdec._cross_kv(
            blocks.unstack(params["dec_blocks"], cfg.n_layers)[1]["xattn"],
            enc, cfg, q, None)
    assert xk.shape == xv.shape == (cfg.n_layers, B, T, cfg.n_kv_heads,
                                    cfg.head_dim)
    assert torch.equal(xk[1], k0) and torch.equal(xv[1], v0)
    for name, got in (("enc", enc), ("xk", xk), ("xv", xv)):
        r = ref[name]
        assert got.dtype == torch.float32 and got.shape == r.shape, name
        assert np.abs(got.numpy() - r).max() <= tol * np.abs(r).max(), name


@pytest.mark.parametrize("quant", ["fp32", "int8"])
def test_loss_and_grads_match_reference(quant, request):
    ref = request.getfixturevalue(quant)
    cfg, q = ref["cfg"], ref["q"]
    loss, m, grads = trainer.loss_and_grads(
        encdec.encdec_loss, params_from_jax(ref["init"]),
        _tensors(ref["batch"]), cfg, q, None)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-6)
    assert float(m["ce"]) == float(loss)
    got = dict(_leaves(grads))
    assert sorted(got) == sorted(ref["grads"])
    for name, r in ref["grads"].items():
        g = got[name].numpy()
        assert g.shape == r.shape and np.isfinite(g).all(), name
        assert np.abs(r).max() > 0, name
        err = np.abs(g - r).max() / np.abs(r).max()
        if quant == "fp32":
            assert err <= 1e-4, (name, err)
        elif name in ("embed", "final_norm.g", "final_norm.b"):
            assert err <= 2e-3, (name, err)
        else:
            rel = np.linalg.norm(g - r) / np.linalg.norm(r)
            qk = name.endswith(("attn.wq", "attn.wk"))
            assert rel <= (0.5 if qk else 0.1), (name, rel)


def test_probe_set_is_the_reference_set(int8):
    """The stacks run with probes suspended, as the reference's: only the
    encoder's and the decoder's final norms report."""
    cfg, q = int8["cfg"], int8["q"]
    with health.collect() as hp:
        encdec.encdec_loss(params_from_jax(int8["init"]),
                           _tensors(int8["batch"]), cfg, q, None)
    assert sorted(hp) == sorted(int8["probes"]) == ["enc_ln", "final_norm"]
    for tag, c in hp.items():
        assert float(c["exp"]) == int8["probes"][tag], tag


# =========================================================================
# Decode
# =========================================================================

def test_fp32_decode_matches_the_teacher_forced_decoder(fp32):
    """S tokens stepped through the cache (FP32 cache, as the reference's
    own decode test) over the precomputed cross K/V, against the training
    decoder's logits at every position."""
    cfg, q = fp32["cfg"], fp32["q"]
    params = params_from_jax(fp32["init"])
    b = _tensors(fp32["batch"])
    with torch.no_grad():
        enc = encdec.encode(params, b["frames"], cfg, q, None)
        x = encdec._dec_embed(params, b["tokens"], cfg, q, None)
        full = encdec._head(params, encdec._decoder(params, x, enc, cfg, q,
                                                    None), cfg, q, None)
        cross = encdec.encdec_precompute_cross(params, enc, cfg, q)
        cache = encdec.encdec_init_cache(cfg, B, S + 3, dtype=torch.float32,
                                         device="cpu")
        assert cache["index"].shape == () and cache["k"].shape == (
            cfg.n_layers, B, S + 3, cfg.n_kv_heads, cfg.head_dim)
        k_before = cache["k"]
        for t in range(S):
            logits, cache = encdec.encdec_decode_step(
                params, b["tokens"][:, t:t + 1], cache, cross, cfg, q)
            assert logits.shape == (B, 1, lm.padded_vocab(cfg))
            np.testing.assert_allclose(logits[:, 0].numpy(),
                                       full[:, t].numpy(), atol=2e-4, rtol=0)
    assert int(cache["index"]) == S and cache["k"] is k_before
    assert cache["k"][:, :, :S].abs().max() > 0
    assert cache["k"][:, :, S:].abs().max() == 0


def test_int8_decode_steps_match_reference(int8):
    cfg, q = int8["cfg"], int8["q"]
    params = params_from_jax(int8["init"])
    b = _tensors(int8["batch"])
    with torch.no_grad():
        enc = encdec.encode(params, b["frames"], cfg, q, None)
        cross = encdec.encdec_precompute_cross(params, enc, cfg, q)
        cache = encdec.encdec_init_cache(cfg, B, 16, device="cpu")
        assert cache["k"].dtype == torch.bfloat16
        for t, ref in enumerate(int8["logits"]):
            logits, cache = encdec.encdec_decode_step(
                params, b["tokens"][:, t:t + 1], cache, cross, cfg, q)
            got = logits.numpy()
            assert got.shape == ref.shape and np.isfinite(got).all()
            assert np.abs(got - ref).max() <= 2e-3 * np.abs(ref).max(), t
    assert len(int8["logits"]) == INT8_STEPS


# =========================================================================
# Remat, the launcher
# =========================================================================

def _stochastic_step(cfg, params, batch, seed, remat, monkeypatch):
    if not remat:
        monkeypatch.setattr(lm, "_remat", lambda fn, x, key: fn(x, key))
    q = dataclasses.replace(QuantConfig.int8(), stochastic_fwd=True)
    gen = torch.Generator().manual_seed(seed)
    live = topt.tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = dict(_leaves(live))
    loss, _ = encdec.encdec_loss(live, batch, cfg, q, gen)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    monkeypatch.undo()
    return loss.detach(), dict(zip(leaves, grads)), gen.get_state()


def test_remat_replays_the_forward_noise_bit_for_bit(monkeypatch):
    _, cfg = _configs()
    params = encdec.encdec_init(torch.Generator().manual_seed(3), cfg,
                                device="cpu")
    batch = _tensors(_inputs(cfg))
    calls = []
    remat = lm._remat
    monkeypatch.setattr(lm, "_remat", lambda *a: calls.append(1) or remat(
        *a))
    loss, grads, state = _stochastic_step(cfg, params, batch, 9, True,
                                          monkeypatch)
    assert len(calls) == cfg.n_enc_layers + cfg.n_layers
    loss0, grads0, state0 = _stochastic_step(cfg, params, batch, 9, False,
                                             monkeypatch)
    assert torch.equal(loss, loss0)
    for name, g in grads.items():
        assert torch.isfinite(g).all() and g.abs().max() > 0, name
        assert torch.equal(g, grads0[name]), name
    assert torch.equal(state, state0)


_LAUNCH = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
           "--seq", "16", "--log-every", "1"]


def test_launcher_make_batch_gives_the_reference_frames():
    _, cfg = _configs()
    raw = {"tokens": np.zeros((3, 5), np.int32),
           "labels": np.zeros((3, 5), np.int32)}
    b = launch_train.make_batch(cfg, raw)
    np.testing.assert_array_equal(
        b["frames"], np.random.default_rng(0).standard_normal(
            (3, 5, cfg.d_model)).astype(np.float32))
    assert b["frames"].dtype == np.float32 and b["tokens"] is raw["tokens"]


@pytest.mark.parametrize("flags", [["--state-bits", "8"], ["--sentinel"],
                                   ["--gather-bits", "8"]])
def test_launcher_trains_the_encdec_tree(flags):
    losses = launch_train.main(_LAUNCH + ["--steps", "2"] + flags)
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_launcher_checkpoint_save_then_restore(tmp_path):
    """Two steps saved, then a run restored from them takes the third: its
    loss is the uninterrupted three-step run's, bit for bit."""
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    straight = launch_train.main(_LAUNCH + ["--steps", "3"])
    first = launch_train.main(_LAUNCH + ckpt + ["--steps", "2"])
    resumed = launch_train.main(_LAUNCH + ckpt + ["--steps", "1"])
    assert first == straight[:2] and resumed == straight[2:]
    assert all(np.isfinite(straight))
