"""Port parity for the whole serving slice: reduced qwen1.5-0.5b (2 layers,
GQA, QKV bias, tied embeddings) from the JAX ``lm_init`` params, chunked
prefill + 3 decode steps against the JAX model under ``int8`` on the
pallas backend (interpret mode), plus the port's continuous batcher.

Logits, not tokens, are compared (greedy tokens collapse on random
weights).  The exponents on this path lie outside XLA:CPU's exact-``exp2``
window (a matmul's output exponent is ~-19), so the reference's scales
carry ulps of error that flip a few downstream mantissas; stated
tolerance: every logits row within 5e-3 · max|reference logits| (measured
~1e-3).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.core.qconfig import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import int_ops  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve.engine import (ContinuousBatcher, Engine,  # noqa: E402
                                      QueueFull, ServeConfig)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several files at once, and
    small ops on many threads oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "qwen1.5-0.5b"


def _params(seed=0):
    """JAX lm_init params with non-trivial biases and norm gains, as numpy."""
    cfg = jregistry.get_config(ARCH).reduced()
    tree = jax.tree.map(np.asarray, jlm.lm_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)

    def perturb(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = perturb(v)
            elif k in ("bq", "bk", "bv"):
                out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
            elif k == "g":
                out[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(
                    np.float32)
            else:
                out[k] = v
        return out
    return cfg, perturb(tree)


def test_prefill_and_decode_match_jax_int8_pallas():
    jcfg, tree = _params()
    cfg = registry.get_config(ARCH).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    rng = np.random.default_rng(1)
    B, S, Smax = 2, 9, 64
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    dec = rng.integers(0, cfg.vocab, (3, B, 1)).astype(np.int32)

    jq = dataclasses.replace(JQuantConfig.int8(), backend="pallas")
    jp = jax.tree.map(jnp.asarray, tree)
    jc = jlm.init_cache(jcfg, B, Smax, dtype=jnp.float32)
    logits, jc = jax.jit(lambda p, t, c: jlm.lm_prefill_cache(
        p, t, c, jcfg, jq))(jp, toks, jc)
    ref = [np.asarray(logits)]
    step = jax.jit(lambda p, t, c: jlm.lm_decode_step(p, t, c, jcfg, jq))
    for i in range(3):
        logits, jc = step(jp, dec[i], jc)
        ref.append(np.asarray(logits))

    params = params_from_jax(tree, "cpu")
    cache = lm.init_cache(cfg, B, Smax, device="cpu")
    got = []
    with torch.no_grad():
        logits, cache = lm.lm_prefill_cache(params, torch.from_numpy(toks),
                                            cache, cfg, QuantConfig.int8())
        got.append(logits.numpy())
        for i in range(3):
            logits, cache = lm.lm_decode_step(params, torch.from_numpy(dec[i]),
                                              cache, cfg, QuantConfig.int8())
            got.append(logits.numpy())
    assert int(cache["index"][0]) == S + 3
    np.testing.assert_array_equal(cache["index"].numpy(),
                                  np.asarray(jc["index"]))
    for g, r in zip(got, ref):
        assert g.shape == r.shape == (B, 1, lm.padded_vocab(cfg))
        g, r = g[..., :cfg.vocab], r[..., :cfg.vocab]
        assert np.isfinite(g).all()
        assert np.abs(g - r).max() <= 5e-3 * np.abs(r).max()
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(jc["k"]),
                               rtol=1e-3, atol=1e-3)


def _engine(quant, slots=2, max_seq=64):
    cfg = registry.get_config(ARCH).reduced()
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    return Engine(params, cfg, quant, ServeConfig(max_seq=max_seq,
                                                  batch_slots=slots),
                  device="cpu"), cfg


def _run_tracked(engine, cfg, requests):
    """Drive a batcher, recording each request's per-step logits row."""
    b = ContinuousBatcher(engine)
    pending = sorted(requests, key=lambda t: t[2])
    rids, traj, steps = [], {}, 0
    while pending or b.queue or any(s.active for s in b.slots):
        while pending and pending[0][2] <= steps:
            p, n, _ = pending.pop(0)
            rids.append(b.submit(p, n))
        b.step()
        steps += 1
        for i, s in enumerate(b.slots):
            if s.active:
                traj.setdefault(s.request_id, []).append(
                    b._logits[i, 0, :cfg.vocab].clone())
        assert steps < 200
    return rids, traj, b.results


def test_interleaved_matches_sequential():
    """Admission snapshots, resets and restores slot rows: with rows
    independent (quantization disabled) interleaved decoding is bit-equal
    to running each request alone, logits rows included."""
    engine, cfg = _engine(QuantConfig.fp32())
    rng = np.random.default_rng(1)
    pa = rng.integers(0, cfg.vocab, 6)
    pb = rng.integers(0, cfg.vocab, 4)
    (ra,), ta, res_a = _run_tracked(engine, cfg, [(pa, 5, 0)])
    (rb,), tb, res_b = _run_tracked(engine, cfg, [(pb, 5, 0)])
    (ia, ib), ti, res = _run_tracked(engine, cfg, [(pa, 5, 0), (pb, 5, 2)])
    np.testing.assert_array_equal(res[ia], res_a[ra])
    np.testing.assert_array_equal(res[ib], res_b[rb])
    for solo, inter in [(ta[ra], ti[ia]), (tb[rb], ti[ib])]:
        assert len(solo) == len(inter)
        for ls, li in zip(solo, inter):
            assert torch.equal(ls, li)


def test_int8_batcher_drains_and_backpressures():
    engine, cfg = _engine(registry.get_quant("int8"))
    b = ContinuousBatcher(engine)
    rng = np.random.default_rng(0)
    ids = [b.submit(rng.integers(0, cfg.vocab, 5), 3) for _ in range(3)]
    res = b.run_until_drained()
    assert sorted(res) == ids and all(len(res[i]) == 3 for i in ids)
    assert not b.failed
    small = ContinuousBatcher(Engine(engine.params, cfg, engine.qcfg,
                                     ServeConfig(max_seq=64, batch_slots=1,
                                                 max_queue=1), device="cpu"))
    small.submit(np.arange(3), 1)
    with pytest.raises(QueueFull):
        small.submit(np.arange(3), 1)


def test_nonfinite_slot_is_evicted():
    engine, cfg = _engine(QuantConfig.fp32(), slots=1)
    engine.params["final_norm"]["g"][0] = float("nan")
    b = ContinuousBatcher(engine)
    rid = b.submit(np.arange(4), 3)
    b.run_until_drained()
    assert b.failed == {rid: "nonfinite_logits"}


def test_forward_only_and_unported_paths_raise():
    x = torch.randn(3, 8, requires_grad=True)
    # RMS-norm is no longer forward-only: the gradient flows and is finite
    (int_ops.int_rmsnorm(x, torch.ones(8), None, QuantConfig.int8())
     * torch.arange(8.0)).sum().backward()
    assert torch.isfinite(x.grad).all() and x.grad.abs().max() > 0
    # kept ops "integer" are ported: i_silu, within its bound of SiLU
    xs = x.detach()
    ys = int_ops.int_activation(xs, QuantConfig(kept_ops="integer"), "silu")
    assert (ys - torch.nn.functional.silu(xs)).abs().max() <= 4e-3
    # the enc-dec arch is ported (models/encdec.py), but the engine serves
    # decoder-only archs: the launcher refuses it, as the reference's does
    assert dataclasses.asdict(registry.get_config("whisper-large-v3")) == \
        dataclasses.asdict(jregistry.get_config("whisper-large-v3"))
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "whisper-large-v3", "--reduced",
                           "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            lm.init_cache(registry.get_config(ARCH).reduced(), 1, 8)


def test_launcher_runs_on_cpu(caplog):
    caplog.set_level("INFO")
    launch_serve.main(["--reduced", "--device", "cpu", "--requests", "2",
                       "--prompt-len", "4", "--max-new", "2"])
    assert "served 2 requests, 4 tokens" in caplog.text
