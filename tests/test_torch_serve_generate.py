"""``Engine.generate`` (single-shot batched generation: one chunked
prefill, then decode steps) and sampled decoding, against the reference's
``repro.serve.engine.Engine`` on a reduced smollm-135m from the JAX
``lm_init`` params.

* Greedy tokens equal the reference's at fp32 and int8 (pallas backend,
  interpret mode).  Greedy tokens on random weights can collapse to one
  token and hide a fault, so the prefill logits are held too: fp32 within
  1e-5 of their largest magnitude, int8 within 5e-3 (XLA:CPU's inexact
  ``exp2`` off its exact window moves a few mantissas, as in
  ``test_torch_serve.py``).
* ``generate`` equals a manual prefill + decode loop; ``cache_dtype``
  strings resolve to torch dtypes.
* Sampling at temperature T draws from softmax(logits / T): 20,000 draws
  from a seeded ``torch.Generator`` over 8 live tokens pass a chi-square
  test against the expected counts at p = 0.001 (statistic < 24.32, 7
  degrees of freedom); T = 0, or no generator, is greedy.
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
from repro.serve import engine as jengine  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

ARCH = "smollm-135m"
B, S, NEW, SMAX = 2, 7, 5, 32


def _setup():
    jcfg = jregistry.get_config(ARCH).reduced()
    tree = jax.tree.map(np.asarray, jlm.lm_init(jax.random.PRNGKey(0), jcfg))
    prompts = np.random.default_rng(3).integers(
        0, jcfg.vocab, (B, S)).astype(np.int32)
    return jcfg, tree, prompts


def _port_engine(tree, preset, **scfg):
    cfg = registry.get_config(ARCH).reduced()
    return Engine(params_from_jax(tree, "cpu"), cfg, QuantConfig.preset(preset),
                  ServeConfig(max_seq=SMAX, batch_slots=B, **scfg),
                  device="cpu")


@pytest.mark.parametrize("preset,tol", [("fp32", 1e-5), ("int8", 5e-3)])
def test_greedy_generate_matches_reference(preset, tol):
    jcfg, tree, prompts = _setup()
    jq = JQuantConfig.preset(preset)
    if jq.enabled:
        jq = dataclasses.replace(jq, backend="pallas")
    ref_eng = jengine.Engine(jax.tree.map(jnp.asarray, tree), jcfg, jq,
                             jengine.ServeConfig(max_seq=SMAX,
                                                 batch_slots=B))
    ref_tokens = ref_eng.generate(prompts, NEW)
    ref_logits, _ = ref_eng._prefill(
        ref_eng.params, jnp.asarray(prompts),
        jlm.init_cache(jcfg, B, SMAX, dtype=jnp.float32))
    ref_logits = np.asarray(ref_logits)

    eng = _port_engine(tree, preset)
    tokens = eng.generate(prompts, NEW)
    assert tokens.dtype == np.int32 and tokens.shape == (B, NEW)
    np.testing.assert_array_equal(tokens, np.asarray(ref_tokens))
    logits, _ = eng._prefill(eng.params, torch.as_tensor(prompts),
                             eng.init_cache(B))
    logits = logits.numpy()
    assert logits.shape == ref_logits.shape
    assert np.abs(logits - ref_logits).max() <= tol * np.abs(ref_logits).max()


def test_generate_is_prefill_then_decode_and_takes_dtype_names():
    _, tree, prompts = _setup()
    eng = _port_engine(tree, "int8", cache_dtype="bfloat16")
    assert eng.scfg.cache_dtype is torch.bfloat16
    assert ServeConfig(cache_dtype="float32").cache_dtype is torch.float32
    with pytest.raises(ValueError):
        ServeConfig(cache_dtype="no_such_dtype")
    with pytest.raises(ValueError):
        ServeConfig(cache_dtype="Tensor")         # a torch name, no dtype
    out = eng.generate(prompts, NEW)
    cache = eng.init_cache(B)
    assert cache["k"].dtype == torch.bfloat16
    logits, cache = eng._prefill(eng.params, torch.as_tensor(prompts), cache)
    manual = []
    for _ in range(NEW):
        nxt = logits[:, -1, :eng.cfg.vocab].argmax(-1, keepdim=True).to(
            torch.int32)
        manual.append(nxt.numpy())
        logits, cache = eng._decode(eng.params, nxt, cache)
    np.testing.assert_array_equal(out, np.concatenate(manual, axis=1))


def test_sampling_follows_softmax_at_temperature():
    _, tree, _ = _setup()
    N, live = 20_000, 8
    for T in (1.0, 0.5):
        eng = _port_engine(tree, "fp32", temperature=T)
        V = eng.cfg.vocab
        row = torch.full((V,), -1e9)
        ids = torch.arange(live) * 3 + 5
        row[ids] = torch.tensor([0.0, 1.0, -0.5, 2.0, 0.3, -1.0, 1.5, 0.7])
        # columns past the vocab (the padded head) are never drawn
        logits = torch.cat([row, torch.full((7,), 50.0)]).expand(
            N, 1, V + 7).clone()
        got = eng._sample(logits, torch.Generator().manual_seed(11))
        assert got.shape == (N, 1) and got.dtype == torch.int32
        counts = torch.bincount(got[:, 0].long(), minlength=V)
        assert int(counts.sum() - counts[ids].sum()) == 0  # only live ids
        p = torch.softmax(row[ids].double() / T, 0)
        expected = N * p
        chi2 = float(((counts[ids].double() - expected) ** 2
                      / expected).sum())
        assert chi2 < 24.32, (T, chi2)


def test_zero_temperature_or_no_generator_is_greedy():
    _, tree, prompts = _setup()
    greedy = _port_engine(tree, "fp32").generate(prompts, NEW)
    hot = _port_engine(tree, "fp32", temperature=1.0)
    np.testing.assert_array_equal(hot.generate(prompts, NEW), greedy)
    a = hot.generate(prompts, NEW, gen=torch.Generator().manual_seed(5))
    b = hot.generate(prompts, NEW, gen=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(a, b)          # seeded: reproducible
    assert not np.array_equal(a, greedy)         # and actually sampled
    cold = _port_engine(tree, "fp32", temperature=0.0)
    np.testing.assert_array_equal(
        cold.generate(prompts, NEW, gen=torch.Generator().manual_seed(5)),
        greedy)
