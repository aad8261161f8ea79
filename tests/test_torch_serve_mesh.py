"""Serving under a mesh: ``sharding.serving`` (the reference's dry-run
layout), ``sharding.cache_pspecs`` and the rank's cache
(``lm.init_cache`` / ``encdec.encdec_init_cache`` with ``mesh``), the
Mamba2 decode split, whisper's cross K/V of the rank's heads and the
engine over the ranks (``serve/engine.py`` under ``sharding.set_mesh``),
on gloo worlds of CPU processes (``torch_dist_worker``): one world of 2
ranks, a (data 1, model 2) mesh, shared by every arch through a module
fixture, and one of 4, a (data 2, model 2) mesh, for the batcher.  The
reference runs once, in this process, for qwen.

Stated tolerances:

* Each reduced arch on (1, 2), int8 round to nearest, against the
  one-device port in the same process (qwen, a kv-replicated qwen with
  one kv head, qwen2-moe, mamba2 and zamba2 through ``Engine.generate``,
  2 x (8 prompt + 3 new); llava's ``lm_prefill`` with its 8 patches;
  whisper's encode, cross K/V and 3 decode steps): every per-tensor and
  per-slice exponent equal, in order (the integer data's scales); every
  step's whole logits rows within 1e-5 of the one-device rows' largest
  magnitude (measured: equal bit for bit; only the row-parallel f32 sums
  change order); the greedy tokens equal; both ranks' logits equal; each
  rank's cache the one-device cache's block (``cache_slices``: its kv
  heads or, with one kv head, that head; its SSD heads and conv channels;
  the B / C conv state whole) within the same bound, its first layer's
  k / v bit for bit.
* The batcher on (2, 2) with staggered admissions (5 requests over 4
  slots, the slots' rows split over ``data``): under FP32 every slot's
  logits rows within 1e-5 relative of the request's solo one-device run
  (measured 3.6e-7: the sum order), its tokens equal; under int8 round to
  nearest every exponent and every logits row as the same schedule on one
  device, within 1e-5 (measured: equal); one prompt, which the data
  axis does not split, served whole on every rank as on one device.
* The 2-rank qwen run from the reference's weights against
  ``repro.serve.engine.Engine.generate`` (int8, pallas route in interpret
  mode): the greedy tokens equal, every step's logits within 5e-3 of the
  reference's largest magnitude (``test_torch_serve.py``'s bound: the
  reference's ``exp2`` outside its exact window).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch_dist_worker as tdw  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import lm  # noqa: E402

TOL = 1e-5
NAMES = list(tdw.SERVE_ARCHS)
CACHED = [n for n in NAMES if n != "llava"]
B, PROMPT, NEW, STEPS = 2, 8, 3, 3


def _inputs():
    rng = np.random.default_rng(0)
    return {"prompts": rng.integers(0, 512, (B, PROMPT)).astype(np.int32),
            "new": np.array(NEW),
            "frames": rng.standard_normal((B, 8, 128)).astype(np.float32),
            "dec": rng.integers(0, 512, (STEPS, B)).astype(np.int32),
            "patches": rng.standard_normal((B, 8, 128)).astype(np.float32)}


@pytest.fixture(scope="module")
def ref():
    """The reference's reduced qwen weights, and its ``Engine.generate``
    on the prompts: the tokens and every step's logits."""
    from repro.configs import registry as jregistry
    from repro.core.qconfig import QuantConfig as JQuantConfig
    from repro.models import lm as jlm
    from repro.serve.engine import Engine as JEngine
    from repro.serve.engine import ServeConfig as JServeConfig
    cfg = jregistry.get_config("qwen1.5-0.5b").reduced()
    params = jlm.lm_init(jax.random.PRNGKey(0), cfg)
    q = dataclasses.replace(JQuantConfig.int8(), backend="pallas")
    eng = JEngine(params, cfg, q, JServeConfig(max_seq=32, batch_slots=B))
    seen, sample = [], eng._sample

    def recorded(logits, key):
        seen.append(np.asarray(logits[:, -1]))
        return sample(logits, key)
    eng._sample = recorded
    toks = eng.generate(_inputs()["prompts"], NEW)
    flat = tdw._flat(jax.tree.map(np.asarray, params), "qwen/init")
    return {"init": flat, "tokens": np.asarray(toks),
            "logits": np.stack(seen)}


@pytest.fixture(scope="module")
def world2(ref, tmp_path_factory):
    inp = dict(_inputs(), names=np.array(NAMES), **ref["init"])
    out = tdw.spawn_group({"serve_mesh": inp}, 2,
                          str(tmp_path_factory.mktemp("serve2")))
    return [o["serve_mesh"] for o in out]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    rng = np.random.default_rng(1)
    inp = {"prompts": rng.integers(0, 512, (5, 6)).astype(np.int32),
           "budgets": np.array([5, 4, 5, 3, 4]),
           "arrive": np.array([0, 0, 2, 3, 5])}
    return tdw.spawn("serve_batcher", 4, inp,
                     str(tmp_path_factory.mktemp("serve4")))


def _close(got, want, what):
    gap = float((got.float() - want.float()).abs().max())
    assert gap <= TOL * float(want.float().abs().max()), (what, gap)


@pytest.mark.parametrize("name", NAMES)
def test_served_steps_equal_one_device(world2, name):
    one, mesh = world2[0][name]["one"], world2[0][name]["mesh"]
    assert mesh["exps"] == one["exps"] and len(one["exps"]) > 40
    assert mesh["logits"].shape == one["logits"].shape
    assert torch.isfinite(one["logits"]).all()
    _close(mesh["logits"], one["logits"], name)
    if "tokens" in one:
        assert torch.equal(mesh["tokens"], one["tokens"])
    assert torch.equal(world2[1][name]["mesh"]["logits"], mesh["logits"])


def _block_shape(cfg, name, shape):
    """The rank's block of a cache leaf on (1, 2): its kv heads (one with
    the kv replication), SSD heads and conv channels; ``index`` whole."""
    if name == "index":
        return tuple(shape)
    L, Bc = shape[:2]
    if name in ("k", "v"):
        kv = 1 if cfg.n_kv_heads % 2 else cfg.n_kv_heads // 2
        return (L, Bc, shape[2], kv, shape[4])
    if name == "ssm":
        return (L, Bc, cfg.ssm_nheads // 2) + tuple(shape[3:])
    if name == "conv_x":
        return (L, Bc, shape[2], cfg.d_inner // 2)
    return tuple(shape)


@pytest.mark.parametrize("name", CACHED)
def test_each_rank_holds_its_block_of_the_cache(world2, name):
    cfg = tdw._serve_cfg(name)
    for r, out in enumerate(world2):
        cache, block = out[name]["mesh"]["cache"], out[name]["block"]
        one = out[name]["one"]["cache"]
        assert sorted(cache) == sorted(one)
        for k, v in cache.items():
            assert tuple(v.shape) == _block_shape(cfg, k, one[k].shape), k
            assert tuple(block[k].shape) == tuple(v.shape), k
            _close(v, block[k], (name, r, k))
        if "k" in cache:
            assert torch.equal(cache["k"][0], block["k"][0])
            assert torch.equal(cache["v"][0], block["v"][0])
    if name == "qwen_kv1":
        # the one kv head, on both ranks
        assert torch.equal(world2[0][name]["block"]["k"],
                           world2[0][name]["one"]["cache"]["k"])


def test_whisper_cross_kv_are_the_ranks_heads(world2):
    for r, out in enumerate(world2):
        got = out["whisper"]["mesh"]["cross"]
        one = out["whisper"]["one"]["cross"]
        for k in ("xk", "xv"):
            h = one[k].shape[3] // 2
            assert got[k].shape[3] == h
            _close(got[k], one[k][:, :, :, r * h:(r + 1) * h], (r, k))


def test_vlm_prefill_hidden_states(world2):
    one, mesh = world2[0]["llava"]["one"], world2[0]["llava"]["mesh"]
    cfg = tdw._serve_cfg("llava")
    assert mesh["x"].shape == (B, cfg.vlm_prefix + PROMPT, cfg.d_model)
    _close(mesh["x"], one["x"], "x")


def test_engine_gathers_the_logits_over_model(world2):
    st = world2[0]["qwen"]["mesh"]["stats"]
    # the prefill and NEW decode steps: one gather of the vocabulary
    # columns each, no row gather on a data axis of 1
    assert st[("serve_logits", "calls")] == NEW + 1
    assert ("serve_rows", "calls") not in st
    assert st[("sp_gather", "calls")] > 0           # the prompt's stream
    assert ("serve_logits", "calls") not in world2[0]["qwen"]["one"]["stats"]


def test_two_rank_qwen_matches_the_reference_engine(world2, ref):
    mesh = world2[0]["qwen"]["mesh"]
    np.testing.assert_array_equal(mesh["tokens"].numpy(), ref["tokens"])
    want = ref["logits"][..., :512]
    got = mesh["logits"].numpy()[..., :512]
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 5e-3 * np.abs(want).max()


def test_batcher_over_data_and_model_matches_solo_runs(world4):
    out = world4[0]["fp32"]
    runs = list(out["mesh"]["runs"].values())
    assert len(runs) == 5
    for got, solo in zip(runs, out["solo"]):
        (want,) = solo["runs"].values()
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        assert len(got["logits"]) == len(want["logits"]) > 0
        for a, b in zip(got["logits"], want["logits"]):
            _close(a, b, "fp32 row")
    st = out["mesh"]["stats"]
    assert st[("serve_rows", "calls")] > 0 and st[("serve_logits", "calls")]
    for other in world4[1:]:
        for a, b in zip(other["fp32"]["mesh"]["runs"].values(), runs):
            np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_int8_batcher_over_data_and_model_equals_one_device(world4):
    mesh, one = world4[0]["int8"]["mesh"], world4[0]["int8"]["one"]
    assert mesh["exps"] == one["exps"] and len(one["exps"]) > 100
    for rid, got in mesh["runs"].items():
        want = one["runs"][rid]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        for a, b in zip(got["logits"], want["logits"]):
            _close(a, b, ("int8 row", rid))


def test_a_batch_the_data_axis_does_not_split_is_every_ranks(world4):
    """One prompt on (2, 2): every rank serves the whole row, its products
    split over the model group, as one device does."""
    got, one = world4[0]["one_row"]["mesh"], world4[0]["one_row"]["one"]
    assert torch.equal(got["tokens"], one["tokens"])
    _close(got["logits"], one["logits"], "one row")
    assert got["cache"]["k"].shape[1] == 1            # the row, whole
    assert ("serve_rows", "calls") not in got["stats"]
    assert got["stats"][("serve_logits", "calls")] > 0
    for other in world4[1:]:
        assert torch.equal(other["one_row"]["mesh"]["logits"],
                           got["logits"])


def test_the_engine_serves_a_ranks_fsdp_blocks(world4):
    """The engine handed the rank's FSDP blocks (``param_pspecs(fsdp=
    True)``, as a trained model's): each layer gathered over ``data`` as
    it runs, the steps as one device's."""
    got, one = world4[0]["fsdp"]["mesh"], world4[0]["fsdp"]["one"]
    assert torch.equal(got["tokens"], one["tokens"])
    _close(got["logits"], one["logits"], "fsdp blocks")
    assert got["stats"][("gather_layer_f32", "calls")] > 0


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mistral-nemo-12b",
                                  "mamba2-370m", "zamba2-2.7b"])
def test_cache_pspecs_on_the_production_mesh(arch):
    """The rank's cache on 16 x 16 (no world): the batch over ``data``, the
    kv heads over ``model`` or, where 16 does not split them (nemo's 8),
    the one head (``KV_HEAD``); the SSD heads and conv_x channels over
    ``model``, conv_BC whole; a batch of 1 whole."""
    cfg = registry.get_config(arch)
    mesh = sharding.dry_mesh((16, 16), ("data", "model"))
    for rows in (128, 1):
        like = lm.init_cache(cfg, rows, 64, dtype=torch.bfloat16,
                             device="meta")
        specs = sharding.cache_pspecs(like, mesh, cfg)
        b = "data" if rows % 16 == 0 else None
        assert specs["index"] == (b,)
        if "k" in specs:
            heads = ("model" if cfg.n_kv_heads % 16 == 0 else
                     sharding.KV_HEAD)
            assert specs["k"] == specs["v"] == (None, b, None, heads, None)
            shape = sharding.cache_block_shape(like["k"].shape, specs["k"],
                                               mesh)
            assert shape[3] == max(1, cfg.n_kv_heads // 16)
        if "ssm" in specs:
            assert specs["ssm"] == (None, b, "model", None, None)
            assert specs["conv_x"] == (None, b, None, "model")
            assert specs["conv_BC"] == (None, b, None, None)
        got = lm.init_cache(cfg, rows, 64, dtype=torch.bfloat16,
                            device="meta", mesh=mesh)
        for k, v in got.items():
            assert tuple(v.shape) == sharding.cache_block_shape(
                like[k].shape, specs[k], mesh), k
