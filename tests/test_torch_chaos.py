"""The port's robustness slice against the reference: health probes
(``core/health.py``), the numerics sentinel (``train/sentinel.py``), the
chaos harness (``train/chaos.py``), the fault loop (``train/fault.py``)
and the launcher's recovering step loop.

* Probes: a no-op without a collector; a reduced qwen's forward reports
  at the reference's canonical tags, with the same exponents and the clip
  and zero rates within 4 elements' share (the two sides' activations
  agree to f32 rounding, which moves an element across a rounding edge
  now and then: measured 2 of 4096 at the final norm); a remat recompute
  in the backward probes nothing.
* The sentinel step: a clean step updates, a NaN-injected step leaves
  params and moments bit-identical, and it calls each kernel exactly as
  often as the plain step (counted through the plain versions, which is
  what a CPU tensor runs).  The host loop gives the reference's events
  and policies on the same metric sequences.
* Chaos: the same seeded random draws as the reference's monkey, the same
  flipped bits; a reduced ``launch.train --state-bits 8 --sentinel`` run
  with a preemption, a moment bit-flip and a corrupted checkpoint ends
  bit for bit at the clean run's parameters and moments.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.core import health as jhealth  # noqa: E402
from repro.core import qtensor as jq  # noqa: E402
from repro.core.qconfig import QuantConfig as JQuantConfig  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import chaos as jchaos  # noqa: E402
from repro.train import sentinel as jsentinel  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import health, int_ops, qtensor  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.kernels import (bfp_matmul, dfx_quant,  # noqa: E402
                                 int_attention, int_norm, ops)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import (chaos, checkpoint, fault,  # noqa: E402
                               optimizer as topt, sentinel, trainer)

_RN = dataclasses.replace(QuantConfig.int8(), stochastic_grad=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These runs are many tiny ops: one intra-op thread keeps them from
    stalling on a CPU that other test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(vocab, bs=2, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, vocab, (bs, seq)))
            for k in ("tokens", "labels")}


# ------------------------------ probes -----------------------------------

def test_probe_is_noop_without_collector(monkeypatch):
    calls = []
    monkeypatch.setattr(health, "stats",
                        lambda x, b: calls.append(b) or {
                            k: torch.tensor(0.0) for k in health.REDUCTIONS})
    health.probe(("blocks", "0", "attn"), torch.ones(4), 8)
    assert calls == [] and not health.active()
    with health.collect() as hp:
        with health.suspend():
            health.probe(("embed",), torch.ones(4), 8)
        health.probe(("blocks", "3", "mlp"), torch.ones(4), 8)
        health.probe(("blocks", "-1", "mlp"), torch.ones(4), 8)
    assert calls == [8, 8] and sorted(hp) == ["blocks.*.mlp"]
    assert health.canonical_tag(("blocks", "3", "attn")) == "blocks.*.attn"
    assert health.canonical_tag(("blocks", "-1", "mlp")) == "blocks.*.mlp"
    assert health.canonical_tag(("embed",)) == "embed"


def test_reductions_merge_and_summarize_as_reference():
    rng = np.random.default_rng(2)
    obs = [{k: np.float32(rng.uniform(0, 3)) for k in health.REDUCTIONS}
           for _ in range(3)]
    a = {"x": {k: torch.tensor(v) for k, v in obs[0].items()}}
    b = {"x": {k: torch.tensor(v) for k, v in obs[1].items()},
         "y": {k: torch.tensor(v) for k, v in obs[2].items()}}
    ja = {"x": {k: jnp.float32(v) for k, v in obs[0].items()}}
    jb = {"x": {k: jnp.float32(v) for k, v in obs[1].items()},
          "y": {k: jnp.float32(v) for k, v in obs[2].items()}}
    got, ref = health.merge(a, b), jhealth.merge(ja, jb)
    for t in ("x", "y"):
        for k in health.REDUCTIONS:
            assert float(got[t][k]) == float(ref[t][k])
    s, rs = health.summarize(got), jhealth.summarize(ref)
    assert {k: float(v) for k, v in s.items()} == {
        k: float(v) for k, v in rs.items()}


def test_probes_report_the_reference_tags_and_counters():
    jcfg = jregistry.get_config("qwen1.5-0.5b").reduced()
    cfg = registry.get_config("qwen1.5-0.5b").reduced()
    init = jax.tree.map(np.asarray, jlm.lm_init(jax.random.PRNGKey(0), jcfg))
    b = _batch(cfg.vocab)
    qj = dataclasses.replace(JQuantConfig.int8(), backend="pallas",
                             stochastic_grad=False)
    def probed(p, batch):
        with jhealth.collect() as hp:
            jlm.lm_loss(p, batch, jcfg, qj, None)
        return hp
    ref = jax.jit(probed)(jax.tree.map(jnp.asarray, init),
                          {k: jnp.asarray(v.numpy()) for k, v in b.items()})
    params = params_from_jax(init)
    with health.collect() as hp:
        loss, _ = lm.lm_loss(params, b, cfg, _RN, None)
    assert sorted(hp) == sorted(ref)
    assert {"embed", "lm_head", "final_norm", "blocks.*.attn",
            "blocks.*.mlp", "blocks.*.ln1", "blocks.*.ln2"} <= set(hp)
    for tag, c in hp.items():
        r = ref[tag]
        assert float(c["exp"]) == float(r["exp"]), tag
        assert float(c["nonfinite"]) == float(r["nonfinite"]) == 0.0
        for k in ("clip", "zero"):      # 4 elements of 2 x 16 x 128
            assert abs(float(c[k]) - float(r[k])) <= 4.0 / 4096, (tag, k)
    # the backward's remat recompute runs inside this collector and probes
    # nothing: every tag's counters are the forward's objects
    live = topt.tree_map(lambda p: p.requires_grad_(True), params)
    with health.collect() as hp2:
        loss, _ = lm.lm_loss(live, b, cfg, _RN, None)
        before = dict(hp2)
        loss.backward()
    assert all(hp2[t] is before[t] for t in before) and hp2.keys() == \
        before.keys()


# ----------------------------- sentinel ----------------------------------

def _setup(state_bits=8):
    cfg = registry.get_config("smollm-135m").reduced()
    params = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    ocfg = topt.OptimizerConfig(lr=1e-3, state_bits=state_bits)
    return cfg, params, topt.init(params, ocfg), ocfg


def _state(params, opt):
    out = [p.clone() for p in topt.tree_leaves(params)]
    for t in (opt.m, opt.v):
        for x in topt.tree_leaves(t):
            out += [x.m.clone(), x.exp.clone()] if qtensor.is_qtensor(x) \
                else [x.clone()]
    return out


def test_sentinel_skips_a_nonfinite_step_bit_identical():
    cfg, params, opt, ocfg = _setup()
    step = sentinel.make_sentinel_step(lm.lm_loss, cfg, _RN, ocfg)
    b = _batch(cfg.vocab)
    before = _state(params, opt)
    p2, o2, m = step(params, opt, b, None, 1.0)
    assert float(m["skipped"]) == 1.0 and float(m["lr"]) == 0.0
    assert float(m["health"]["grads"]["nonfinite"]) > 0
    after = _state(p2, o2)
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    p3, o3, m3 = step(p2, o2, b, None, 0.0)
    assert float(m3["skipped"]) == 0.0 and float(m3["lr"]) > 0
    assert {"embed", "lm_head", "grads"} <= set(m3["health"])
    assert float(m3["health"]["grads"]["nonfinite"]) == 0
    assert any(not torch.equal(x, y) for x, y in zip(after,
                                                     _state(p3, o3)))


def _count_kernel_calls(monkeypatch) -> dict:
    """Count each wrapper's plain-version calls (a CPU tensor's kernel)."""
    counts = {}
    for mod in (dfx_quant, bfp_matmul, int_norm, int_attention):
        for name in dir(mod):
            if name.endswith("_plain") and name[:-6] in ops.WRAPPERS:
                f = getattr(mod, name)

                def counted(*a, _f=f, _n=name[:-6], **k):
                    counts[_n] = counts.get(_n, 0) + 1
                    return _f(*a, **k)
                monkeypatch.setattr(mod, name, counted)
    return counts


def test_sentinel_adds_zero_kernel_calls(monkeypatch):
    cfg, params, opt, ocfg = _setup(state_bits=0)
    counts = _count_kernel_calls(monkeypatch)
    b = _batch(cfg.vocab)
    plain = trainer.make_train_step(lm.lm_loss, cfg, _RN, ocfg)
    plain(topt.tree_map(torch.clone, params), topt.init(params), b, None)
    n_plain = dict(counts)
    counts.clear()
    sent = sentinel.make_sentinel_step(lm.lm_loss, cfg, _RN, ocfg)
    sent(topt.tree_map(torch.clone, params), topt.init(params), b, None, 0.0)
    assert sum(n_plain.values()) > 0 and counts == n_plain


def _metrics(clip_by_tag, skipped=0.0, mk=float):
    hp = {t: {"clip": mk(c), "zero": mk(0.0), "nonfinite": mk(0.0),
              "exp": mk(0.0)} for t, c in clip_by_tag.items()}
    return {"skipped": mk(skipped), "health": hp}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sentinel_loop_matches_reference(seed):
    """Random clip sequences over four scopes (and isolated skips): the
    same events and escalated policies as the reference's loop."""
    rng = np.random.default_rng(seed)
    scfg = dict(clip_high=0.25, clip_low=0.05, patience=2, cooldown=5,
                max_escalations=3)
    mine = sentinel.Sentinel(sentinel.SentinelConfig(**scfg),
                             QuantConfig.int8())
    ref = jsentinel.Sentinel(jsentinel.SentinelConfig(**scfg),
                             JQuantConfig.int8())
    tags = ("embed", "blocks.*.mlp", "blocks.*.attn", "lm_head")
    for step in range(60):
        clips = {t: float(rng.choice([0.01, 0.1, 0.3, 0.6])) for t in tags}
        skipped = float(step % 7 == 3)
        a = mine.observe(step, _metrics(clips, skipped))
        r = ref.observe(step, _metrics(clips, skipped, jnp.float32))
        assert (a is None) == (r is None), step
        if a is not None:
            assert [(x.pattern, x.overrides) for x in a.rules] == [
                (x.pattern, x.overrides) for x in r.rules]
    assert mine.events == ref.events and mine.escalations >= 1


def test_sentinel_escalation_and_persistent_nonfinite():
    s = sentinel.Sentinel(sentinel.SentinelConfig(patience=3, cooldown=5),
                          QuantConfig.int8())
    pol = None
    for step in range(5):
        pol = s.observe(step, _metrics({"blocks.*.mlp": 0.4})) or pol
        if pol is not None:
            break
    assert pol is not None and step == 2
    leaf = pol.resolve("blocks.3.mlp.w1")
    assert leaf.weight_bits == leaf.act_bits == leaf.grad_bits == 16
    assert pol.resolve("blocks.0.attn.wq").weight_bits == 8
    s2 = sentinel.Sentinel(sentinel.SentinelConfig(nonfinite_patience=3),
                           QuantConfig.int8())
    s2.observe(0, _metrics({}, 1.0))
    s2.observe(1, _metrics({}, 1.0))
    with pytest.raises(sentinel.NumericsError):
        s2.observe(2, _metrics({}, 1.0))


# ------------------------------- chaos -----------------------------------

def test_chaos_monkey_fires_once_and_draws_as_reference():
    m = chaos.ChaosMonkey(chaos.ChaosConfig(preempt_at=(3,), nan_grad_at=(4,)))
    with pytest.raises(chaos.Preemption):
        m.before_step({"x": 1}, 3)
    assert m.before_step({"x": 1}, 3) == {"x": 1}
    assert (m.nan_flag(4), m.nan_flag(4), m.nan_flag(5)) == (1.0, 0.0, 0.0)
    for kind in ("bitflip", "ckpt", "exp"):
        a = chaos.ChaosMonkey(chaos.ChaosConfig(seed=5))._rng(kind, 7)
        b = jchaos.ChaosMonkey(jchaos.ChaosConfig(seed=5))._rng(kind, 7)
        assert a.integers(1 << 30, size=4).tolist() == \
            b.integers(1 << 30, size=4).tolist()


def test_corruption_matches_reference_and_leaves_the_state_alone():
    x = np.random.default_rng(0).standard_normal((16, 16)).astype(np.float32)
    t = qtensor.quantize(torch.from_numpy(x), 8, group_axis=0)
    r = jq.quantize(jnp.asarray(x), 8, group_axis=0)
    np.testing.assert_array_equal(t.m.numpy(), np.asarray(r.m))
    m0 = t.m.clone()
    for exponent in (False, True):
        got = chaos.corrupt_qtensor(t, np.random.default_rng(3),
                                    exponent=exponent)
        ref = jchaos.corrupt_qtensor(r, np.random.default_rng(3),
                                     exponent=exponent)
        np.testing.assert_array_equal(got.m.numpy(), np.asarray(ref.m))
        np.testing.assert_array_equal(got.exp.numpy(), np.asarray(ref.exp))
    assert torch.equal(t.m, m0)
    tree = (({"w": torch.ones(4, 4)}), topt.OptState(
        torch.zeros((), dtype=torch.int32), {"w": t}, {"w": t}), None)
    out = chaos.corrupt_leaf(tree, np.random.default_rng(0))
    assert torch.equal(out[0]["w"], torch.ones(4, 4)) and out[2] is None
    assert isinstance(out[1], topt.OptState)
    changed = [not torch.equal(a.m, t.m) for a in (out[1].m["w"],
                                                   out[1].v["w"])]
    assert sum(changed) == 1 and torch.equal(t.m, m0)
    floats = {"small": torch.zeros(2), "big": torch.zeros(64)}
    out2 = chaos.corrupt_leaf(floats, np.random.default_rng(0))
    assert torch.equal(out2["small"], torch.zeros(2))
    assert bool((out2["big"] != 0).any()) and not bool(floats["big"].any())


# ------------------------------ fault loop -------------------------------

def test_recovery_emits_events_and_heartbeats(tmp_path):
    hb = str(tmp_path / "hb")
    calls, events = {"n": 0}, []

    def step(state, k):
        if k == 2 and calls["n"] == 0:
            calls["n"] += 1
            if os.path.exists(hb):
                os.unlink(hb)
            raise RuntimeError("boom")
        return state + 1

    out = fault.run_with_recovery(
        step, 0, start_step=0, num_steps=4,
        fault_cfg=fault.FaultConfig(heartbeat_path=hb),
        restore_fn=lambda: (1, 1), on_event=events.append)
    assert out == 4
    assert [e["type"] for e in events][:2] == ["retry", "restore"]
    assert os.path.exists(hb)
    assert not [f for f in os.listdir(tmp_path) if ".tmp-" in f]
    mon = fault.StragglerMonitor(fault.FaultConfig())
    assert not mon.observe(0, 60.0) and mon.ewma is None
    for i in range(1, 6):
        assert not mon.observe(i, 1.0)
    assert mon.observe(6, 5.0) and mon.flagged == [(6, 5.0)]
    with pytest.raises(RuntimeError, match="boom"):
        fault.run_with_recovery(
            lambda s, k: (_ for _ in ()).throw(RuntimeError("boom")), 0,
            start_step=0, num_steps=2, restore_fn=lambda: (0, 0),
            fault_cfg=fault.FaultConfig(max_retries=2))


def _toy_loop(tmp, ccfg, steps=12):
    rng = np.random.default_rng(0)
    w0 = torch.from_numpy(rng.standard_normal((16, 16)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32))

    def sgd(w):
        w = w.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(
            int_ops.int_linear(x, w, None, None, _RN).square().mean(), w)
        return w.detach() - 0.1 * g

    events = []

    def restore_fn():
        got = checkpoint.restore_latest(tmp, {"w": w0}, on_event=events.append)
        assert got is not None
        return got

    final = fault.run_with_recovery(
        chaos.ChaosMonkey(ccfg).wrap(lambda st, k: {"w": sgd(st["w"])}),
        {"w": w0}, start_step=0, num_steps=steps,
        save_fn=lambda st, k: checkpoint.save(tmp, k, st),
        restore_fn=restore_fn, save_every=3, on_event=events.append)
    return final, events


def test_toy_chaos_loops_recover_to_the_clean_trajectory(tmp_path):
    clean, _ = _toy_loop(str(tmp_path / "clean"), chaos.ChaosConfig())
    ccfg = chaos.ChaosConfig(seed=7, preempt_at=(4,), bitflip_at=(7,),
                             drop_psum_at=(10,), corrupt_ckpt_at=(8,),
                             ckpt_dir=str(tmp_path / "chaos"))
    got, events = _toy_loop(str(tmp_path / "chaos"), ccfg)
    assert torch.equal(clean["w"], got["w"])
    kinds = [e["type"] for e in events]
    assert kinds.count("retry") == kinds.count("restore") == 4
    assert {e["error"] for e in events if e["type"] == "retry"} == {
        "Preemption", "StateCorruption", "CollectiveTimeout"}
    assert {"type": "ckpt-corrupt", "step": 6} in events


# ------------------------------ launcher ---------------------------------

_ARGV = ["--reduced", "--device", "cpu", "--steps", "8", "--batch", "2",
         "--seq", "16", "--state-bits", "8", "--sentinel", "--ckpt-every",
         "2", "--log-every", "100"]


def _final(run):
    return _state(run.params, run.opt_state)


def test_launcher_chaos_run_ends_at_the_clean_run(tmp_path):
    clean = launch_train.train(launch_train.parse_args(
        _ARGV + ["--ckpt-dir", str(tmp_path / "a")]))
    run = launch_train.train(launch_train.parse_args(
        _ARGV + ["--ckpt-dir", str(tmp_path / "b"), "--chaos-preempt-at",
                 "3", "--chaos-bitflip-at", "5", "--chaos-corrupt-ckpt-at",
                 "7", "--chaos-seed", "2"]))
    kinds = [e["type"] for e in run.events]
    assert kinds.count("retry") == kinds.count("restore") == 3
    assert {"type": "ckpt-corrupt", "step": 6} in run.events
    assert all(torch.equal(a, b) for a, b in zip(_final(clean), _final(run)))
    assert run.losses == clean.losses
    assert qtensor.is_qtensor(run.opt_state.m["embed"])
    # a run restored from its checkpoint goes on as the uninterrupted one
    half = _ARGV + ["--ckpt-dir", str(tmp_path / "h"), "--steps", "4"]
    launch_train.train(launch_train.parse_args(half))
    resumed = launch_train.train(launch_train.parse_args(half))
    assert sorted(resumed.losses) == [4, 5, 6, 7]
    assert all(torch.equal(a, b) for a, b in zip(_final(clean),
                                                 _final(resumed)))


def test_launcher_nan_step_is_skipped_bit_identical(tmp_path):
    seen = {}
    args = launch_train.parse_args(_ARGV + ["--ckpt-dir", str(tmp_path),
                                            "--steps", "5",
                                            "--chaos-nan-at", "4"])
    run = launch_train.build(args)
    launch_train.train(args, lambda i, m: seen.__setitem__(
        i, _final(run)) if i in (3, 4) else None, run)
    assert [e for e in run.events if e["type"] == "skip-step"] == [
        {"type": "skip-step", "step": 4, "streak": 1}]
    assert all(torch.equal(a, b) for a, b in zip(seen[3], seen[4]))


def test_launcher_flag_checks():
    with pytest.raises(SystemExit):
        launch_train.parse_args(["--chaos-nan-at", "3"])
    with pytest.raises(SystemExit):
        launch_train.parse_args(["--sentinel", "--grad-compress-bits", "8"])
    args = launch_train.parse_args(
        ["--state-bits", "8", "--gather-bits", "8", "--ckpt-dir", "d",
         "--sentinel", "--chaos-straggle-at", "1,4"])
    assert (args.state_bits, args.gather_bits, args.chaos_straggle_at) == (
        8, 8, (1, 4))
