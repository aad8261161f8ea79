"""The port's checkpoints (``train/checkpoint.py``) against the reference's
format: a checkpoint saved by ``repro.train.checkpoint`` restores in
``repro_torch.train.checkpoint`` and the other way round, every leaf equal
(a reduced model's params and AdamW state with int8 QTensor moments after
one update, and the data state); the crc32 manifest, keep-k retention,
atomic publish, shape and dtype checks; and the reference's caveat: a
``.npy`` header broken by ``chaos.corrupt_file(default_rng(0))`` makes
``np.load`` raise ``tokenize.TokenError``, which the port counts as
corruption and falls back past.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import qtensor  # noqa: E402
from repro_torch.train import chaos, checkpoint  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402

_Q8 = dict(lr=1e-3, state_bits=8)


def _leaves(tree, prefix=""):
    """(name, leaf) pairs of nested dicts, OptStates and QTensors of either
    package, the checkpoint's names."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{prefix}{f}.")
    elif hasattr(tree, "exp") and hasattr(tree, "bits"):
        yield prefix + "m", tree.m
        yield prefix + "exp", tree.exp
    else:
        yield prefix.rstrip("."), tree


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        x, y = _np(x), _np(y)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _reference_state():
    """A reduced qwen's params and int8-moment AdamW state after one
    update, and a data state, from the reference."""
    cfg = jregistry.get_config("qwen1.5-0.5b").reduced()
    params = jlm.lm_init(jax.random.PRNGKey(0), cfg)
    opt = jopt.init(params, jopt.OptimizerConfig(**_Q8))
    g = jax.tree.map(lambda p: jnp.full_like(p, 0.01), params)
    params, opt, _ = jax.jit(jopt.update, static_argnums=0)(
        jopt.OptimizerConfig(**_Q8), g, opt, params)
    return {"params": params, "opt": opt, "data": {"index": 42}}


def _port_like(params_np):
    """The port's tree of the same structure (fresh values)."""
    p = params_from_jax(params_np)
    return {"params": p, "opt": topt.init(p, topt.OptimizerConfig(**_Q8)),
            "data": {"index": 0}}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    state = _reference_state()
    jckpt.save(str(tmp_path), 5, state)
    like = _port_like(jax.tree.map(np.asarray, state["params"]))
    got = checkpoint.restore(str(tmp_path), 5, like)
    assert qtensor.is_qtensor(got["opt"].m["embed"])
    assert got["opt"].m["embed"].bits == 8 and got["data"]["index"] == 42
    _assert_same(got["params"], state["params"])
    _assert_same(got["opt"], state["opt"])
    assert isinstance(got["params"]["embed"], torch.Tensor)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    state = _reference_state()
    jckpt.save(str(tmp_path / "a"), 1, state)
    ported = checkpoint.restore(str(tmp_path / "a"), 1, _port_like(
        jax.tree.map(np.asarray, state["params"])))
    checkpoint.save(str(tmp_path / "b"), 2, ported)
    got = jckpt.restore(str(tmp_path / "b"), 2, state)
    _assert_same(got["params"], state["params"])
    _assert_same(got["opt"], state["opt"])
    assert int(got["data"]["index"]) == 42
    # the manifests name the same leaves with the same dtypes and crc32s
    ma, mb = (json.load(open(tmp_path / d / f"step_{s:010d}" /
                             "manifest.json")) for d, s in (("a", 1),
                                                           ("b", 2)))
    assert ma["leaves"] == mb["leaves"]


def test_roundtrip_keeps_devices_dtypes_and_numbers(tmp_path):
    gen = torch.Generator().manual_seed(1)
    state = {"params": {"w": torch.randn(4, 3), "b": torch.zeros(3)},
             "opt": topt.init({"w": torch.randn(4, 3)},
                              topt.OptimizerConfig(state_bits=16)),
             "data": {"index": 7, "epoch": 2}, "rng": gen.get_state()}
    checkpoint.save(str(tmp_path), 3, state)
    assert checkpoint.latest_step(str(tmp_path)) == 3
    got = checkpoint.restore(str(tmp_path), 3, state)
    _assert_same(got, state)
    assert got["data"] == {"index": 7, "epoch": 2}
    assert type(got["data"]["index"]) is int
    g2 = torch.Generator()
    g2.set_state(got["rng"])
    assert torch.equal(torch.rand(5, generator=g2), torch.rand(5,
                                                               generator=gen))


def test_qtensor_moments_are_narrow_on_disk(tmp_path):
    params = {"w": torch.randn(64, 32), "b": torch.randn(32)}
    q = topt.init(params, topt.OptimizerConfig(state_bits=8))
    checkpoint.save(str(tmp_path), 3, {"opt": q})
    manifest = json.load(open(tmp_path / "step_0000000003" /
                              "manifest.json"))
    planes = {k: v for k, v in manifest["leaves"].items()
              if k.endswith(".m")}
    assert set(planes) == {"opt.m.b.m", "opt.m.w.m", "opt.v.b.m",
                           "opt.v.w.m"}
    assert all(v["dtype"] == "int8" for v in planes.values())
    f32 = topt.init(params)
    q_bytes = sum(x.nbytes for t in (q.m, q.v) for x in t.values())
    f_bytes = sum(x.numel() * 4 for t in (f32.m, f32.v) for x in t.values())
    assert f_bytes / q_bytes >= 3.0


def test_keep_k_atomic_and_layout_checks(tmp_path):
    for s in (1, 2, 3, 4):
        checkpoint.save(str(tmp_path), s, {"x": torch.zeros(2)}, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003",
                                            "step_0000000004"]
    assert not [d for d in os.listdir(tmp_path) if ".tmp" in d]
    with pytest.raises(ValueError, match="expected"):
        checkpoint.restore(str(tmp_path), 4, {"x": torch.zeros(3)})
    with pytest.raises(ValueError, match="dtype"):
        checkpoint.restore(str(tmp_path), 4,
                           {"x": torch.zeros(2, dtype=torch.int8)})
    with pytest.raises(KeyError):
        checkpoint.restore(str(tmp_path), 4, {"y": torch.zeros(2)})


def _save_two(tmp_path):
    s1 = {"w": torch.arange(16.0).reshape(4, 4)}
    s2 = {"w": torch.arange(16.0).reshape(4, 4) * 2}
    checkpoint.save(str(tmp_path), 1, s1)
    checkpoint.save(str(tmp_path), 2, s2)
    return s1, s2


def test_restore_detects_flipped_data_bytes(tmp_path):
    _, s2 = _save_two(tmp_path)
    leaf = tmp_path / "step_0000000002" / "leaf_00000.npy"
    with open(leaf, "r+b") as f:           # the data region: only crc sees it
        f.seek(-1, os.SEEK_END)
        b = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([b[0] ^ 0x41]))
    with pytest.raises(checkpoint.CheckpointCorruption, match="crc32"):
        checkpoint.restore(str(tmp_path), 2, s2)
    checkpoint.restore(str(tmp_path), 2, s2, verify=False)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_restore_latest_falls_back_on_corruption(tmp_path, seed):
    """Seed 0 breaks the ``.npy`` header so ``np.load`` raises
    ``tokenize.TokenError`` (the reference's caveat); every seed's bytes
    are caught, by the parser or the crc."""
    s1, _ = _save_two(tmp_path)
    leaf = str(tmp_path / "step_0000000002" / "leaf_00000.npy")
    chaos.corrupt_file(leaf, np.random.default_rng(seed))
    events = []
    got = checkpoint.restore_latest(str(tmp_path), s1,
                                    on_event=events.append)
    assert got is not None
    state, step = got
    assert step == 1 and torch.equal(state["w"], s1["w"])
    assert events == [{"type": "ckpt-corrupt", "step": 2}]


def test_latest_step_skips_broken_manifest(tmp_path):
    _save_two(tmp_path)
    assert checkpoint.latest_step(str(tmp_path)) == 2
    with open(tmp_path / "step_0000000002" / "manifest.json", "w") as f:
        f.write("{ not json")
    assert checkpoint.latest_step(str(tmp_path)) == 1
    assert checkpoint.latest_step(str(tmp_path), verify=False) == 2
    events = []
    got = checkpoint.restore_latest(str(tmp_path), {"w": torch.zeros(4, 4)},
                                    on_event=events.append)
    assert got[1] == 1 and events == [{"type": "ckpt-corrupt", "step": 2}]
    assert checkpoint.restore_latest(str(tmp_path / "none"), {}) is None
