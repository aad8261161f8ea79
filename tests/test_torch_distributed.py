"""The port's distributed training (``sharding.py``, ``launch/mesh.py``,
``train/trainer.py``'s SPMD and compressed steps, sharded checkpoints,
``launch.train`` under ``torchrun``) against ``tests/test_distributed.py``'s
cases, on gloo worlds of CPU processes (``torch_dist_worker.spawn``: a
free port, a timeout, the world torn down on failure): one world of 2, 4
and 8 ranks each, every case of that size run on it in turn
(``spawn_group``), shared through module fixtures.  The reference runs
once, in a subprocess with 8 host devices, shared by the cases through a
module fixture.

Stated tolerances:

* ``param_pspecs`` / ``qtensor_pspecs``: the reference's specs, spec for
  spec, for every arch in ``ARCH_IDS`` at full size (shapes only).
* ``quantized_all_gather`` on a (4, 2) mesh of 8 ranks: the reference's
  output bit for bit (``jnp.exp2`` exact at integer arguments on its
  side); the gradient all ones (straight through).
* The FP32 SPMD step on (2, 2), reduced qwen1.5-0.5b, ``fsdp=True``,
  from the reference's weights, its products split over the model axis
  (tensor-parallel compute, ``sharding.tensor_parallel``): against the
  reference's one-device step and its own (2, 2) step, the loss within
  1e-4 and every parameter within 2e-5 (the reference test's bounds);
  its residual stream whole on every model rank (its worker case sets
  ``sharding.SEQUENCE_SHARDING`` False: the test counts ``tp_out``).
* The int8 round-to-nearest SPMD step on data 2 against the port's
  one-device step (batch 4, a power of two): the loss within 1e-6
  relative, every parameter within 1e-5 of its largest magnitude, and
  every per-tensor exponent of the step equal (with and without
  ``microbatches=2``); inside ``manual_axes_active`` a rank-local tensor
  keeps its own exponent.
* The loss's batch means under a mesh: reduced mixtral-8x7b, int8 round
  to nearest, on data 2 with labels masked unevenly over the ranks' rows,
  against the port's one-device step: every exponent equal, the loss and
  the balance loss within 1e-6 relative, every parameter within 1e-5 of
  its largest magnitude.  Its MoE layer in FP32 on data 2 at T·K = 4160
  (the reference's shard-local capacity dispatch, with drops) against the
  reference's under its data-2 mesh: each rank's rows within 1e-5 of the
  output's largest magnitude, the ranks' mean balance loss within 1e-5
  relative (the reference's archs test's bounds).
* The quantized state plane (``gather_bits=8``, int8 moments) on (4, 2),
  reduced smollm-135m, lr 2e-3: the last 20 losses' mean within 1% of
  the FP32-state run's and the loss falling by more than 0.5
  (``STATE_PLANE_STEPS`` steps).
* Chaos across 4 ranks (preempt 6, bit-flip 9, dropped collective 12;
  sharded checkpoints saved and restored): the final loss within 1e-5 of
  the clean run's.
* The compressed step on (pods 2, data 2), FP32 loss config, against the
  reference's: the loss within 1e-5 relative; the leaves that take the
  int8 all-reduce (65536 elements or more) within 1e-5 of their largest
  magnitude (measured: 4e-9 of a 0.08 max); every other leaf within 1e-5
  of its largest magnitude or 5e-3 of the learning rate (0.5% of a first
  AdamW step), whichever is larger.  The small leaves take the FP32 sum,
  whose order differs from XLA's, and AdamW's first step turns an ulp of
  a near-zero gradient into a visible move, as large as the reference's
  own: measured 2.9e-6 on ``wq`` (2.9e-3 of its 1e-3 step; the
  reference's compressed step is 2.0e-6 from its one-device step there),
  1.2e-6 on ``bk``, whose gradient is zero in exact arithmetic (the
  reference's own: 6.8e-7).
"""
import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import sharding  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import qtensor  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train import trainer  # noqa: E402
from torch_dist_worker import spawn, spawn_group  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
#: the state-plane run's steps (the reference's test takes 200; at 60 the
#: last-20 window is past the first descent: measured 0.22% apart, 0.58%
#: at 50, 1.3% at 40, where the window still falls steeply)
STATE_PLANE_STEPS = 60
MESHES = {"2x4": (2, 4), "4x2": (4, 2)}

_REFERENCE = r'''
import functools, json, os, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import sharding
from repro.configs import registry
from repro.core import grad_compress, qtensor
from repro.core.qconfig import QuantConfig
from repro.models import encdec, lm
from repro.train import optimizer as opt_lib, trainer

_orig = jnp.exp2
def _exp2(x):
    x = jnp.asarray(x)
    if x.dtype != jnp.float32:
        return _orig(x)
    n = x.astype(jnp.int32)
    bits = jnp.left_shift(jnp.clip(n, -126, 127) + 127, 23)
    return jnp.where(n.astype(jnp.float32) == x,
                     jax.lax.bitcast_convert_type(bits, jnp.float32), _orig(x))
jnp.exp2 = _exp2
out_path = sys.argv[1]
out = {}

def spec(ns):
    return [list(s) if isinstance(s, tuple) else s for s in tuple(ns.spec)]

# ---- specs of every arch at full size
specs, shapes = {}, {}
for arch in registry.ARCH_IDS:
    cfg = registry.get_config(arch)
    init = (functools.partial(encdec.encdec_init, cfg=cfg) if cfg.enc_dec
            else functools.partial(lm.lm_init, cfg=cfg))
    sh = jax.eval_shape(init, jax.eval_shape(lambda: jax.random.PRNGKey(0)))
    shapes[arch] = {sharding._path_str(p): list(l.shape) for p, l in
                    jax.tree_util.tree_flatten_with_path(sh)[0]}
    for name, mshape in (("2x4", (2, 4)), ("4x2", (4, 2))):
        mesh = sharding.make_mesh_compat(mshape, ("data", "model"))
        for fsdp in (True, False):
            ps = sharding.param_pspecs(sh, mesh, fsdp=fsdp)
            specs[f"{arch}|{name}|{fsdp}"] = {
                sharding._path_str(p): spec(l) for p, l in
                jax.tree_util.tree_flatten_with_path(ps)[0]}
            if name == "4x2" and fsdp:
                like = jax.eval_shape(functools.partial(
                    opt_lib.init, cfg=opt_lib.OptimizerConfig(state_bits=8)),
                    sh)
                qs = sharding.qtensor_pspecs(like.m, ps, mesh)
                leaves = jax.tree_util.tree_flatten_with_path(
                    qs, is_leaf=qtensor.is_qtensor)[0]
                specs[f"{arch}|qtensor"] = {
                    sharding._path_str(p): {"m": spec(q.m), "exp": spec(q.exp)}
                    for p, q in leaves}
out["specs"] = np.array(json.dumps(specs))
out["shapes"] = np.array(json.dumps(shapes))

# ---- the int8 gather on (4, 2)
rng = np.random.default_rng(0)
gin = {"w": rng.standard_normal((8, 16)).astype(np.float32),
       "v": rng.standard_normal((6, 4)).astype(np.float32),
       "g": rng.standard_normal((12,)).astype(np.float32)}
mesh = sharding.make_mesh_compat((4, 2), ("data", "model"))
pspecs = {"w": NamedSharding(mesh, P("data", "model")),
          "v": NamedSharding(mesh, P(None, "data")),
          "g": NamedSharding(mesh, P())}
params = {k: jax.device_put(jnp.asarray(v), pspecs[k]) for k, v in gin.items()}
got = jax.jit(lambda p: sharding.quantized_all_gather(
    p, mesh, bits=8, pspecs=pspecs))(params)
for k in gin:
    out[f"gather_in/{k}"] = gin[k]
    out[f"gather_out/{k}"] = np.asarray(got[k])

# ---- reduced qwen: the FP32 step, one device and (2, 2); the compressed
# step on (pod 2, data 2)
cfg = registry.get_config("qwen1.5-0.5b").reduced()
key = jax.random.PRNGKey(0)
init = jax.tree.map(np.asarray, lm.lm_init(key, cfg))
for p, l in jax.tree_util.tree_flatten_with_path(init)[0]:
    out["init/" + sharding._path_str(p)] = l
# the reference test's batch (tokens and labels from one key)
batch = {k: np.asarray(jax.random.randint(key, (4, 32), 0, cfg.vocab))
         for k in ("tokens", "labels")}
out.update(batch)
opt_cfg = opt_lib.OptimizerConfig(lr=1e-3)
qcfg = QuantConfig.fp32()
step = trainer.make_train_step(lm.lm_loss, cfg, qcfg, opt_cfg)
jb = {k: jnp.asarray(v) for k, v in batch.items()}
params = jax.tree.map(jnp.asarray, init)
p1, _, m1 = jax.jit(step)(params, opt_lib.init(params), jb, key)
mesh = sharding.make_mesh_compat((2, 2), ("data", "model"))
sharding.set_mesh(mesh)
params2, opt2, pspecs = trainer.init_train_state(
    lambda k: jax.tree.map(jnp.asarray, init), key, mesh, fsdp=True)
stepj = trainer.jit_train_step(step, mesh, pspecs, donate=False)
p2, _, m2 = stepj(params2, opt2, jb, key)
out["fp32/loss_one"] = np.float32(m1["loss"])
out["fp32/loss_mesh"] = np.float32(m2["loss"])
for tag, tree in (("one", p1), ("mesh", p2)):
    for p, l in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[f"fp32_{tag}/" + sharding._path_str(p)] = np.asarray(l)
sharding.set_mesh(None)
mesh = sharding.make_mesh_compat((2, 2, 1), ("pod", "data", "model"))
cstep = trainer.make_compressed_train_step(
    lm.lm_loss, cfg, qcfg, opt_cfg, mesh,
    trainer.TrainConfig(grad_compress_bits=8, donate=False))
params = jax.tree.map(jnp.asarray, init)
p3, _, _, m3 = cstep(params, opt_lib.init(params),
                     grad_compress.init_residuals(params), jb, key)
out["compressed_loss"] = np.float32(m3["loss"])
for p, l in jax.tree_util.tree_flatten_with_path(p3)[0]:
    out["compressed/" + sharding._path_str(p)] = np.asarray(l)

# ---- reduced mixtral's MoE layer, FP32, under a data-2 mesh: T·K = 4160
# over both shards (> 4096), so the reference dispatches shard-locally, two
# groups of 1040 tokens at a capacity of 768 rows per expert
from repro.models import blocks as jblocks
mcfg = registry.get_config("mixtral-8x7b").reduced()
minit = lm.lm_init(key, mcfg)
mtree = {k: np.array(v[0]) for k, v in minit["blocks"]["moe"].items()}
# a router that sends most first choices to expert 0, past its capacity
mtree["router"][:, 0] += 0.5 * np.sign(mtree["router"][:, 0] + 1e-9)
mx = np.abs(np.random.default_rng(4).standard_normal(
    (4, 520, mcfg.d_model))).astype(np.float32) * np.sign(
    mtree["router"][:, 0])
mesh = sharding.make_mesh_compat((2, 1), ("data", "model"))
sharding.set_mesh(mesh)
my, maux = jax.jit(lambda p, x: jblocks.moe_apply(
    p, x, mcfg, QuantConfig.fp32(), None))(
    jax.tree.map(jnp.asarray, mtree), jnp.asarray(mx))
sharding.set_mesh(None)
for k, v in mtree.items():
    out["moe_in/" + k] = v
out["moe_x"], out["moe_y"] = mx, np.asarray(my)
out["moe_aux"] = np.float32(maux)
np.savez(out_path, **out)
print("REFERENCE_OK")
'''


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                        str(path)], capture_output=True, text=True,
                       timeout=600, env=env)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr[-4000:]
    data = dict(np.load(path))
    data["specs"] = json.loads(str(data["specs"]))
    data["shapes"] = json.loads(str(data["shapes"]))
    return data


def _sub(ref, prefix):
    return {k[len(prefix) + 1:]: v for k, v in ref.items()
            if k.startswith(prefix + "/")}


def _step_inputs(ref):
    return {**{f"init/{k}": v for k, v in _sub(ref, "init").items()},
            "tokens": ref["tokens"], "labels": ref["labels"]}


def _shape_tree(flat: dict) -> dict:
    tree = {}
    for path, shape in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.empty(shape, device="meta")
    return tree


def _flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat_specs(v, key))
        else:
            out[key] = v
    return out


def _listed(spec):
    return [list(s) if isinstance(s, tuple) else s for s in spec]


# =========================================================================
# Specs and meshes
# =========================================================================

@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_pspecs_match_reference(ref, arch, mesh, fsdp):
    m = sharding.Mesh(MESHES[mesh], ("data", "model"))
    got = _flat_specs(sharding.param_pspecs(
        _shape_tree(ref["shapes"][arch]), m, fsdp=fsdp))
    want = ref["specs"][f"{arch}|{mesh}|{fsdp}"]
    assert sorted(got) == sorted(want)
    for path, spec in want.items():
        assert _listed(got[path]) == spec, (path, got[path], spec)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_qtensor_pspecs_match_reference(ref, arch):
    m = sharding.Mesh((4, 2), ("data", "model"))
    shapes = _shape_tree(ref["shapes"][arch])
    pspecs = sharding.param_pspecs(shapes, m, fsdp=True)
    like = {}
    for path in ref["shapes"][arch]:
        node = like
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = qtensor.QTensor(m=torch.empty(0), exp=torch.empty(
            0), bits=8)
    got = _flat_specs(sharding.qtensor_pspecs(like, pspecs, m))
    for path, spec in ref["specs"][f"{arch}|qtensor"].items():
        q = got[path]
        assert qtensor.is_qtensor(q)
        assert (_listed(q.m), _listed(q.exp)) == (spec["m"], spec["exp"]), \
            path


def test_production_mesh_shapes():
    assert launch_mesh.production_mesh_shape(multi_pod=False) == (
        (16, 16), ("data", "model"))
    assert launch_mesh.production_mesh_shape(multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))
    for multi in (False, True):
        # 256 / 512 ranks: this world has one
        with pytest.raises(ValueError, match="ranks; the world has 1"):
            launch_mesh.make_production_mesh(multi_pod=multi)
    assert launch_mesh.make_host_mesh() is None
    with pytest.raises(ValueError, match="torchrun"):
        launch_mesh.make_host_mesh(pods=2)


def test_use_fsdp_is_the_reference_set():
    assert registry.use_fsdp("mistral-large-123b")
    assert not registry.use_fsdp("qwen1.5-0.5b")
    assert registry.FSDP_ARCHS <= set(registry.ARCH_IDS)


def test_local_rows_follow_the_microbatch_split():
    m = sharding.Mesh((2, 1), ("data", "model"), rank=1)
    b = {"tokens": np.arange(8)[:, None]}
    assert local_ids(trainer.local_rows(b, m, 1)) == [4, 5, 6, 7]
    # rank 1's rows of microbatch 0 (rows 0-3), then of microbatch 1
    assert local_ids(trainer.local_rows(b, m, 2)) == [2, 3, 6, 7]


def local_ids(b):
    return [int(x) for x in b["tokens"][:, 0]]


# =========================================================================
# The int8 gather, the SPMD steps, the compressed step
# =========================================================================

@pytest.fixture(scope="module")
def world8(ref, tmp_path_factory):
    """The 8-rank cases on one world: the int8 gather, the state plane."""
    return spawn_group({"gather": _sub(ref, "gather_in"),
                        "state_plane": {"steps": np.int64(STATE_PLANE_STEPS)}},
                       8, str(tmp_path_factory.mktemp("world8")),
                       timeout=700)


@pytest.fixture(scope="module")
def world4(ref, tmp_path_factory):
    """The 4-rank cases on one world: the FP32 and compressed steps,
    chaos."""
    return spawn_group({"fp32_step": _step_inputs(ref),
                        "compressed_step": _step_inputs(ref),
                        "chaos": {"none": np.zeros(1)}},
                       4, str(tmp_path_factory.mktemp("world4")),
                       timeout=400)


@pytest.fixture(scope="module")
def world2(ref, tmp_path_factory):
    """The 2-rank cases on one world: the int8 step, the MoE layer and
    step."""
    cfg = registry.get_config("mixtral-8x7b").reduced()
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    labels[0, 8:] = -1                   # rank 0: 8 + 21 valid labels,
    labels[1, ::3] = -1                  # rank 1: 64
    moe_in = {**{f"moe_in/{k}": v for k, v in _sub(ref, "moe_in").items()},
              "moe_x": ref["moe_x"]}
    return spawn_group({"int8_step": _step_inputs(ref), "moe_layer": moe_in,
                        "int8_moe_step": {"tokens": tokens,
                                          "labels": labels}},
                       2, str(tmp_path_factory.mktemp("world2")))


def test_quantized_all_gather_matches_reference(ref, world8):
    inp = _sub(ref, "gather_in")
    outs = [o["gather"] for o in world8]
    want = _sub(ref, "gather_out")
    for r, o in enumerate(outs):
        for k in inp:
            np.testing.assert_array_equal(o["got"][k].numpy(), want[k],
                                          err_msg=f"rank {r} {k}")
            g = o["grads"][k]
            assert tuple(g.shape) == o["block_shapes"][k]
            assert torch.equal(g, torch.ones_like(g)), (r, k)
    # int8 planes and int32 exponents on the wire, never f32, for the two
    # data-sharded leaves; the replicated one does not travel
    st = outs[0]["stats"]
    assert st[("gather_int8", "calls")] == 4
    assert ("gather_f32", "calls") not in st
    assert st[("gather_int8", "bytes")] == 8 * 16 + 6 * 4 + 4 * (8 + 4)


def test_fp32_spmd_step_matches_reference(ref, world4):
    out = world4[0]["fp32_step"]
    assert out["specs"]["blocks/attn/wq"] == (None, "data", "model")
    # the products were split over the model group
    assert out["stats"][("tp_out", "calls")] > 0
    for tag in ("one", "mesh"):
        assert abs(out["loss"] - float(ref[f"fp32/loss_{tag}"])) < 1e-4
        want = _sub(ref, f"fp32_{tag}")
        assert sorted(want) == sorted(out["params"])
        for k, w in want.items():
            np.testing.assert_allclose(out["params"][k].numpy(), w,
                                       atol=2e-5, err_msg=f"{tag} {k}")


@pytest.fixture(scope="module")
def int8_world(world2):
    return [o["int8_step"] for o in world2]


@pytest.mark.parametrize("microbatches", [1, 2])
def test_int8_rn_spmd_step_matches_one_device(int8_world, microbatches):
    o = int8_world[0][microbatches]
    assert o["exps"] == o["exps_one"] and len(o["exps"]) > 20
    np.testing.assert_allclose(o["loss"], o["loss_one"], rtol=1e-6)
    for k, want in o["params_one"].items():
        got = o["params"][k]
        assert torch.all(torch.isfinite(got)), k
        tol = 1e-5 * float(want.abs().max())
        assert float((got - want).abs().max()) <= tol, k
    # both ranks hold the same logical step
    assert int8_world[1][microbatches]["exps"] == o["exps"]


@pytest.mark.cuda
def test_int8_rn_spmd_step_on_the_card(tmp_path):
    """The same step with the CUDA kernels, two gloo ranks sharing the
    card (their collectives staged through the host), from the port's
    own init: every exponent equal to the one-device step's on the card,
    the loss within 1e-6 relative, every parameter within 1e-5 of its
    largest magnitude or 1e-3 of the learning rate (0.1% of a first AdamW
    step), whichever is larger.  The second term is for the small leaves:
    on the card a bias gradient's row sums run in another order on two
    ranks, and AdamW's first step turns an ulp of a near-zero element into
    a visible move (measured: 2.9e-8, 2.9e-5 of ``bq``'s 1e-3 step)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the chip)")
    from repro_torch.models import lm
    cfg = registry.get_config("qwen1.5-0.5b").reduced()
    init = lm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    inp = {f"init/{k}": v.numpy() for k, v in _flat_specs(init).items()}
    inp.update({k: rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)
                for k in ("tokens", "labels")}, device=np.array("cuda"))
    outs = spawn("int8_step", 2, inp, str(tmp_path))
    for mb in (1, 2):
        o = outs[0][mb]
        assert o["exps"] == o["exps_one"] == outs[1][mb]["exps"]
        np.testing.assert_allclose(o["loss"], o["loss_one"], rtol=1e-6)
        for k, want in o["params_one"].items():
            tol = max(1e-5 * float(want.abs().max()), 1e-3 * 1e-3)
            assert float((o["params"][k] - want).abs().max()) <= tol, k


def test_capacity_is_decided_on_the_logical_tokens():
    """Two groups of 1040 tokens hold T·K = 4160 > 4096: each takes the
    capacity dispatch (ceil128(1.25 · 2080 / 4) = 768 rows), as each data
    shard does in the reference; one such group alone is drop-free."""
    from repro_torch.models import blocks
    cfg = registry.get_config("mixtral-8x7b").reduced()
    assert blocks.capacity(cfg, 1040, 2) == 768
    assert blocks.capacity(cfg, 1040) == 2080
    assert blocks.capacity(cfg, 1024, 2) == 2048


def test_moe_layer_under_a_mesh_matches_reference(ref, world2):
    outs = [o["moe_layer"] for o in world2]
    want = ref["moe_y"]
    top = np.abs(want).max()
    for r, o in enumerate(outs):
        assert o["cap"] == 768 and o["dropped"] > 0, o["dropped"]
        got = o["y"].numpy()
        assert np.abs(got - want[2 * r:2 * r + 2]).max() <= 1e-5 * top, r
    np.testing.assert_allclose(np.mean([o["aux"] for o in outs]),
                               float(ref["moe_aux"]), rtol=1e-5)


def test_int8_moe_step_with_uneven_labels_matches_one_device(world2):
    o = world2[0]["int8_moe_step"]
    assert o["exps"] == o["exps_one"] and len(o["exps"]) > 20
    np.testing.assert_allclose(o["loss"], o["loss_one"], rtol=1e-6)
    np.testing.assert_allclose(o["aux"], o["aux_one"], rtol=1e-6)
    for k, want in o["params_one"].items():
        got = o["params"][k]
        assert torch.all(torch.isfinite(got)), k
        tol = 1e-5 * float(want.abs().max())
        assert float((got - want).abs().max()) <= tol, k


def test_manual_axes_keep_the_local_exponent(int8_world):
    for rank, o in enumerate(int8_world):
        loc = o["local"]
        assert loc["spmd"] == max(w["local"]["own"] for w in int8_world)
        assert loc["manual"] == loc["own"]
    assert int8_world[0]["local"]["own"] != int8_world[1]["local"]["own"]


def test_compressed_step_matches_reference(ref, world4):
    out = world4[0]["compressed_step"]
    np.testing.assert_allclose(out["loss"], float(ref["compressed_loss"]),
                               rtol=1e-5)
    want = _sub(ref, "compressed")
    assert sorted(want) == sorted(k for k in out["params"])
    lr = 1e-3
    for k, w in want.items():
        err = np.abs(out["params"][k].numpy() - w).max()
        # the compressed leaves (min_size 65536) within 1e-5 of their own
        # max; an FP32-summed leaf also within 0.5% of its AdamW step
        tol = 1e-5 * np.abs(w).max()
        assert err <= (tol if w.size >= 65536 else max(tol, 5e-3 * lr)), k


# =========================================================================
# The state plane, chaos, the launcher
# =========================================================================

def test_quantized_state_plane_tracks_fp32(world8):
    out = world8[0]["state_plane"]
    base, quant = out["base"], out["quant"]
    assert len(quant) == STATE_PLANE_STEPS
    tail_b, tail_q = np.mean(base[-20:]), np.mean(quant[-20:])
    assert quant[-1] < quant[0] - 0.5, (quant[0], quant[-1])
    assert abs(tail_q - tail_b) / tail_b < 0.01, (tail_b, tail_q)


def test_chaos_recovery_across_ranks_matches_clean(world4):
    outs = [o["chaos"] for o in world4]
    for o in outs:
        assert abs(o["clean"] - o["chaos"]) < 1e-5, o
        assert o["events"].count("restore") == 3, o["events"]


def _torchrun(args, tmp_path, timeout=240):
    """``launch.train`` under ``torchrun --nproc-per-node 2``; the whole
    process group (the agent and its workers) is killed at ``timeout``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    p = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--reduced", "--device", "cpu", "--steps", "3", "--batch", "4",
         "--seq", "16", "--log-every", "1", *args], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    return subprocess.CompletedProcess(p.args, p.returncode, out, err)


@pytest.mark.parametrize("flags", [["--pods", "2", "--grad-compress-bits",
                                    "8"], ["--gather-bits", "8"]],
                         ids=["compressed", "gather8"])
def test_launcher_trains_under_torchrun(flags, tmp_path):
    r = _torchrun(flags, tmp_path)
    assert r.returncode == 0, r.stderr[-4000:]
    losses = [float(line.split("loss=")[1].split()[0])
              for line in r.stderr.splitlines() if " loss=" in line]
    assert len(losses) == 3 and all(np.isfinite(losses)), r.stderr[-2000:]
    assert "done: 3 steps" in r.stderr


@pytest.mark.parametrize("argv,match", [
    (["--grad-compress-bits", "8"], "needs --pods > 1"),
    (["--pods", "2", "--grad-compress-bits", "8", "--sentinel"],
     "mutually exclusive"),
])
def test_launcher_flag_errors(argv, match, capsys):
    with pytest.raises(SystemExit):
        launch_train.parse_args(argv)
    assert match in capsys.readouterr().err


def test_launcher_without_a_world_refuses_a_mesh():
    args = launch_train.parse_args(["--reduced", "--device", "cpu",
                                    "--pods", "2"])
    with pytest.raises(ValueError, match="torchrun"):
        launch_train.init_world(args)
