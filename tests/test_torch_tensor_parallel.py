"""Tensor-parallel compute over the ``model`` axis (``sharding.
tensor_parallel``; ``core/int_ops.py``'s column- and row-parallel
products, ``models/blocks.py``'s local heads and widths, ``models/lm.py``'s
vocab-parallel embedding, head and loss) on gloo worlds of CPU processes
(``torch_dist_worker.spawn_group``): one world of 2 ranks, a (1, 2) mesh,
and one of 4, a (1, 4) mesh (4 query heads over 2 kv heads: each rank's
query head reads half a kv head's leaf, so k / v take the kv replication)
and a (2, 2) one.  The reference runs once, in a subprocess.

Stated tolerances:

* The FP32 step on (1, 2) and (1, 4), reduced qwen1.5-0.5b and reduced
  mixtral-8x7b, from the reference's weights and batch, against the
  reference's one-device step: the loss within 1e-4 and every parameter
  within 2e-5 (``test_torch_distributed.py``'s bounds for its (2, 2)
  step, which now splits its products too).
* Per op on (1, 2), int8 round to nearest, each against the one-device
  op on the same seeded inputs: the column-parallel ``int_linear``'s
  output columns and its weight gradient's shard (its bias gradient, an
  f32 sum over rows, within 1e-6 of its largest magnitude); the
  row-parallel one's dX and dW shards; the vocab-parallel embedding's
  rows and table gradient: bit for bit.  The row-parallel forward, the
  column-parallel dX and the vocab-parallel loss and its gradient: bit
  for bit against a one-device replay (helpers here) that adds the same
  two halves in rank order at the logical tensor's exponents; against
  the plain one-device op within 1e-6 of its largest magnitude (the f32
  sum order).
* The int8 round-to-nearest step (``stochastic_grad=False``) of reduced
  qwen1.5-0.5b and mixtral-8x7b on (1, 2), (1, 4) and (2, 2) against the
  port's one-device step from one seeded init: every per-tensor and
  per-expert exponent equal, in order; the loss within 1e-5 relative;
  each gradient leaf of an integer product (the weights and the
  embedding) bit for bit on (1, 2) and within 1e-6 of its largest
  magnitude elsewhere; a leaf summed in f32 over rows (the norms' gains,
  the biases) within 1e-6 of its largest magnitude (measured 9.3e-8:
  the sum order of the batch halves on (2, 2), of the replicated kv
  head's two query-head halves on (1, 4)).
* The same FP32 step of reduced qwen1.5-0.5b on (1, 2) under sequence
  sharding (``sharding.SEQUENCE_SHARDING``, the default), within the same
  bounds.  Every other case here holds the layout without it: their
  worker cases set the constant False (``torch_dist_worker.
  _no_sequence_sharding``); ``test_torch_sequence_parallel.py`` holds
  the sharded step against them.
* ``launch.train --model-parallel 2`` under ``torchrun`` on two gloo CPU
  ranks: the first loss within 1e-5 relative of the one-rank run's.
* ``sharding.STATS``: the model-axis collectives under their own tags —
  ``tp_out`` (row-parallel sums, the embedding's), ``tp_dx``
  (column-parallel dX sums: one per layer for q / k / v, one for gate /
  up, one for the head), ``tp_ce`` (two for the loss), ``tp_kv`` and
  ``gather_layer_kv_*`` (the kv replication) and ``exponent_model``.
"""
import dataclasses
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
from repro_torch.core import dfx, int_ops  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from torch_dist_worker import spawn_group  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ("qwen1.5-0.5b", "mixtral-8x7b")

_REFERENCE = r'''
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import sharding
from repro.configs import registry
from repro.core.qconfig import QuantConfig
from repro.models import lm
from repro.train import optimizer as opt_lib, trainer
out = {}
for arch in sys.argv[2:]:
    cfg = registry.get_config(arch).reduced()
    key = jax.random.PRNGKey(0)
    init = jax.tree.map(np.asarray, lm.lm_init(key, cfg))
    for p, l in jax.tree_util.tree_flatten_with_path(init)[0]:
        out[f"{arch}/init/" + sharding._path_str(p)] = l
    batch = {k: np.asarray(jax.random.randint(key, (4, 32), 0, cfg.vocab))
             for k in ("tokens", "labels")}
    for k, v in batch.items():
        out[f"{arch}/{k}"] = v
    step = trainer.make_train_step(lm.lm_loss, cfg, QuantConfig.fp32(),
                                   opt_lib.OptimizerConfig(lr=1e-3))
    params = jax.tree.map(jnp.asarray, init)
    p1, _, m1 = jax.jit(step)(params, opt_lib.init(params),
                              {k: jnp.asarray(v) for k, v in batch.items()},
                              key)
    out[f"{arch}/loss_one"] = np.float32(m1["loss"])
    for p, l in jax.tree_util.tree_flatten_with_path(p1)[0]:
        out[f"{arch}/one/" + sharding._path_str(p)] = np.asarray(l)
np.savez(sys.argv[1], **out)
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
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                        str(path), *ARCHS], capture_output=True, text=True,
                       timeout=600, env=env)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr[-4000:]
    return dict(np.load(path))


def _step_inputs(ref, mesh):
    inp = {k: v for k, v in ref.items()
           if k.split("/")[1] in ("init", "tokens", "labels")}
    return dict(inp, mesh=np.array(mesh), archs=np.array(ARCHS))


def _op_inputs():
    """Seeded operands of the per-op cases: a linear (x (4, 8, 64), w (64,
    96), b, the upstream gradient), an embedding (a 512-row table, ids,
    its upstream gradient) and a cross entropy (logits over 512 columns,
    labels with some masked)."""
    rng = np.random.default_rng(7)

    def f32(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    labels = rng.integers(0, 500, (4, 8)).astype(np.int64)
    labels[0, :3] = -1
    return {"model": np.int64(2), "x": f32(4, 8, 64), "w": f32(64, 96,
                                                               scale=0.05),
            "b": f32(96, scale=0.1), "gy": f32(4, 8, 96, scale=1e-3),
            "table": f32(512, 64, scale=0.02),
            "ids": rng.integers(0, 512, (4, 8)).astype(np.int64),
            "gemb": f32(4, 8, 64, scale=1e-3), "logits": f32(4, 8, 512),
            "labels": labels}


@pytest.fixture(scope="module")
def world2(ref, tmp_path_factory):
    """The (1, 2) cases on one world of 2: the per-op products, the FP32
    steps, the int8 gradients."""
    return spawn_group({"tp_ops": _op_inputs(),
                        "tp_fp32_step": _step_inputs(ref, (1, 2)),
                        "tp_int8": {"meshes": np.array([(1, 2)]),
                                    "archs": np.array(ARCHS)},
                        "sp_fp32_step": dict(
                            _step_inputs(ref, (1, 2)),
                            archs=np.array(ARCHS[:1]))},
                       2, str(tmp_path_factory.mktemp("tp2")))


@pytest.fixture(scope="module")
def world2_sp(world2):
    """The (1, 2) FP32 step under sequence sharding (``world2``'s
    ``sp_fp32_step``)."""
    return world2


@pytest.fixture(scope="module")
def world4(ref, tmp_path_factory):
    """The (1, 4) FP32 steps and the (1, 4) and (2, 2) int8 gradients on
    one world of 4 (each case makes its meshes)."""
    return spawn_group({"tp_fp32_step": _step_inputs(ref, (1, 4)),
                        "tp_int8": {"meshes": np.array([(1, 4), (2, 2)]),
                                    "archs": np.array(ARCHS)}},
                       4, str(tmp_path_factory.mktemp("tp4")))


def _rn():
    return dataclasses.replace(QuantConfig.int8(), stochastic_grad=False)


# =========================================================================
# The plan
# =========================================================================

@pytest.mark.parametrize("arch,model,kv_split", [
    ("qwen1.5-0.5b", 16, True), ("mistral-large-123b", 16, False),
    ("mixtral-8x7b", 8, True), ("qwen2-moe-a2.7b", 16, True),
    ("llava-next-mistral-7b", 4, True)])
def test_plan_splits_the_attention_stacks(arch, model, kv_split):
    mesh = sharding.Mesh((16 * 16 // model, model), ("data", "model"))
    tp = sharding.tensor_parallel(registry.get_config(arch), mesh)
    assert tp.size == model and tp.kv_split == kv_split
    assert tp.keep("blocks/attn/wq") == ("model",)
    assert tp.keep("blocks/attn/wk") == (() if not kv_split else ("model",))


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b",
                                  "whisper-large-v3"])
def test_plan_splits_the_other_stacks(arch):
    # the SSM, hybrid and enc-dec stacks split too (their own tests:
    # test_torch_tensor_parallel_state.py)
    mesh = sharding.Mesh((8, 2), ("data", "model"))
    tp = sharding.tensor_parallel(registry.get_config(arch), mesh)
    assert tp.size == 2 and tp.kv_split
    assert tp.keep("blocks/mamba/wx") == ("model",)
    assert tp.keep("blocks/mamba/norm_g") == ()
    # and a model axis of one splits nothing
    for name in (arch, "qwen1.5-0.5b"):
        assert sharding.tensor_parallel(
            registry.get_config(name),
            sharding.Mesh((8, 1), ("data", "model"))) is None


def test_plan_refuses_an_uneven_split():
    # smollm-135m's 9 query heads over 2 ranks
    mesh = sharding.Mesh((4, 2), ("data", "model"))
    with pytest.raises(ValueError, match="does not split"):
        sharding.tensor_parallel(registry.get_config("smollm-135m"), mesh)


# =========================================================================
# Per op on (1, 2)
# =========================================================================

def _halves(n):
    return [slice(0, n // 2), slice(n // 2, n)]


def _one_linear(t):
    q = _rn()
    x, w, b = (t[k].clone().requires_grad_(True) for k in ("x", "w", "b"))
    y = int_ops.int_linear(x, w, b, None, q)
    y.backward(t["gy"])
    return y.detach(), x.grad, w.grad, b.grad


def _t(inp):
    return {k: torch.from_numpy(np.array(v)) for k, v in inp.items()}


def test_column_parallel_linear_bit_for_bit(world2):
    t = _t(_op_inputs())
    q = _rn()
    y1, dx1, dw1, db1 = _one_linear(t)
    # the replay of the dX all-reduce: each rank's NT partial at the
    # logical exponents, added in rank order
    qg = dfx.quantize(t["gy"], q.grad_bits, limb_planes=True)
    qw = dfx.quantize(t["w"], q.weight_bits, limb_planes=True)
    g2 = qg.m.reshape(qg.m.shape[0], -1, qg.m.shape[-1])
    parts = [kops.dfx_matmul_tiled_nt(g2[..., c], qg.exp, q.grad_bits,
                                      qw.m[..., c], qw.exp, q.weight_bits)
             for c in _halves(96)]
    replay = (parts[0] + parts[1]).reshape(dx1.shape)
    for r, c in enumerate(_halves(96)):
        o = world2[r]["tp_ops"]["col"]
        assert torch.equal(o["y"], y1[..., c]), r
        assert torch.equal(o["dw"], dw1[:, c]), r
        assert float((o["db"] - db1[c]).abs().max()) <= 1e-6 * float(
            db1.abs().max()), r
        assert torch.equal(o["dx"], replay), r
        assert float((o["dx"] - dx1).abs().max()) <= 1e-6 * float(
            dx1.abs().max())


def test_row_parallel_linear_bit_for_bit(world2):
    t = _t(_op_inputs())
    q = _rn()
    x1, w1 = (t[k].clone().requires_grad_(True) for k in ("x", "w"))
    y1 = int_ops.int_linear(x1, w1, t["b"], None, q)
    y1.backward(t["gy"])
    y1 = y1.detach()
    # the replay of the forward all-reduce
    qx = dfx.quantize(t["x"], q.act_bits, limb_planes=True)
    qw = dfx.quantize(t["w"], q.weight_bits, limb_planes=True)
    xm = qx.m.reshape(qx.m.shape[0], -1, 64)
    parts = [kops.dfx_matmul_tiled(xm[..., k], qx.exp, q.act_bits,
                                   qw.m[:, k], qw.exp, q.weight_bits)
             for k in _halves(64)]
    replay = ((parts[0] + parts[1]).reshape(y1.shape) + t["b"])
    for r, k in enumerate(_halves(64)):
        o = world2[r]["tp_ops"]["row"]
        assert torch.equal(o["y"], replay), r
        assert float((o["y"] - y1).abs().max()) <= 1e-6 * float(
            y1.abs().max())
        assert torch.equal(o["dx"], x1.grad[..., k]), r
        assert torch.equal(o["dw"], w1.grad[k]), r


def test_vocab_parallel_embedding_bit_for_bit(world2):
    t = _t(_op_inputs())
    table = t["table"].clone().requires_grad_(True)
    y1 = int_ops.int_embedding(table, t["ids"], None, _rn())
    y1.backward(t["gemb"])
    for r, v in enumerate(_halves(512)):
        o = world2[r]["tp_ops"]["emb"]
        assert torch.equal(o["y"], y1.detach()), r
        assert torch.equal(o["dt"], table.grad[v]), r


def _ce_replay(z, labels):
    """The vocab-parallel loss and its gradient, on one device: the two
    column halves' max, sums of exps and target logits added in rank
    order, as the model group's all-reduces add them."""
    valid = labels >= 0
    lab = torch.where(valid, labels, torch.zeros_like(labels))
    zs = [z[..., v] for v in _halves(z.shape[-1])]
    m = torch.maximum(zs[0].amax(-1), zs[1].amax(-1))
    es = [torch.exp(h - m[..., None]) for h in zs]
    s = es[0].sum(-1) + es[1].sum(-1)
    zt = torch.gather(z, -1, lab[..., None])[..., 0]
    n = valid.sum().to(torch.float32)
    loss = -torch.sum((zt - m - torch.log(s)) * valid) / n
    g = -(valid / n)
    dz = torch.cat(es, -1) * (-g / s)[..., None]
    dz.scatter_add_(-1, lab[..., None], g[..., None].float())
    return loss, dz


def test_vocab_parallel_loss_bit_for_bit(world2):
    t = _t(_op_inputs())
    loss, dz = _ce_replay(t["logits"], t["labels"])
    z1 = t["logits"].clone().requires_grad_(True)
    one = lm.token_ce(z1, t["labels"])
    one.backward()
    one = one.detach()
    for r, v in enumerate(_halves(512)):
        o = world2[r]["tp_ops"]["ce"]
        assert torch.equal(o["loss"], loss), r
        assert torch.equal(o["dz"], dz[..., v]), r
        np.testing.assert_allclose(float(o["loss"]), float(one), rtol=1e-6)
        assert float((o["dz"] - z1.grad[..., v]).abs().max()) <= 1e-6 * \
            float(z1.grad.abs().max())


# =========================================================================
# Whole steps
# =========================================================================

@pytest.mark.parametrize("world,arch", [
    ("world2", ARCHS[0]), ("world2", ARCHS[1]), ("world4", ARCHS[0]),
    ("world4", ARCHS[1]), ("world2_sp", ARCHS[0])])
def test_fp32_split_step_matches_reference(ref, arch, world, request):
    outs = request.getfixturevalue(world)
    case = "sp_fp32_step" if world == "world2_sp" else "tp_fp32_step"
    o = outs[0][case][arch]
    assert abs(o["loss"] - float(ref[f"{arch}/loss_one"])) < 1e-4
    want = {k[len(arch) + 5:]: v for k, v in ref.items()
            if k.startswith(f"{arch}/one/")}
    assert sorted(want) == sorted(o["params"])
    for k, w in want.items():
        np.testing.assert_allclose(o["params"][k].numpy(), w, atol=2e-5,
                                   err_msg=k)
    # every rank of the model group ends on the same logical step
    for other in outs[1:]:
        assert other[case][arch]["loss"] == o["loss"]
    # the products were split: row-parallel sums and dX sums on the wire
    L = registry.get_config(arch).reduced().n_layers
    st = o["stats"]
    if case == "sp_fp32_step":
        # under sequence sharding: the reduce-scatters and all-gathers of
        # the residual stream, no all-reduce of it
        assert ("tp_out", "calls") not in st and ("tp_dx", "calls") not in st
        assert st[("sp_gather", "calls")] >= 4 * L + 2
        assert st[("sp_scatter", "calls")] >= 4 * L + 2
        return
    assert st[("tp_dx", "calls")] == 2 * L + 1
    assert 2 * L + 1 <= st[("tp_out", "calls")] <= 4 * L + 1


#: the leaves whose gradient is a sum in f32 over rows (no integer product)
_F32_SUMMED = ("/g", "/bq", "/bk", "/bv")


#: the int8 step's meshes, by the world they run on
INT8_MESHES = {"1x2": "world2", "1x4": "world4", "2x2": "world4"}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(INT8_MESHES))
def test_int8_split_step_matches_one_device(arch, mesh, request):
    outs = request.getfixturevalue(INT8_MESHES[mesh])
    o = outs[0]["tp_int8"][mesh][arch]
    got, one = o["mesh"], o["one"]
    assert got["exps"] == one["exps"] and len(one["exps"]) > 40
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
    for k, want in one["grads"].items():
        g = got["grads"][k]
        if mesh == "1x2" and not k.endswith(_F32_SUMMED):
            assert torch.equal(g, want), k
        tol = 1e-6 * float(want.abs().max())
        assert float((g - want).abs().max()) <= tol, k
    for other in outs[1:]:
        assert other["tp_int8"][mesh][arch]["mesh"]["exps"] == got["exps"]


@pytest.mark.parametrize("mesh", sorted(INT8_MESHES))
def test_model_axis_collectives_by_tag(mesh, request):
    outs = request.getfixturevalue(INT8_MESHES[mesh])
    D, M = (int(v) for v in mesh.split("x"))
    cfg = registry.get_config("qwen1.5-0.5b").reduced()
    L = cfg.n_layers
    st = outs[0]["tp_int8"][mesh]["qwen1.5-0.5b"]["mesh"]["stats"]
    B, S = 4 // D, 32
    assert st[("tp_dx", "calls")] == 2 * L + 1
    assert st[("tp_ce", "calls")] == 2
    assert st[("exponent_model", "calls")] > 0
    n_out = st[("tp_out", "calls")]
    assert st[("tp_out", "bytes")] == n_out * B * S * cfg.d_model * 4
    # the kv replication on (1, 4): k and v a layer, and their leaves
    # gathered over the model group under their own tag
    kv = st.get(("tp_kv", "calls"), 0)
    assert kv == (2 * L if M == 4 else 0)
    assert (("gather_layer_kv_f32", "calls") in st) == (M == 4)


# =========================================================================
# The launcher
# =========================================================================

def test_launcher_splits_compute_under_torchrun(tmp_path):
    argv = ["--reduced", "--device", "cpu", "--steps", "1", "--batch", "4",
            "--seq", "16", "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    p = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *argv,
         "--model-parallel", "2"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        _, err = p.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise
    assert p.returncode == 0, err[-4000:]
    assert "mesh={'data': 1, 'model': 2}" in err, err[-2000:]
    split = [float(line.split("loss=")[1].split()[0])
             for line in err.splitlines() if " loss=" in line]
    one = launch_train.main(argv)
    assert len(split) == 1
    np.testing.assert_allclose(split[0], one[0], rtol=1e-5)
