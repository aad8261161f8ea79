"""The port's compressed cross-pod all-reduce (``core/grad_compress.py``)
against ``repro/core/grad_compress.py`` and its tests
(``tests/test_grad_compress.py``, ``tests/test_distributed.py``).

One pod runs in this process (a gloo world of 1); several pods are gloo
worlds of CPU processes (``torch_dist_worker.spawn``, each with a
timeout).  The reference's 4-pod run is one subprocess with 8 host
devices, ``jnp.exp2`` made exact at integer arguments (caveat A).

Stated tolerances:

* one pod: the estimate equals the port's DFX quantize-dequantize bit for
  bit; below ``min_size`` the FP32 mean is the gradient and the residual
  zero; a residual tree that does not match raises ``ValueError``;
  error feedback over 16 rounds of a constant gradient brings the running
  mean within a quarter of one round's error (the reference test's).
* 8 pods: the int32 mantissa sum is exact: the estimate equals the float64
  mean of the pods' mantissas at the shared exponent, bit for bit.
* 4 pods against the reference, ``min_size=1``, two error-feedback
  rounds: the estimates and residuals of every pod bit for bit; the
  cumulative estimate within one int8 step (``amax · 2^-6``) of the true
  cumulative mean and under 0.75 of the no-feedback bias (the reference
  test's).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch import sharding  # noqa: E402
from repro_torch.core import dfx, grad_compress  # noqa: E402
from torch_dist_worker import free_port, spawn  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")

_REFERENCE = r'''
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import sharding
from repro.core import grad_compress

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
gs = np.load(sys.argv[1])["gs"]
mesh = sharding.make_mesh_compat((4,), ("pod",))

def body(g, r):
    out, nr = grad_compress.compressed_psum_mean(
        {"w": g[0]}, {"w": r[0]}, bits=8, axis="pod", min_size=1)
    return out["w"][None], nr["w"][None]

f = jax.jit(sharding.shard_map_compat(
    body, mesh, in_specs=(P("pod"), P("pod")), out_specs=(P("pod"), P("pod"))))
g = jnp.asarray(gs)
out1, res1 = f(g, jnp.zeros_like(g))
out2, res2 = f(g, res1)
np.savez(sys.argv[2], out1=np.asarray(out1), res1=np.asarray(res1),
         out2=np.asarray(out2), res2=np.asarray(res2))
print("REFERENCE_OK")
'''


@pytest.fixture(scope="module")
def one_pod():
    """A gloo world of one process and its (pod,) mesh."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        yield sharding.init_mesh((1,), ("pod",))
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(n)


def _normal(seed, shape, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(
        shape) * scale).astype(np.float32))


def test_single_pod_compression_is_quantize_dequantize(one_pod):
    g = {"w": _normal(1, (32, 32))}
    out, res = grad_compress.compressed_psum_mean(g, None, bits=8,
                                                  min_size=1, mesh=one_pod)
    ref = dfx.dequantize(dfx.quantize(g["w"], 8))
    assert torch.equal(out["w"], ref)
    assert torch.equal(res["w"], g["w"] - ref)


def test_min_size_leaves_pass_through_fp32(one_pod):
    g = {"small": torch.tensor([1.2345678, -2.5e-7, 3.0]),
         "big": torch.ones((64, 64)) * 0.1}
    out, res = grad_compress.compressed_psum_mean(
        g, grad_compress.init_residuals(g), bits=8, min_size=64,
        mesh=one_pod)
    assert torch.equal(out["small"], g["small"])
    assert torch.equal(res["small"], torch.zeros(3))
    assert out["big"].dtype == torch.float32
    # 0.1 is not on the int8 grid of its own scale: the residual carries it
    assert float(res["big"].abs().max()) > 0


def test_residual_treedef_mismatch_raises(one_pod):
    g = {"w": torch.ones(4), "b": torch.ones(4)}
    with pytest.raises(ValueError, match="residual tree"):
        grad_compress.compressed_psum_mean(g, {"w": torch.zeros(4)},
                                           min_size=1, mesh=one_pod)


def test_error_feedback_carries_residual(one_pod):
    g = {"w": _normal(0, (64, 64), 1e-3)}
    res = grad_compress.init_residuals(g)
    outs = []
    for _ in range(16):
        out, res = grad_compress.compressed_psum_mean(g, res, bits=8,
                                                      min_size=1,
                                                      mesh=one_pod)
        outs.append(out["w"])
    single = float((outs[0] - g["w"]).abs().max())
    ef = float((sum(outs) / len(outs) - g["w"]).abs().max())
    assert ef < single / 4, (ef, single)
    assert float(res["w"].abs().max()) > 0


def test_eight_pods_int32_sum_is_exact(tmp_path):
    gs = np.random.default_rng(0).standard_normal((8, 16, 16)).astype(
        np.float32)
    outs = spawn("compress", 8, {"gs": gs}, str(tmp_path))
    absmax = float(np.abs(gs).max())
    exp = np.frexp(absmax)[1] - 7
    ms = np.clip(np.round(gs.astype(np.float64) / 2.0 ** exp), -127,
                 127).astype(np.int64)
    ref = ((ms.sum(axis=0).astype(np.float64) * 2.0 ** exp) / 8).astype(
        np.float32)
    for o in outs:
        # the first round's residual input is zero: no feedback yet
        np.testing.assert_array_equal(o["out1"].numpy(), ref)


@pytest.fixture(scope="module")
def four_pods(tmp_path_factory):
    d = tmp_path_factory.mktemp("pods")
    gs = np.random.default_rng(0).standard_normal((4, 64, 128)).astype(
        np.float32)
    np.savez(d / "gs.npz", gs=gs)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(_REFERENCE),
                        str(d / "gs.npz"), str(d / "ref.npz")],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0 and "REFERENCE_OK" in r.stdout, r.stderr[-3000:]
    return gs, dict(np.load(d / "ref.npz")), spawn("compress", 4, {"gs": gs},
                                                   str(d))


def test_four_pods_match_reference_over_two_rounds(four_pods):
    _, ref, outs = four_pods
    for pod, o in enumerate(outs):
        for k in ("out1", "res1", "out2", "res2"):
            np.testing.assert_array_equal(o[k].numpy(), ref[k][pod],
                                          err_msg=f"pod {pod} {k}")


def test_four_pods_error_feedback_telescopes(four_pods):
    gs, _, outs = four_pods
    true = gs.mean(axis=0)
    amax = float(np.abs(gs).max())
    o = outs[0]
    for r in outs[1:]:
        assert torch.equal(r["out1"], o["out1"])
    err = float(np.abs(o["out1"].numpy() - true).max())
    assert err <= amax * 2.0 ** -6
    cum_ef = float(np.abs(o["out1"].numpy() + o["out2"].numpy()
                          - 2 * true).max())
    cum_no = float(np.abs(o["out1"].numpy() + o["out_no_ef"].numpy()
                          - 2 * true).max())
    assert cum_ef <= amax * 2.0 ** -6 + 1e-7, (cum_ef, amax)
    assert cum_ef < 0.75 * cum_no, (cum_ef, cum_no)
