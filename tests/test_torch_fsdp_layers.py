"""FSDP that holds one layer at a time: ``sharding.layer_view`` /
``gather_layer`` and the mesh step of ``trainer.jit_train_step``, on one
data-2 gloo world of CPU processes (``torch_dist_worker.spawn``, case
``fsdp_layers``) shared by every case through a module fixture.

Stated tolerances:

* The per-layer step against the whole-model step (every leaf gathered
  before the forward, every gradient pulled back through the gathers
  after the backward) on the same world, ``microbatches=1``, int8 round
  to nearest: the loss, every parameter, every moment (a QTensor's planes
  and exponents) and every per-tensor exponent of the step bit for bit,
  for reduced qwen1.5-0.5b (FP32 gather; and int8 gather with int8
  moments), mixtral-8x7b, mamba2-370m, zamba2-2.7b and whisper-large-v3.
* ``microbatches=2`` against the port's one-device step: every exponent
  equal, the loss within 1e-6 relative, every parameter within 1e-5 of
  its largest magnitude (``test_torch_distributed.py``'s bound).
* The collectives (``sharding.STATS`` / ``LARGEST``): the whole-leaf
  gathers and gradient sums count the non-stacked leaves only; the
  largest per-layer gather is one layer of the largest travelling stack
  leaf; under per-layer remat each travelling stack leaf is gathered 2 L
  times a step (the forward and the recompute) and its gradient summed L
  times.
* The moment noise: the rank's block drawn slice by slice equals that
  block of the one-device draw, bit for bit.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_dist_worker import LAYER_CASES, spawn  # noqa: E402

import numpy as np  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several files at once, and
    small ops on many threads oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both ranks' outputs of the one ``fsdp_layers`` world."""
    out = str(tmp_path_factory.mktemp("fsdp_layers"))
    return spawn("fsdp_layers", 2, {"none": np.zeros(1)}, out,
                 timeout=240.0)


def _equal_trees(a: dict, b: dict, what: str) -> None:
    assert a.keys() == b.keys(), what
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    assert not bad, f"{what} differ bit for bit at {bad}"


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_per_layer_step_equals_whole_model_step(world, name):
    for rank in world:
        got = rank["equal"][name]
        layer, whole = got["layer"], got["whole"]
        assert layer["loss"] == whole["loss"]
        _equal_trees(layer["params"], whole["params"], "parameters")
        _equal_trees(layer["moments"], whole["moments"], "moments")
        assert layer["exps"] and layer["exps"] == whole["exps"]
    assert world[0]["equal"][name]["layer"]["loss"] == \
        world[1]["equal"][name]["layer"]["loss"]


def test_int8_moments_are_quantized(world):
    moments = world[0]["equal"]["qwen_gather8"]["layer"]["moments"]
    planes = [v for k, v in moments.items() if k.endswith("/m")]
    assert planes and all(p.dtype == torch.int8 for p in planes)


def test_microbatches_hold_the_one_device_bound(world):
    got = world[0]["micro"]
    layer, one = got["layer"], got["one"]
    assert layer["exps"] == one["exps"]
    assert abs(layer["loss"] - one["loss"]) <= 1e-6 * abs(one["loss"])
    assert layer["params"].keys() == one["params"].keys()
    for k, ref in one["params"].items():
        err = float((layer["params"][k] - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), (k, err)


def _calls(stats: dict, tag: str) -> int:
    return int(stats.get((tag, "calls"), 0))


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_no_stacked_leaf_travels_whole(world, name):
    """Only the non-stacked leaves take the whole-leaf gather and the
    whole-leaf gradient sum, and no whole gather is larger than the
    largest of them."""
    got = world[0]["equal"][name]["layer"]
    fp = world[0]["footprint"][name]
    st, big = got["stats"], got["largest"]
    bits = LAYER_CASES[name][1]
    assert _calls(st, "grad_sum") == fp["whole"]
    # the int8 gather moves a leaf's planes and its exponent: two calls
    whole = _calls(st, "gather_f32") + _calls(st, "gather_int8") // (
        2 if bits else 1)
    assert whole == fp["whole_travel"]
    for tag in ("gather_f32", "gather_int8", "grad_sum"):
        assert big.get(tag, 0) <= fp["whole_bytes"], tag


@pytest.mark.parametrize("name", list(LAYER_CASES))
def test_one_layer_is_gathered_at_a_time(world, name):
    """The largest per-layer gather is one layer's bytes; each travelling
    stack leaf is gathered twice a layer (forward, recompute) and every
    stack leaf's gradient summed once a layer."""
    got = world[0]["equal"][name]["layer"]
    fp = world[0]["footprint"][name]
    st, big = got["stats"], got["largest"]
    L = fp["layers"]
    assert max(big.get("gather_layer_f32", 0),
               big.get("gather_layer_int8", 0)) == fp["layer_bytes"]
    if LAYER_CASES[name][1]:
        assert _calls(st, "gather_layer_int8") == 2 * L * fp["data"]
        assert _calls(st, "gather_layer_f32") == 2 * L * (fp["travel"]
                                                          - fp["data"])
        assert _calls(st, "gather_layer_exp") == fp["data"]
    else:
        assert _calls(st, "gather_layer_f32") == 2 * L * fp["travel"]
    assert _calls(st, "grad_sum_layer") == L * fp["stacked"]


@pytest.mark.parametrize("leaf", ["stacked", "whole"])
def test_sliced_moment_noise_matches_one_device(world, leaf):
    for rank in world:
        got = rank["noise"][leaf]
        assert torch.equal(got["block"], got["one"])
    # the two ranks' blocks are different parts of one draw
    assert not torch.equal(world[0]["noise"][leaf]["block"],
                           world[1]["noise"][leaf]["block"])


def test_sliced_noise_differs_per_layer():
    """Each layer of a stacked moment draws from its own generator."""
    from repro_torch.core import dfx
    from repro_torch.train import optimizer as opt_lib
    u = dfx.uniform(opt_lib.moment_noise(1, 0, 3, "m", "cpu", (2, 4, 4),
                                         True), (2, 4, 4), "cpu")
    assert not torch.equal(u[0], u[1])
    one = opt_lib.moment_generator(1, 0, 3, "m", "cpu", layer=1)
    assert torch.equal(u[1], torch.rand((4, 4), generator=one))
