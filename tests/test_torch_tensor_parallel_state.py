"""Tensor-parallel compute for the SSM, hybrid and encoder-decoder stacks
(``sharding.tensor_parallel`` for mamba2-370m, zamba2-2.7b and
whisper-large-v3; ``models/ssm.py``'s split Mamba2 layer, zamba2's shared
block, ``models/encdec.py``'s split layers, cross K/V and vocabulary) on
gloo worlds of CPU processes (``torch_dist_worker.spawn_group``): one
world of 2 ranks, a (1, 2) mesh, and one of 4, a (1, 4) and a (2, 2) mesh
(the reduced whisper's and zamba2's 4 query heads over 2 kv heads take
the kv replication on (1, 4)).  The reference's FP32 steps of the three
reduced archs run once, in one subprocess.

Stated tolerances:

* The FP32 step on (1, 2) and (1, 4) of each of the three, from the
  reference's weights and batch, against the reference's one-device
  step: the loss within 1e-4, every parameter within 2e-5
  (``test_torch_tensor_parallel.py``'s bounds), but where the
  reference's clipped gradient is below 99 times AdamW's eps (read from
  its first step, which moves a parameter by ``lr · (g / (|g| + eps) + wd
  · p)``): there f32 round-off of a near-cancelled gradient sum moves the
  step by up to ``lr``, so such elements are held within lr (measured:
  one element of zamba2's ``shared_attn/mlp/wg``, gradient 4.0e-8 against
  a median of 1.4e-3, 2.5e-5 off when split and 1.35e-5 off on the port's
  one device).
* whisper's int8 round-to-nearest gradients (``stochastic_grad=False``)
  on (1, 2) against the port's one-device step from one seeded init:
  every per-tensor exponent equal, in order; the loss and each
  integer-product gradient leaf bit for bit; a leaf summed in f32 over
  rows (the norms' gains and biases, the MLP's biases) within 1e-6 of its
  largest magnitude (measured: bit for bit too).
* mamba2's and zamba2's on (1, 2) and (2, 2): every exponent equal, in
  order; the loss within 1e-5 relative (measured: equal on (1, 2), 7.6e-8
  on (2, 2)); every gradient leaf within 1e-3 of its largest magnitude;
  each integer-product leaf (the projections, the convs, the embedding,
  the shared block's) bit for bit; the f32-summed ones (``A_log``,
  ``dt_bias``, ``D_skip``, ``norm_g``, the norms' gains) within 1e-6 of
  their largest magnitude (measured at most 2.8e-7: the sum order of a
  reduction over the rank's heads' rows, or of the batch halves).
* ``sharding.STATS``: the gated norm's all-gathers (``tp_norm``: the
  forward's, the recompute's, the backward's of its output gradient, 3 a
  layer), the per-head leaves' gradient gather (``tp_heads``, one a
  layer), the one SUM a step of the cross K/V's input gradient (whisper's
  ``tp_dx``: 2 a layer in the encoder, 3 in the decoder, the head's and
  one of the encoder output's B·T·D, not one a decoder layer).
* A tensor whose part on one rank is all zero takes the other parts'
  exponent under a mesh (the all-zero part takes no part in the MAX).

The steps here hold the layout without sequence sharding: their worker
cases set ``sharding.SEQUENCE_SHARDING`` False
(``torch_dist_worker._no_sequence_sharding``);
``test_torch_sequence_parallel.py`` holds the sharded step against them.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import sharding  # noqa: E402
from repro_torch.configs import bert_base, registry, vit_base  # noqa: E402
from torch_dist_worker import spawn_group  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARCHS = ("mamba2-370m", "zamba2-2.7b", "whisper-large-v3")
SSM_ARCHS = ARCHS[:2]
#: the batch: 4 rows of 32 tokens (a multiple of the reduced SSM's chunk),
#: whisper's encoder over 48 frames, so its B·T·D sums stand apart
ROWS, SEQ, FRAMES = 4, 32, 48

_REFERENCE = r'''
import sys
import jax, jax.numpy as jnp, numpy as np
from repro import sharding
from repro.configs import registry
from repro.core.qconfig import QuantConfig
from repro.models import encdec, lm
from repro.train import optimizer as opt_lib, trainer
out = {}
for arch in sys.argv[2:]:
    cfg = registry.get_config(arch).reduced()
    key = jax.random.PRNGKey(0)
    init_fn, loss_fn = ((encdec.encdec_init, encdec.encdec_loss)
                        if cfg.enc_dec else (lm.lm_init, lm.lm_loss))
    init = jax.tree.map(np.asarray, init_fn(key, cfg))
    for p, l in jax.tree_util.tree_flatten_with_path(init)[0]:
        out[f"{arch}/init/" + sharding._path_str(p)] = l
    batch = {k: np.asarray(jax.random.randint(key, (%d, %d), 0, cfg.vocab))
             for k in ("tokens", "labels")}
    if cfg.enc_dec:
        batch["frames"] = np.random.default_rng(0).standard_normal(
            (%d, %d, cfg.d_model)).astype(np.float32)
    for k, v in batch.items():
        out[f"{arch}/{k}"] = v
    step = trainer.make_train_step(loss_fn, cfg, QuantConfig.fp32(),
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
''' % (ROWS, SEQ, ROWS, FRAMES)


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


def _fp32_inputs(ref, mesh):
    inp = {k: v for k, v in ref.items()
           if k.split("/")[1] in ("init", "tokens", "labels", "frames")}
    return dict(inp, mesh=np.array(mesh), archs=np.array(ARCHS))


def _int8_inputs(runs):
    """The int8 cases' batches (seeded tokens; whisper's frames) and runs
    (``"<D>x<M>:<arch>"``)."""
    rng = np.random.default_rng(0)
    inp = {"runs": np.array(runs)}
    for arch in ARCHS:
        cfg = registry.get_config(arch).reduced()
        t = rng.integers(0, cfg.vocab, (ROWS, SEQ + 1))
        inp[f"{arch}/tokens"], inp[f"{arch}/labels"] = t[:, :-1], t[:, 1:]
        if cfg.enc_dec:
            inp[f"{arch}/frames"] = rng.standard_normal(
                (ROWS, FRAMES, cfg.d_model)).astype(np.float32)
    return inp


@pytest.fixture(scope="module")
def world2(ref, tmp_path_factory):
    """The (1, 2) cases on one world of 2: the FP32 steps, the int8
    gradients of the three archs, an all-zero part's exponent."""
    return spawn_group({"tp_state_fp32": _fp32_inputs(ref, (1, 2)),
                        "tp_state_int8": _int8_inputs(
                            [f"1x2:{a}" for a in ARCHS]),
                        "zero_part_exponent": {"world": np.int64(2)}},
                       2, str(tmp_path_factory.mktemp("tps2")))


@pytest.fixture(scope="module")
def world4(ref, tmp_path_factory):
    """The (1, 4) FP32 steps and the (2, 2) int8 gradients of the Mamba2
    stacks on one world of 4."""
    return spawn_group({"tp_state_fp32": _fp32_inputs(ref, (1, 4)),
                        "tp_state_int8": _int8_inputs(
                            [f"2x2:{a}" for a in SSM_ARCHS])},
                       4, str(tmp_path_factory.mktemp("tps4")))


# =========================================================================
# The plan
# =========================================================================

@pytest.mark.parametrize("arch", ARCHS)
def test_plan_splits_at_model_4(arch):
    mesh = sharding.Mesh((4, 4), ("data", "model"))
    tp = sharding.tensor_parallel(registry.get_config(arch), mesh)
    assert tp.size == 4 and tp.kv_split
    for path in ("blocks/mamba/wz", "blocks/mamba/out_proj",
                 "blocks/mamba/conv_x", "dec_blocks/xattn/wk", "embed"):
        assert tp.keep(path) == ("model",), path
    # the gated norm's gain is gathered whole: its norm spans the row
    assert tp.keep("blocks/mamba/norm_g") == ()
    assert tp.whole_tag("blocks/mamba/norm_g") == "gather_layer_norm"


@pytest.mark.parametrize("arch,model,dim", [
    ("whisper-large-v3", 8, "n_heads"), ("mamba2-370m", 64, "ssm_nheads"),
    ("zamba2-2.7b", 3, "the padded vocabulary"),
    ("mamba2-370m", 3, "the padded vocabulary")])
def test_plan_refuses_an_uneven_split_of_the_other_stacks(arch, model, dim):
    # whisper's 20 heads over 8 ranks; mamba2's 32 SSD heads over 64
    mesh = sharding.Mesh((2, model), ("data", "model"))
    with pytest.raises(ValueError, match=dim):
        sharding.tensor_parallel(registry.get_config(arch), mesh)


@pytest.mark.parametrize("cfg", [bert_base.CONFIG, vit_base.CONFIG],
                         ids=["bert", "vit"])
def test_plan_leaves_fine_tuning_replicated(cfg):
    mesh = sharding.Mesh((4, 2), ("data", "model"))
    assert sharding.tensor_parallel(cfg, mesh) is None


# =========================================================================
# Whole steps
# =========================================================================

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", ["world2", "world4"])
def test_fp32_split_step_matches_reference(ref, arch, world, request):
    outs = request.getfixturevalue(world)
    o = outs[0]["tp_state_fp32"][arch]
    assert abs(o["loss"] - float(ref[f"{arch}/loss_one"])) < 1e-4
    want = {k[len(arch) + 5:]: v for k, v in ref.items()
            if k.startswith(f"{arch}/one/")}
    assert sorted(want) == sorted(o["params"])
    for k, w in want.items():
        got = o["params"][k].numpy()
        # AdamW's first step moves an element by lr · (g / (|g| + eps) + wd
        # · p): where the reference's g / (|g| + eps) is below 0.99 (|g| <
        # 99 eps, a near-cancelled f32 sum) round-off moves it by up to lr,
        # on one device too
        p0 = ref[f"{arch}/init/{k}"].astype(np.float64)
        adam = (p0 - w) / _LR - _WD * p0
        tiny = np.abs(adam) < 0.99
        np.testing.assert_allclose(got[~tiny], w[~tiny], atol=2e-5,
                                   err_msg=k)
        np.testing.assert_allclose(got[tiny], w[tiny], atol=_LR, err_msg=k)
    for other in outs[1:]:
        assert other["tp_state_fp32"][arch]["loss"] == o["loss"]
    # the products were split
    st = o["stats"]
    assert st[("tp_dx", "calls")] > 0 and st[("tp_out", "calls")] > 0


#: the FP32 step's AdamW learning rate and weight decay (the reference's)
_LR, _WD = 1e-3, 0.01

#: the gradient leaves that are sums in f32 over rows (no integer product)
_F32_SUMMED = ("/g", "/b", "/b1", "/b2", "/A_log", "/dt_bias", "/D_skip",
               "/norm_g")


def _int8(outs, mesh, arch):
    o = outs[0]["tp_state_int8"][mesh][arch]
    for other in outs[1:]:
        assert other["tp_state_int8"][mesh][arch]["mesh"]["exps"] == \
            o["mesh"]["exps"]
    return o["mesh"], o["one"]


def test_whisper_int8_split_step_bit_for_bit(world2):
    got, one = _int8(world2, "1x2", "whisper-large-v3")
    assert got["exps"] == one["exps"] and len(one["exps"]) > 200
    assert got["loss"] == one["loss"]
    assert sorted(got["grads"]) == sorted(one["grads"])
    for k, want in one["grads"].items():
        g = got["grads"][k]
        if k.endswith(_F32_SUMMED):
            tol = 1e-6 * float(want.abs().max())
            assert float((g - want).abs().max()) <= tol, k
        else:
            assert torch.equal(g, want), k


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("mesh,world", [("1x2", "world2"),
                                        ("2x2", "world4")])
def test_mamba_int8_split_step_matches_one_device(arch, mesh, world,
                                                  request):
    got, one = _int8(request.getfixturevalue(world), mesh, arch)
    assert got["exps"] == one["exps"] and len(one["exps"]) > 80
    np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-5)
    assert sorted(got["grads"]) == sorted(one["grads"])
    for k, want in one["grads"].items():
        g = got["grads"][k]
        top = float(want.abs().max())
        assert float((g - want).abs().max()) <= 1e-3 * top, k
        if k.endswith(_F32_SUMMED):
            assert float((g - want).abs().max()) <= 1e-6 * top, k
        else:
            assert torch.equal(g, want), k


# =========================================================================
# The model axis's collectives by tag
# =========================================================================

@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_mamba_collectives_by_tag(world2, arch):
    cfg = registry.get_config(arch).reduced()
    st = world2[0]["tp_state_int8"]["1x2"][arch]["mesh"]["stats"]
    L, DI, NH = cfg.n_layers, cfg.d_inner, cfg.ssm_nheads
    # the gated norm's input gathered in the forward and its recompute, its
    # output gradient in the backward: (B, S, DI) f32 each
    assert st[("tp_norm", "calls")] == 3 * L
    assert st[("tp_norm", "bytes")] == 3 * L * ROWS * SEQ * DI * 4
    # the per-head leaves' gradient: one gather of (2, 3, NH / 2) a layer
    assert st[("tp_heads", "calls")] == L
    assert st[("tp_heads", "bytes")] == L * 3 * NH * 4
    # the norm's gain gathered whole over the model group, a layer
    assert st[("gather_layer_norm_f32", "calls")] == 2 * L
    assert st[("exponent_model", "calls")] > 0


def test_whisper_sums_the_cross_kv_input_gradient_once(world2):
    cfg = registry.get_config("whisper-large-v3").reduced()
    st = world2[0]["tp_state_int8"]["1x2"]["whisper-large-v3"]["mesh"][
        "stats"]
    Le, Ld, D = cfg.n_enc_layers, cfg.n_layers, cfg.d_model
    # encoder layers: q / k / v and the MLP; decoder layers: self q / k /
    # v, cross q, the MLP; the head; and one SUM of the encoder output's
    # dX (B·T·D), not one a decoder layer
    assert st[("tp_dx", "calls")] == 2 * Le + 3 * Ld + 2
    assert st[("tp_dx", "bytes")] == 4 * ROWS * D * (
        FRAMES * (2 * Le + 1) + SEQ * (3 * Ld + 1))
    assert st[("tp_ce", "calls")] == 2


def test_an_all_zero_part_leaves_the_exponent_to_the_others(world2):
    # frexp(3e-6) = 2^-18; the zero part (rank 1's) does not outrank it
    for out in world2:
        got = out["zero_part_exponent"]
        assert got == {"one": -18, "stack": [-18, -18, -18]}
