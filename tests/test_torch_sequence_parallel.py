"""Sequence parallelism over the ``model`` axis (``sharding.
SEQUENCE_SHARDING``, the reference's default layout): the residual stream
between the split products is the rank's rows ``(B, S / M, D)``
(``core/int_ops.py``'s ``gather_from_sequence`` /
``reduce_scatter_to_sequence``; the norms, the row-parallel
``int_linear`` and the vocab-parallel embedding with ``seq``), on gloo
worlds of CPU processes (``torch_dist_worker.spawn_group``): one world of
2 ranks, a (1, 2) mesh, and one of 4, a (2, 2) and a (1, 4) mesh (the
reduced qwen's 4 query heads over 2 kv heads take the kv replication
there).  In one world each step runs sequence-sharded and with the
constant set False, side by side, from one seeded init and batch.

Stated tolerances:

* Per op on (1, 2), int8 round to nearest: the all-gather and the
  reduce-scatter, forward and backward, exactly; the row-parallel
  ``int_linear`` reduce-scattered against the all-reduced one's rows: bit
  for bit (output, dX, dW), its bias gradient (an f32 sum over rows)
  within 1e-6 of its largest magnitude; ``int_rmsnorm`` /
  ``int_layernorm`` on the rank's rows against the whole rows: the input's
  mantissas and outputs and dX bit for bit, the exponent the whole
  tensor's (taken over batch and model), the gain's (and bias's) gradient
  within 1e-6 of its largest magnitude.
* The int8 step, sequence-sharded against not, of reduced qwen1.5-0.5b,
  mixtral-8x7b, mamba2-370m, zamba2-2.7b and whisper-large-v3 on (1, 2),
  and of qwen on (2, 2) and (1, 4): every exponent equal, in order; the
  loss and every gradient leaf of an integer product bit for bit on
  (1, 2), within 1e-6 relative elsewhere (measured: bit for bit there
  too); a leaf summed in f32 over rows (the norms' gains and biases, the
  MLP's row-parallel bias) within 1e-6 of its largest magnitude
  (measured at most 1.8e-7).  qwen on (1, 2) under stochastic rounding,
  forward and backward, from one seed: the same bounds (each rank draws
  the logical tensor's noise and uses its rows).
* A sequence the model axis does not divide (31 positions on 2 ranks)
  runs whole: no ``sp_*`` collective, and the step equals the unsharded
  one bit for bit.
* ``sharding.STATS`` of one attention stack (qwen), one Mamba2 stack and
  whisper, by count and bytes: the all-gathers (``sp_gather``: forward,
  remat's recompute, and their backward reduce-scatters), the
  reduce-scatters (``sp_scatter``: forward, recompute up to the layer's
  last saved tensor, their backward all-gathers), the leaves' partial
  gradient sums (``sp_leaf``), and no ``tp_out`` / ``tp_dx`` on the
  residual stream (mixtral keeps only the expert buffer's).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import sharding  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import dfx, int_ops  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from torch_dist_worker import FRAMES, spawn_group  # noqa: E402

#: the int8 round-to-nearest runs on (1, 2): every family that splits
RUNS2 = ("1x2:qwen1.5-0.5b", "1x2:mixtral-8x7b", "1x2:mamba2-370m",
         "1x2:zamba2-2.7b", "1x2:whisper-large-v3")
SR_RUN, ODD_RUN = "1x2:qwen1.5-0.5b:sr", "1x2:qwen1.5-0.5b:31"
RUNS4 = ("2x2:qwen1.5-0.5b", "1x4:qwen1.5-0.5b")
#: the batch of ``case_sp_step``: 4 rows of 32 positions
ROWS, SEQ = 4, 32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _op_inputs():
    """Seeded operands of the per-op case: x (4, 8, 64), a row-parallel
    weight (64, 96) and bias, each rank's whole-sequence gradient partial
    (2, 4, 8, 64), the upstream gradients of the linear (4, 8, 96) and of
    a norm (4, 8, 64), a gain and a bias."""
    rng = np.random.default_rng(11)

    def f32(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"x": f32(4, 8, 64), "w": f32(64, 96, scale=0.05),
            "b": f32(96, scale=0.1), "gfull": f32(2, 4, 8, 64, scale=1e-3),
            "gy": f32(4, 8, 96, scale=1e-3), "gnorm": f32(4, 8, 64,
                                                          scale=1e-3),
            "gamma": 1 + f32(64, scale=0.1), "beta": f32(64, scale=0.1)}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return spawn_group({"sp_ops": _op_inputs(),
                        "sp_step": {"runs": np.array(
                            RUNS2 + (SR_RUN, ODD_RUN))}},
                       2, str(tmp_path_factory.mktemp("sp2")))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn_group({"sp_step": {"runs": np.array(RUNS4)}}, 4,
                       str(tmp_path_factory.mktemp("sp4")))


def _rn():
    import dataclasses
    return dataclasses.replace(QuantConfig.int8(), stochastic_grad=False)


def _t():
    return {k: torch.from_numpy(v) for k, v in _op_inputs().items()}


def _rows(r, n=8):
    return slice(r * n // 2, (r + 1) * n // 2)


def _near(got, want, what):
    tol = 1e-6 * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol, what


# =========================================================================
# Per op on (1, 2)
# =========================================================================

def test_sequence_operators_forward_and_backward(world2):
    t = _t()
    for r in range(2):
        o = world2[r]["sp_ops"]
        # the gather: the whole sequence; its backward the sum of the
        # ranks' partials, the rank's rows
        assert torch.equal(o["gather"]["y"], t["x"])
        assert torch.equal(o["gather"]["dx"],
                           (t["gfull"][0] + t["gfull"][1])[:, _rows(r)])
        # the reduce-scatter: the rank's rows of the sum; its backward
        # the rows' gradients gathered whole
        assert torch.equal(o["scatter"]["y"],
                           (t["gfull"][0] + t["gfull"][1])[:, _rows(r)])
        assert torch.equal(o["scatter"]["dy"], t["gnorm"])
    st = world2[0]["sp_ops"]["stats"]
    whole = 4 * 8 * 64 * 4
    for tag in ("sp_gather", "sp_scatter"):
        assert st[(tag, "calls")] == 2, tag
        assert st[(tag, "bytes")] == 2 * whole, tag


def test_row_parallel_linear_reduce_scattered_bit_for_bit(world2):
    for r in range(2):
        o = world2[r]["sp_ops"]
        sp, whole = o["row_True"], o["row_False"]
        assert torch.equal(sp["y"], whole["y"][:, _rows(r)]), r
        assert torch.equal(sp["dx"], whole["dx"]), r
        assert torch.equal(sp["dw"], whole["dw"]), r
        _near(sp["db"], whole["db"], r)


@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_norm_on_the_rows_bit_for_bit(world2, norm):
    t = _t()
    # the exponent one device takes of the whole input
    whole_exp = int(dfx.scale_exponent(t["x"])) - (_rn().act_bits - 1)
    for r in range(2):
        o = world2[r]["sp_ops"]
        sp, whole = o[f"{norm}_True"], o[f"{norm}_False"]
        assert sp["exp"] == whole["exp"] == whole_exp, r
        assert torch.equal(sp["m"], whole["m"][:, _rows(r)]), r
        assert torch.equal(sp["y"], whole["y"][:, _rows(r)]), r
        assert torch.equal(sp["dx"], whole["dx"][:, _rows(r)]), r
        _near(sp["dg"], whole["dg"], (r, "gain"))
        if norm == "ln":
            _near(sp["db"], whole["db"], (r, "bias"))


def test_norm_rows_take_the_logical_noise():
    # without a model group the noise is the 2-D view's draw; with one the
    # rank's rows of the logical tensor's (the reference's draw order)
    class Group:
        size, index = 2, 1
    x = torch.zeros(3, 4, 5)
    key = torch.Generator().manual_seed(4)
    full = torch.rand((3 * 8, 5), generator=torch.Generator().manual_seed(4))
    prev, dfx.model = dfx.model, Group()
    try:
        got = int_ops._noise_2d(key, x, seq=True)
    finally:
        dfx.model = prev
    assert torch.equal(got.reshape(3, 4, 5),
                       full.reshape(3, 8, 5)[:, 4:])


# =========================================================================
# Whole steps, sequence-sharded against not
# =========================================================================

#: the gradient leaves that are sums in f32 over rows (no integer product)
_F32_SUMMED = ("/g", "/b", "/b2", "/bq", "/bk", "/bv", "/A_log",
               "/dt_bias", "/D_skip", "/norm_g")


def _held(outs, run):
    o = outs[0]["sp_step"][run]
    for other in outs[1:]:
        assert other["sp_step"][run]["sp"]["exps"] == o["sp"]["exps"]
        assert other["sp_step"][run]["sp"]["loss"] == o["sp"]["loss"]
    sp, no = o["sp"], o["no"]
    assert sp["exps"] == no["exps"] and len(no["exps"]) > 80
    exact = run.startswith("1x2")
    if exact:
        assert sp["loss"] == no["loss"]
    np.testing.assert_allclose(sp["loss"], no["loss"], rtol=1e-6)
    assert sorted(sp["grads"]) == sorted(no["grads"])
    for k, want in no["grads"].items():
        g = sp["grads"][k]
        if k.endswith(_F32_SUMMED):
            _near(g, want, k)
        elif exact:
            assert torch.equal(g, want), k
        else:
            _near(g, want, k)
    return sp, no


@pytest.mark.parametrize("run", RUNS2)
def test_int8_step_sharded_equals_whole(world2, run):
    sp, _ = _held(world2, run)
    assert sp["stats"][("sp_gather", "calls")] > 0


@pytest.mark.parametrize("run", RUNS4)
def test_int8_step_sharded_matches_whole(world4, run):
    sp, _ = _held(world4, run)
    assert sp["stats"][("sp_scatter", "calls")] > 0


def test_stochastic_rounding_sharded_equals_whole(world2):
    _held(world2, SR_RUN)


def test_an_odd_length_stays_whole(world2):
    o = world2[0]["sp_step"][ODD_RUN]
    sp, no = o["sp"], o["no"]
    assert not [k for k in sp["stats"] if k[0].startswith("sp_")]
    assert sp["stats"] == no["stats"]
    assert sp["loss"] == no["loss"] and sp["exps"] == no["exps"]
    for k, want in no["grads"].items():
        assert torch.equal(sp["grads"][k], want), k


def test_the_plan_shards_the_sequence_by_default():
    mesh = sharding.Mesh((8, 2), ("data", "model"))
    cfg = registry.get_config("qwen1.5-0.5b")
    assert sharding.SEQUENCE_SHARDING is True
    assert sharding.tensor_parallel(cfg, mesh).sequence
    prev = sharding.SEQUENCE_SHARDING
    sharding.SEQUENCE_SHARDING = False
    try:
        assert not sharding.tensor_parallel(cfg, mesh).sequence
    finally:
        sharding.SEQUENCE_SHARDING = prev


# =========================================================================
# The SP tags by count and bytes
# =========================================================================

def _calls(st, tag):
    return st.get((tag, "calls"), 0)


def test_attention_stack_tags(world2):
    cfg = registry.get_config("qwen1.5-0.5b").reduced()
    L, D = cfg.n_layers, cfg.d_model
    st = world2[0]["sp_step"]["1x2:qwen1.5-0.5b"]["sp"]["stats"]
    whole = ROWS * SEQ * D * 4
    # gathers: attention's and the MLP's a layer (forward, recompute,
    # backward) and the head's (forward, backward)
    assert _calls(st, "sp_gather") == 6 * L + 2
    # reduce-scatters: the embedding and o / down a layer (forward,
    # backward), o again in the recompute (it stops before down's)
    assert _calls(st, "sp_scatter") == 5 * L + 2
    for tag in ("sp_gather", "sp_scatter"):
        assert st[(tag, "bytes")] == _calls(st, tag) * whole, tag
    # the gains' partial gradients: ln1 / ln2 a layer, final_norm
    assert _calls(st, "sp_leaf") == 2 * L + 1
    assert st[("sp_leaf", "bytes")] == (2 * L + 1) * D * 4
    assert not _calls(st, "tp_out") and not _calls(st, "tp_dx")
    assert _calls(st, "tp_ce") == 2


def test_mixtral_keeps_the_expert_buffer_all_reduce(world2):
    cfg = registry.get_config("mixtral-8x7b").reduced()
    L = cfg.n_layers
    st = world2[0]["sp_step"]["1x2:mixtral-8x7b"]["sp"]["stats"]
    no = world2[0]["sp_step"]["1x2:mixtral-8x7b"]["no"]["stats"]
    # the expert buffer's all-reduce (forward, recompute) and the dX sum
    # of its column-parallel products, the same as without sharding
    assert _calls(st, "tp_out") == 2 * L
    assert _calls(st, "tp_dx") == L
    assert st[("tp_out", "bytes")] == 2 * st[("tp_dx", "bytes")]
    assert st[("tp_dx", "bytes")] < no[("tp_dx", "bytes")]
    # the rows taken after the combine: their gradient gathered a layer
    assert _calls(st, "sp_rows") == L


def test_mamba_stack_tags(world2):
    cfg = registry.get_config("mamba2-370m").reduced()
    L, D, DI = cfg.n_layers, cfg.d_model, cfg.d_inner
    st = world2[0]["sp_step"]["1x2:mamba2-370m"]["sp"]["stats"]
    no = world2[0]["sp_step"]["1x2:mamba2-370m"]["no"]["stats"]
    whole = ROWS * SEQ * D * 4
    # one gather a layer (forward, recompute, backward), the head's
    assert _calls(st, "sp_gather") == 3 * L + 2
    # out_proj's reduce-scatter (forward, backward; the recompute stops
    # before it) and the embedding's
    assert _calls(st, "sp_scatter") == 2 * L + 2
    for tag in ("sp_gather", "sp_scatter"):
        assert st[(tag, "bytes")] == _calls(st, tag) * whole, tag
    assert _calls(st, "sp_leaf") == 1                      # final_norm
    # the gated norm's gathers and B / C's dX sum stay as they were
    for tag in ("tp_norm", "tp_heads"):
        assert st[(tag, "bytes")] == no[(tag, "bytes")], tag
    assert st[("tp_norm", "bytes")] == 3 * L * ROWS * SEQ * DI * 4
    assert _calls(st, "tp_dx") == L
    assert not _calls(st, "tp_out")


def test_whisper_tags(world2):
    cfg = registry.get_config("whisper-large-v3").reduced()
    Le, Ld, D = cfg.n_enc_layers, cfg.n_layers, cfg.d_model
    st = world2[0]["sp_step"]["1x2:whisper-large-v3"]["sp"]["stats"]
    enc, dec = ROWS * FRAMES * D * 4, ROWS * SEQ * D * 4
    # gathers: 2 an encoder layer, 3 a decoder layer (self, cross q, MLP)
    # three times each; the encoder's output once (and its backward); the
    # head's
    assert _calls(st, "sp_gather") == 6 * Le + 9 * Ld + 4
    assert st[("sp_gather", "bytes")] == (6 * Le + 2) * enc + (
        9 * Ld + 2) * dec
    # reduce-scatters: o / w2 an encoder layer, self o / cross o / w2 a
    # decoder layer (forward, backward; the recompute stops before the
    # last), the embedding's
    assert _calls(st, "sp_scatter") == 5 * Le + 8 * Ld + 2
    assert st[("sp_scatter", "bytes")] == 5 * Le * enc + (8 * Ld + 2) * dec
    # gains, biases and b2: 5 an encoder layer, 7 a decoder layer, enc_ln
    # and final_norm
    assert _calls(st, "sp_leaf") == 5 * Le + 7 * Ld + 4
    assert not _calls(st, "tp_out") and not _calls(st, "tp_dx")


# =========================================================================
# The activation footprint at full size (tools/fsdp_footprint.py)
# =========================================================================

def _footprint_tool():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "fsdp_footprint.py")
    spec = importlib.util.spec_from_file_location("fsdp_footprint", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_footprint_mistral_large_layer_inputs():
    # 88 layer inputs of 8 x 256 x 12288 f32 (0.1007 GB each) a rank:
    # 8.86 GB whole, 0.55 GB over a model axis of 16
    tool = _footprint_tool()
    a = tool.activations(registry.get_config("mistral-large-123b"), 16)
    assert round(a["ckpt_whole"], 2) == 8.86
    assert round(a["ckpt_sp"], 2) == 0.55
    assert a["layer_sp"] * 16 == pytest.approx(a["layer_whole"])
    one = tool.activations(registry.get_config("mistral-large-123b"), 1)
    assert one["ckpt_sp"] == one["ckpt_whole"] == a["ckpt_whole"]


@pytest.mark.parametrize("arch,model,cut", [
    ("whisper-large-v3", 4, 4), ("zamba2-2.7b", 16, 16),
    ("llava-next-mistral-7b", 16, 16), ("whisper-large-v3", 16, None)])
def test_footprint_shards_each_stream_it_divides(arch, model, cut):
    tool = _footprint_tool()
    cfg = registry.get_config(arch)
    a = tool.activations(cfg, model)
    if cut:
        assert a["ckpt_sp"] * cut == pytest.approx(a["ckpt_whole"])
    else:
        # 1500 frames over 16 ranks: the encoder's stream stays whole, the
        # decoder's 256 tokens shard
        enc = cfg.n_enc_layers * tool.ROWS * tool.ENC_FRAMES * cfg.d_model
        dec = cfg.n_layers * tool.ROWS * tool.ROW_TOKENS * cfg.d_model
        assert a["ckpt_sp"] == pytest.approx(4 * (enc + dec / 16) / 1e9)
