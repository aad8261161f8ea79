"""The port's quantlint held against the reference's (``repro.analysis``):
the same findings and the same resolved alias paths on four lint cells,
the same kernel calls per call on the dispatch gate's entries (the
reference's ``effective`` counts), the QL004 gate over the port's own
baseline, and caveat G — the matmul bound both analyzers share, which
leaves the tied head's int32 wrap unflagged.

Each reference cell is traced once (module fixtures) and each port cell
recorded once, on the CPU.
"""
import collections
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.analysis import budget as ref_budget  # noqa: E402
from repro.analysis import lint as ref_lint  # noqa: E402
from repro.analysis import rules as ref_rules  # noqa: E402
from repro.core import int_ops as ref_int_ops  # noqa: E402
from repro.core import qpolicy as ref_qpolicy  # noqa: E402
from repro.core.qconfig import QuantConfig as RefQuantConfig  # noqa: E402
from repro.kernels import ops as ref_kops  # noqa: E402

from repro_torch.analysis import budget, dispatch, lint, rules, \
    walker  # noqa: E402
from repro_torch.kernels import bfp_matmul  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several files at once, and
    small ops on many threads oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CELLS = [("bert_base", "int8"), ("bert_base", "int8_embed16"),
         ("mamba2-370m", "int16"), ("qwen1.5-0.5b", "int8")]


class _Kept(ref_qpolicy.record_resolutions):
    """``record_resolutions`` that also keeps its records, so one
    ``lint_cell`` trace of the reference gives its findings and paths."""
    last: list = []

    def __enter__(self):
        _Kept.last = super().__enter__()
        return _Kept.last


@pytest.fixture(scope="module", params=CELLS, ids="-".join)
def cell(request):
    config, preset = request.param
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_qpolicy, "record_resolutions", _Kept)
        ref = ref_lint.lint_cell(config, preset)
    policy = ref_lint._pallas_policy(preset)
    ref_paths = sorted({p for pol, tup in _Kept.last if pol == policy
                        for p in tup})
    return ref, ref_paths, lint.lint_cell(config, preset, device="cpu")


def _multiset(findings):
    return collections.Counter((f["code"], f["rule"]) for f in findings)


def test_lint_cell_findings_equal_the_reference(cell):
    ref, _, port = cell
    assert _multiset(port["findings"]) == _multiset(ref["findings"])
    assert port["resolutions"] > 0 and port["launches"]["effective"] > 0


def test_lint_cell_resolves_the_reference_paths(cell):
    _, ref_paths, port = cell
    assert port["paths"] == ref_paths


def test_lint_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        lint.lint_cell("bert_base", "int8")
    with pytest.raises(RuntimeError, match="CUDA"):
        lint.main(["--config", "bert_base"])
    with pytest.raises(RuntimeError, match="CUDA"):
        dispatch.current_counts()


# =========================================================================
# QL004: the dispatch gate
# =========================================================================

@pytest.fixture(scope="module")
def current():
    return dispatch.current_counts("cpu")


def _ref_cfg(preset):
    return dataclasses.replace(RefQuantConfig.preset(preset),
                               backend="pallas", stochastic_grad=False)


def _ref_effective(fn, *args):
    return ref_rules.dispatch_counts(jax.make_jaxpr(fn)(*args))["effective"]


@pytest.mark.parametrize("preset", ["int8", "int16"])
def test_layer_dispatch_equals_the_reference(current, preset):
    """Linear fwd+bwd, attention fwd+bwd and decode: the port's kernel
    calls are the reference's effective ``pallas_call`` counts."""
    cfg = _ref_cfg(preset)
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (4, 8, 32))
    w = jax.random.normal(jax.random.fold_in(key, 1), (32, 16)) * 0.1
    qa = jax.random.normal(key, (2, 16, 2, 2, 32))
    ka = jax.random.normal(jax.random.fold_in(key, 3), (2, 16, 2, 32))
    va = jax.random.normal(jax.random.fold_in(key, 4), (2, 16, 2, 32))
    q1 = jax.random.normal(jax.random.fold_in(key, 5), (2, 1, 2, 2, 32))

    def lin_l(x, w):
        return jnp.sum(ref_int_ops.int_linear(x, w, None, None, cfg) ** 2)

    def att(q, k, v, off=0):
        return ref_int_ops.int_attention(q, k, v, jnp.asarray(off), None,
                                         cfg, cfg, True, None)

    ref = {
        "linear_fwd_bwd": _ref_effective(jax.grad(lin_l, argnums=(0, 1)),
                                         x, w),
        "attention_fwd_bwd": _ref_effective(jax.grad(
            lambda q, k, v: jnp.sum(att(q, k, v) ** 2), argnums=(0, 1, 2)),
            qa, ka, va),
        "attention_decode": _ref_effective(lambda q, k, v: att(q, k, v, 7),
                                           q1, ka, va),
    }
    assert {k: current[preset][k] for k in ref} == ref


def test_model_dispatch_equals_the_reference(current):
    """The serve path's prompt admission launches the reference's
    effective count, and so does the bert step, each encoder layer under
    per-layer remat on both sides (its recompute's calls included)."""
    from repro.configs import registry
    from repro.models import lm as ref_lm
    from repro.models import paper_models as pm

    key = jax.random.PRNGKey(0)
    cfg = registry.get_config("smollm-135m").reduced()
    params = ref_lm.lm_init(key, cfg)
    cache = ref_lm.init_cache(cfg, 2, 32, dtype=jnp.float32)
    tokens = jax.random.randint(key, (2, 8), 0, cfg.vocab)
    assert current["serve"]["lm_prefill_len8"] == _ref_effective(
        lambda p, t, c: ref_lm.lm_prefill_cache(p, t, c, cfg,
                                                _ref_cfg("int8")),
        params, tokens, cache)

    bcfg = pm.bert_config(n_layers=4, d_model=64, n_heads=4, d_ff=128,
                          vocab=128, name="bert-gate")
    bparams = pm.bert_init(key, bcfg, num_labels=4)
    batch = {"tokens": jax.random.randint(key, (2, 16), 0, bcfg.vocab),
             "labels": jnp.zeros((2,), jnp.int32)}
    policy = ref_qpolicy.QuantPolicy(base=_ref_cfg("int8"))
    assert current["policy"]["bert_step_int8"] == _ref_effective(
        jax.grad(lambda p: pm.bert_cls_loss(p, batch, bcfg, policy,
                                            None)[0]), bparams)


def test_dispatch_counts_at_or_below_baseline(current):
    with open(dispatch.BASELINE_PATH) as f:
        baseline = json.load(f)
    findings, _ = dispatch.compare(current, baseline)
    assert not findings, [str(f) for f in findings]


def test_baseline_pins_single_dispatch_property():
    """Per preset 3 / 6 launches for the linears, 4 / 7 for attention
    (decode the forward's program), and every bert policy the uniform
    int8 step's count."""
    with open(dispatch.BASELINE_PATH) as f:
        baseline = json.load(f)
    assert set(baseline) == {"int8", "int12", "int16", "policy", "serve"}
    for preset in ("int8", "int12", "int16"):
        e = baseline[preset]
        assert (e["linear_fwd"], e["linear_fwd_bwd"]) == (3, 6)
        assert (e["batched_linear_fwd"], e["batched_linear_fwd_bwd"]) == \
            (3, 6)
        assert (e["attention_fwd"], e["attention_fwd_bwd"]) == (4, 7)
        assert e["attention_decode"] == e["attention_fwd"]
    assert len(set(baseline["policy"].values())) == 1


def test_ql004_flags_regression_and_unpinned():
    """A count above baseline and an unpinned entry are findings; a count
    below baseline is an improvement."""
    baseline = {"int8": {"linear_fwd": 3}, "policy": {"step": 20}}
    current = {"int8": {"linear_fwd": 4, "new_layer": 7},
               "policy": {"step": 19}}
    findings, improvements = dispatch.compare(current, baseline)
    msgs = [str(f) for f in findings]
    assert any("int8.linear_fwd" in m and "effective" in m for m in msgs)
    assert any("UNPINNED" in m and "new_layer" in m for m in msgs), msgs
    assert ("policy.step.effective", 20, 19) in improvements
    assert all(f.code == "QL004" for f in findings)


# =========================================================================
# Caveat G: the shared matmul bound
# =========================================================================

def test_caveat_g_tied_head_wrap_is_unflagged_by_both():
    """QL006 bounds a limb matmul by 64² · K.  qwen's tied-head dX
    contracts K = 152,064: 64² · K = 6.2e8 < 2^31, so neither analyzer
    flags it, while one 8-bit plane reaches |m| = 127 and the true worst
    case 127² · K = 2.45e9 wraps int32 —
    ``test_torch_cuda_kernels.py::test_bfp_matmul_int32_wraps`` shows the
    wrap on the card."""
    M, N, K = 8, 16, 152_064
    assert 64 * 64 * K < 2**31 - 1 < 127 * 127 * K
    # the port: the NT product's kernel event on meta tensors
    g = torch.empty((1, M, K), dtype=torch.int8, device="meta")
    w = torch.empty((1, N, K), dtype=torch.int8, device="meta")
    e = torch.zeros((), dtype=torch.int32, device="meta")
    _, tr = walker.record(bfp_matmul.bfp_matmul_nt, g, w, e)
    (k,) = list(tr.kernels())
    assert k.static["K"] == K
    assert not budget.check_kernel_site(k)
    assert not rules.check_accum_budget(tr)
    # the reference: the pallas_call of the same product, traced
    jx = jax.make_jaxpr(lambda g, w: ref_kops.dfx_matmul_tiled_nt(
        g, jnp.int32(0), 8, w, jnp.int32(0), 8))(
        jax.ShapeDtypeStruct((1, M, K), jnp.int8),
        jax.ShapeDtypeStruct((1, N, K), jnp.int8))
    assert not ref_budget.check_jaxpr(jx)
    # a bound past 2^31 is flagged by both
    k.static["K"] = 600_000
    assert budget.check_kernel_site(k)
