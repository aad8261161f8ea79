"""quantlint on the port: every rule flags its seeded defect on a small
torch program and is silent on the clean form — the counterparts of
``tests/test_quantlint.py``'s unit tests, over recorded traces
(``repro_torch.analysis``) — plus the recorder itself: a CPU step's
kernel events against the meta step's calls, ``where``, the kernel
boundary, and QL007 on the sequence-sharded qwen step's ``sp_gather``.
"""
import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

from repro_torch import sharding  # noqa: E402
from repro_torch.analysis import budget, count_kernels, count_ops, \
    rules, walker  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import dfx, int_ops, qpolicy, qtensor  # noqa: E402
from repro_torch.core.qconfig import QuantConfig  # noqa: E402
from repro_torch.core.qpolicy import QuantPolicy, ScopeRule  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import lm  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several files at once, and
    small ops on many threads oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _codes(findings):
    return sorted({f.code for f in findings})


def _trace(fn, *args):
    return walker.record(fn, *args)[1]


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _randn(*shape, seed=0):
    return torch.randn(shape, generator=_gen(seed))


# =========================================================================
# walker
# =========================================================================

def test_walker_records_backward_and_recompute():
    """The reference walks every sub-jaxpr (cond branches, remat bodies);
    the recorder sees every op the step runs: the forward, the backward
    the autograd engine runs and a checkpoint's recompute."""
    x = _randn(4).requires_grad_(True)

    def f():
        y = torch.utils.checkpoint.checkpoint(
            lambda v: torch.log1p(torch.exp(v)), x, use_reentrant=False)
        y.sum().backward()
    tr = _trace(f)
    assert count_ops(tr, "exp") == 2                  # forward + recompute
    assert count_ops(tr, "log1p") == 1                # the recompute stops
    assert count_ops(tr, "mul") >= 1                  # the backward's


def test_walker_counts_every_loop_trip():
    """A Python loop records each trip: the counts are the reference's
    scan-``effective`` counts (7 trips, 7 ops; 3 quantizes, 3 kernels)."""
    def f(x):
        for _ in range(7):
            x = torch.sin(x)
        for _ in range(3):
            dfx.quantize(x, 8)
        return x
    tr = _trace(f, torch.ones(4, 8))
    assert count_ops(tr, "sin") == 7
    assert count_kernels(tr) == 3
    assert walker.kernel_counts(tr) == {"dfx_quantize": 3}


def test_walker_records_the_branch_taken():
    """Only the branch a step runs is recorded: the reference's effective
    ``cond`` count (the max over branches, not the sum)."""
    def f(x):
        if x.sum() > 0:
            return torch.sin(torch.sin(x))
        return torch.sin(x)
    assert count_ops(_trace(f, torch.ones(4)), "sin") == 2
    assert count_ops(_trace(f, -torch.ones(4)), "sin") == 1


def test_walker_kernel_boundary_flag():
    """A wrapper's plain version runs inside its kernel call: the
    products are inside, the host side holds none."""
    cfg = dataclasses.replace(QuantConfig.int8(), stochastic_grad=False)
    tr = _trace(lambda x: int_ops.int_linear(x, torch.ones(32, 16), None,
                                             None, cfg), torch.ones(4, 32))
    inside = [s for s in walker.iter_ops(tr) if s.inside_kernel]
    outside = [s for s in walker.iter_ops(tr) if not s.inside_kernel]
    assert inside and outside
    assert any(s.prim in rules._DOTS for s in inside)
    assert not any(s.prim in rules._DOTS for s in outside)
    assert all(s.path == ("bfp_matmul",) for s in inside
               if s.prim in rules._DOTS)


# =========================================================================
# QL001 — integer closure
# =========================================================================

def test_ql001_flags_rsqrt_outside_a_kernel():
    """Norm statistics recomputed on the host side from the dequantized
    activations."""
    def broken(x):
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + 1e-6)
    f = rules.check_integer_closure(_trace(broken, torch.ones(4, 8)))
    assert _codes(f) == ["QL001"]
    assert any("rsqrt" in x.message for x in f)


def test_ql001_flags_limb_split_chain_on_mantissas():
    """Integer remainder / floor division on quantized mantissas outside
    the fused quantize kernel."""
    def broken(x):
        m = torch.clamp(torch.round(x * 127.0), -127, 127).to(torch.int32)
        lo = torch.remainder(m, 16)
        hi = torch.div(m, 16, rounding_mode="floor")
        return (lo + hi * 16).to(torch.float32)
    f = rules.check_integer_closure(_trace(broken, torch.ones(8)))
    assert _codes(f) == ["QL001"]
    assert len(f) == 2                                      # rem AND div


def test_ql001_exempts_arange_index_arithmetic():
    """The MoE routing idiom ``arange(T*K) // K`` is index bookkeeping,
    not mantissa arithmetic."""
    def routing(x):
        tok = torch.div(torch.arange(32, dtype=torch.int32), 4,
                        rounding_mode="floor")
        return x + tok.to(torch.float32)
    assert not rules.check_integer_closure(_trace(routing, torch.ones(32)))


def test_ql001_flags_integer_product_and_its_softmax():
    """An integer product outside a kernel — the sim route's signature —
    and the exp of the scores it made."""
    qa = dfx.quantize(_randn(8, 16), 8)
    qb = dfx.quantize(_randn(16, 4, seed=1), 8)

    def sim(x):
        m = dfx.quantize(x, 8).m
        s = m.to(torch.float32) @ qb.m.to(torch.float32)
        return torch.exp(s - s.amax(-1, keepdim=True)) * dfx.pow2(qa.exp)
    f = rules.check_integer_closure(_trace(sim, _randn(8, 16)))
    assert _codes(f) == ["QL001"]
    assert any("dot_general" in x.message for x in f)
    assert any("exp on attention scores" in x.message for x in f)


def test_ql001_walks_qtensor_ops_clean():
    """The state plane's container ops — quantize (grouped, stochastic),
    dequantize, the SR-EMA moment update, the straight-through fake quant
    — leave QL001 and the whole graph battery silent."""
    def state_ops(x):
        t = qtensor.quantize(x, 16, group_axis=0)
        t = qtensor.ema_update(t, x * 0.5, 0.9, _gen(3))
        return qtensor.dequantize(t) + qtensor.fake_quant_ste(x, 8)
    tr = _trace(state_ops, _randn(4, 8))
    assert count_kernels(tr) >= 3
    assert not rules.check_integer_closure(tr)
    assert not rules.run_rules(tr)


# =========================================================================
# QL002 — PRNG key discipline
# =========================================================================

def _sr_quantize(x, gen):
    return dfx.quantize(x, 8, u=dfx.uniform(gen, x.shape, x.device))


def test_ql002_flags_a_cloned_generator():
    """Two stochastic roundings from one generator state: a copy of the
    generator draws the first one's noise again."""
    def broken(x):
        g = _gen(7)
        clone = torch.Generator()
        clone.set_state(g.get_state())
        a = _sr_quantize(x, g)
        b = _sr_quantize(x * 2, clone)
        return dfx.dequantize(a) + dfx.dequantize(b)
    f = rules.check_key_discipline(_trace(broken, torch.ones(8, 4)))
    assert _codes(f) == ["QL002"]
    assert "2 stochastic draws" in f[0].message


def test_ql002_flags_a_generator_seeded_anew_per_layer():
    """A key threaded unchanged through the layer loop: every layer
    re-seeds its generator, so every layer draws the same noise."""
    def broken(x):
        for _ in range(4):
            x = dfx.dequantize(_sr_quantize(x, _gen(0)))
        return x
    f = rules.check_key_discipline(_trace(broken, torch.ones(8, 4)))
    assert _codes(f) == ["QL002"]
    assert "4 stochastic draws" in f[0].message


def test_ql002_accepts_one_stream_and_a_remat_replay():
    """Draws in turn from one generator are fresh, and a recompute's
    replay (``lm._replay_key``) of a forward draw is that draw."""
    def clean(x):
        g = _gen(0)
        state = g.get_state()
        a = _sr_quantize(x, g)
        for _ in range(3):
            x = dfx.dequantize(_sr_quantize(x, g))
        again = _sr_quantize(x, lm._replay_key(g, state))
        return dfx.dequantize(a) + x + dfx.dequantize(again)
    tr = _trace(clean, torch.ones(8, 4))
    draws = list(tr.draws())
    assert len(draws) == 5
    assert draws[-1].replay_of == draws[0].index
    assert not rules.check_key_discipline(tr)


# =========================================================================
# QL003 / QL005 — policy hygiene and stability
# =========================================================================

def _resolved_paths(policy, paths):
    with qpolicy.record_resolutions() as recs:
        for p in paths:
            policy.resolve(p)
    return [t for pol, t in recs if pol == policy]


def test_ql003_flags_dead_rule():
    policy = QuantPolicy(base=QuantConfig.int8(), rules=(
        ScopeRule("*embed*", (("weight_bits", 16),)),
        ScopeRule("tower.*", (("weight_bits", 16),)),      # matches nothing
    ))
    paths = _resolved_paths(policy, ["embed", "blocks.0.attn.wq", "head"])
    f = rules.check_policy_hygiene(policy, paths)
    assert _codes(f) == ["QL003"]
    assert any("dead rule" in x.message and "tower.*" in x.where for x in f)


def test_ql003_flags_shadowed_rule():
    policy = QuantPolicy(base=QuantConfig.int8(), rules=(
        ScopeRule("embed*", (("weight_bits", 12),)),       # shadowed below
        ScopeRule("embed", (("weight_bits", 16),)),
    ))
    paths = _resolved_paths(policy, ["embed", "blocks.0.attn.wq"])
    f = rules.check_policy_hygiene(policy, paths)
    assert any("shadowed rule" in x.message and x.where == "embed*"
               for x in f), f


def test_ql003_flags_unscoped_call_site():
    policy = QuantPolicy(base=QuantConfig.int8(), rules=(
        ScopeRule("*embed*", (("weight_bits", 16),)),))
    paths = _resolved_paths(policy, ["embed", ""])        # "" = root
    f = rules.check_policy_hygiene(policy, paths)
    assert any("root path" in x.message for x in f), f


def test_ql003_clean_policy_is_silent():
    policy = QuantPolicy(base=QuantConfig.int8(),
                         rules=qpolicy.preset_rules("int8_embed16"))
    paths = _resolved_paths(policy, ["embed", "head", "blocks.0.attn.wq"])
    assert not rules.check_policy_hygiene(policy, paths)


def test_ql005_flags_divergence_regime_scope():
    """A w8·a8 leaf: the paper's Fig. 4 regime."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        policy = QuantPolicy(base=QuantConfig.int8(), rules=(
            ScopeRule("blocks.*", (("act_bits", 8),)),))
        paths = _resolved_paths(policy, ["blocks.0.attn.wq", "embed"])
        f = rules.check_stability(policy, paths)
    assert _codes(f) == ["QL005"]
    assert any("divergence regime" in x.message for x in f)


# =========================================================================
# QL006 — accumulator budget
# =========================================================================

def test_ql006_direct_form_reproduces_the_int16_hole():
    """Direct int16 ``Σx²`` at D=768 needs ~40 bits against int32's 31."""
    site = budget.check_sum_site(16, 768, squared=True)
    assert site is not None and site.bits_needed > 31
    assert budget.check_sum_site(8, 768, squared=True) is None
    assert budget.sum_bits_needed(8, 768, squared=True) <= 31


def test_ql006_flags_overbudget_int16_reduction():
    """Quantize to an int16 mantissa, square and reduce over D=768: past
    2^24 in an f32 sum, and past 2^31 in an int32 one."""
    def m16(x):
        return torch.clamp(torch.round(x * 32767.0), -32767.0,
                           32767.0).to(torch.int16)

    def in_f32(x):
        mf = m16(x).to(torch.float32)
        return torch.sum(mf * mf, dim=-1)

    def in_int32(x):
        mi = m16(x).to(torch.int32)
        return torch.sum(mi * mi, dim=-1, dtype=torch.int32)
    f = rules.check_accum_budget(_trace(in_f32, torch.ones(4, 768)))
    assert _codes(f) == ["QL006"]
    assert any("float32" in x.message for x in f)
    f = rules.check_accum_budget(_trace(in_int32, torch.ones(4, 768)))
    assert _codes(f) == ["QL006"]
    assert any("int32" in x.message for x in f)


def test_ql006_int32_accumulator_is_clean_at_int8():
    def fixed(x):
        m = torch.clamp(torch.round(x * 127.0), -127.0, 127.0) \
            .to(torch.int32)
        return torch.sum(m * m, dim=-1, dtype=torch.int32)   # 24 bits < 31
    assert not rules.check_accum_budget(_trace(fixed, torch.ones(4, 768)))


def test_ql006_conv_bwd_digit_split_is_clean():
    """The depthwise conv's dw reduction at 16-bit gradients accumulates
    digit-split int32 partials, never an f32 rounding sum."""
    cfg = dataclasses.replace(QuantConfig.int16(), stochastic_grad=False)
    x = _randn(2, 32, 16)
    w = (_randn(4, 16, seed=1) * 0.1).requires_grad_(True)
    tr = _trace(lambda: (int_ops.int_conv1d_depthwise(x, w, None, cfg)
                         ** 2).sum().backward())
    assert count_kernels(tr) >= 3
    assert not rules.check_accum_budget(tr)


# =========================================================================
# QL007 — wire format
# =========================================================================

_DATA2 = sharding.dry_mesh((2,), ("data",))


def _meta(*shape):
    return torch.empty(shape, device="meta")


def test_ql007_flags_quantize_after_f32_gather():
    """Gather full-width bytes, then quantize the gathered copy (a
    float->int convert outside a kernel)."""
    def broken(x):
        g = sharding.all_gather(x, "data", _DATA2)         # f32 on the wire
        m = torch.clamp(torch.round(g * 127), -127, 127).to(torch.int8)
        return m.to(torch.float32) / 127.0
    f = rules.check_wire_format(_trace(broken, _meta(8)))
    assert _codes(f) == ["QL007"]
    assert any("all_gather" in x.message for x in f)


def test_ql007_flags_f32_gather_of_elsewhere_quantized_tensor():
    """An f32 gather of a tensor the quantize kernel takes elsewhere."""
    def broken(x):
        q = dfx.quantize(x, 8)
        g = sharding.all_gather(x, "data", _DATA2)
        return g.sum() + dfx.dequantize(q).sum()
    tr = _trace(broken, _meta(8, 4))
    assert walker.kernel_counts(tr) == {"dfx_quantize": 1}
    assert _codes(rules.check_wire_format(tr)) == ["QL007"]


def test_ql007_quantized_gather_is_clean():
    """The shipped shape (``sharding.quantized_all_gather``): the
    collectives move int8 planes and the per-shard exponent."""
    params = {"w": _meta(4, 8)}
    tr = _trace(lambda p: sharding.quantized_all_gather(
        p, _DATA2, bits=8, pspecs={"w": ("data", None)}), params)
    kinds = {(c.kind, c.src.dtype) for c in tr.collectives()}
    assert ("all-gather", torch.int8) in kinds
    assert not any(k == "all-gather" and d.is_floating_point
                   for k, d in kinds)
    assert not rules.check_wire_format(tr)


def test_ql007_plain_f32_gather_without_qtensor_form_is_clean():
    def clean(x):
        return sharding.all_gather(x, "data", _DATA2).sum() * 2.0
    assert not rules.check_wire_format(_trace(clean, _meta(8)))


# =========================================================================
# QL008 — kept-op escape
# =========================================================================

def test_ql008_flags_every_kept_op_escape():
    """All five kept transcendentals on real data outside any kernel —
    exactly QL008, one finding per primitive."""
    def broken(x):
        return (torch.exp(x) + torch.erf(x) + torch.sigmoid(x)
                + torch.tanh(x) + torch.rsqrt(torch.abs(x) + 1.0))
    f = rules.check_kept_ops(_trace(broken, torch.ones(8)))
    assert _codes(f) == ["QL008"]
    assert sorted(x.message.split(" ")[0] for x in f) == \
        ["erf", "exp", "logistic", "rsqrt", "tanh"]


def test_ql008_exempts_arange_constant_tables():
    """Rope's frequency table is ``exp`` over scaled ``arange``: a
    data-independent constant, not an escaped kept op."""
    def rope_table(x):
        freqs = torch.exp(torch.arange(8, dtype=torch.float32) * -0.3)
        return x * torch.cos(freqs)[None, :]
    assert not rules.check_kept_ops(_trace(rope_table, torch.ones(4, 8)))


def test_ql008_integer_kept_ops_trace_is_clean():
    """The iapprox forms run shifts, multiplies and exact exp2 scalings —
    no kept op appears."""
    from repro_torch.core import iapprox

    def swapped(x):
        return (iapprox.i_exp(x) + iapprox.i_gelu(x) + iapprox.i_silu(x)
                + iapprox.i_tanh(x) + iapprox.i_rsqrt(torch.abs(x) + 1.0)
                + iapprox.i_softmax(x))
    assert not rules.check_kept_ops(_trace(swapped, torch.ones(8)))


def test_ql008_gated_on_policy_kept_ops():
    """run_rules activates QL008 only when the policy carries
    ``kept_ops="integer"`` somewhere; an explicit override wins."""
    tr = _trace(torch.tanh, torch.ones(4))
    fp32_base = dataclasses.replace(QuantConfig.int8(), kept_ops="fp32")
    fp32_pol = QuantPolicy(base=fp32_base)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        int_base = QuantPolicy(base=dataclasses.replace(
            fp32_base, kept_ops="integer"))
        int_rule = QuantPolicy(base=fp32_base, rules=(
            ScopeRule("blocks.*", (("kept_ops", "integer"),)),))
    assert "QL008" not in _codes(rules.run_rules(tr, policy=fp32_pol))
    assert "QL008" in _codes(rules.run_rules(tr, policy=int_base))
    assert "QL008" in _codes(rules.run_rules(
        tr, policy=int_rule, resolutions=[("blocks.0.mlp.act",)]))
    assert "QL008" not in _codes(rules.run_rules(
        tr, policy=int_base, kept_ops=False))


# =========================================================================
# The recorder on a model step
# =========================================================================

QWEN = registry.get_config("qwen1.5-0.5b").reduced()
INT8 = registry.get_quant("int8")


def _qwen_step(device):
    """A reduced qwen int8 loss and backward on ``device``, no noise."""
    params = lm.lm_init(_gen(0), QWEN, device=device)
    params = {k: v for k, v in params.items()}
    toks = torch.zeros((2, 16), dtype=torch.int32, device=device)

    def step():
        from repro_torch.analysis.lint import trainable
        p = trainable(params)
        lm.lm_loss(p, {"tokens": toks, "labels": toks}, QWEN, INT8,
                   None)[0].backward()
    return step


def test_cpu_kernel_events_equal_the_meta_calls():
    """One step's kernel events on the CPU (the plain versions) are the
    calls the meta step's shape-only path counts, wrapper by wrapper."""
    tr = _trace(_qwen_step("cpu"))
    _lib.reset_dry()
    _qwen_step("meta")()
    assert walker.kernel_counts(tr) == dict(_lib.DRY_CALLS)
    assert set(walker.kernel_counts(tr)) >= {
        "dfx_quantize", "bfp_matmul", "bfp_matmul_nt", "bfp_matmul_tn",
        "int_rmsnorm_fwd", "int_rmsnorm_bwd", "int_attn_fwd",
        "int_attn_bwd_dq", "int_attn_bwd_dkv"}


def test_where_names_the_calling_function():
    """``where`` is the innermost frame of the package outside
    ``analysis/`` and ``kernels/``: the autograd Function's forward or
    backward that called the kernel."""
    cfg = dataclasses.replace(QuantConfig.int8(), stochastic_grad=False)
    x = _randn(4, 32).requires_grad_(True)
    w = _randn(32, 16, seed=1).requires_grad_(True)
    tr = _trace(lambda: int_ops.int_linear(x, w, None, None, cfg)
                .sum().backward())
    by = {k.name: k.where for k in tr.kernels()}
    assert by["bfp_matmul"].startswith("int_ops.py:")
    assert by["bfp_matmul"].endswith("(forward)")
    assert by["bfp_matmul_nt"].endswith("(backward)")
    assert by["bfp_matmul_tn"].endswith("(backward)")
    assert all(k.where.endswith("(quantize)") for k in tr.kernels()
               if k.name == "dfx_quantize")


def test_a_wrappers_plain_ops_are_inside_its_kernel():
    """Every op of the plain quantize runs inside the kernel's bracket and
    the kernel's outputs are the values read after it."""
    x = _randn(8, 16)
    e = dfx.scale_exponent(x) - 7
    tr = _trace(lambda: kops.quantize(x, e, 8).to(torch.float32))
    (k,) = list(tr.kernels())
    body = tr.events[k.index + 1:k.end]
    assert body and all(isinstance(b, walker.Op) and b.kernel == k.index
                        for b in body)
    assert {"round", "clamp", "_to_copy"} <= {b.prim for b in body}
    after = [b for b in tr.events[k.end:] if isinstance(b, walker.Op)]
    assert [o.vid for o in k.outs] == [after[0].ins[0].vid]
    assert k.outs[0].dtype == torch.int8
    assert k.static == {"bits": 8, "limbs": 0}


@pytest.mark.parametrize("seq", [True, False])
def test_ql007_flags_sp_gather_of_the_sequence_sharded_step(monkeypatch,
                                                            seq):
    """On a 2-rank model axis (a dry mesh, meta tensors) the
    sequence-sharded step gathers the f32 residual rows (``sp_gather``)
    into the column-parallel products, which quantize them: QL007.
    Without sequence sharding there is no such gather."""
    monkeypatch.setattr(sharding, "SEQUENCE_SHARDING", seq)
    mesh = sharding.dry_mesh((1, 2), ("data", "model"))
    cell = dryrun.build_cell("qwen1.5-0.5b", "train_4k", mesh, INT8,
                             cfg=QWEN, batch=(2, 32))
    tr = _trace(cell.fn, *cell.args)
    tags = {c.tag for c in tr.collectives()}
    f = rules.check_wire_format(tr)
    on_sp = [x for x in f if x.where.startswith("sp_gather")]
    assert ("sp_gather" in tags) == seq
    assert bool(on_sp) == seq
    assert all(x.code == "QL007" for x in f)
