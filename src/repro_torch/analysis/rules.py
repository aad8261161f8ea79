"""quantlint diagnostics registry — stable-coded rules over recorded traces.

Counterpart of ``repro/analysis/rules.py``: the same codes, rules,
messages and ``Finding``; the program they read is a recorded trace of
the port's step (``walker.py``) in place of a jaxpr.  An aten op stands
where the reference has an equation and a kernel wrapper's call where it
has a ``pallas_call``:

* ``dot_general`` -> ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` /
  ``_int_mm`` / ``matmul``;
* ``convert_element_type`` -> ``_to_copy`` (by its ``dtype``);
* ``rem`` / ``div`` -> ``remainder`` / ``fmod`` / ``floor_divide`` /
  ``div`` with a rounding mode;
* ``logistic`` -> ``sigmoid`` / ``silu``, ``erf`` -> ``erf`` / ``gelu``,
  ``exp`` -> ``exp`` / ``_softmax`` / ``_log_softmax``, and ``rsqrt``,
  ``tanh`` as themselves;
* ``all_gather`` -> a ``Collective`` of kind ``all-gather``;
* ``random_bits`` -> a ``Draw``.

Code     Rule                Property proved when silent
-------  ------------------  -------------------------------------------------
QL001    integer-closure     no mantissa arithmetic leaks out of the kernels:
                             no ``rsqrt`` outside a kernel, no limb-split
                             ``rem``/``div`` chains on quantized integers, no
                             product contracting integer mantissas, and no
                             ``exp`` on attention scores such a product made
QL002    key-discipline      no two stochastic-rounding draws start from one
                             generator state (a cloned or re-seeded
                             generator); a remat recompute's replay of the
                             forward's draw is that draw, not a second use
QL003    policy-hygiene      every ``QuantPolicy`` rule matched some resolved
                             path (not dead), changed some resolution (not
                             shadowed), and no call site resolved at the root
                             path under a scoped policy (unscoped call site)
QL004    dispatch-budget     kernel calls per call at or below the pinned
                             ``analysis/dispatch_baseline.json``
QL005    stability           no resolved scope lands in the paper's Fig. 4
                             divergence regime (weight_bits=8, act_bits<12)
QL006    accum-budget        no product/reduction site's worst-case mantissa
                             magnitude exceeds its accumulator's exact range
                             (interval model in ``budget.py``)
QL007    wire-format         no float ``all-gather`` moves a tensor the same
                             trace quantizes — a QTensor form exists, so the
                             collective should carry int8 limb planes + a
                             per-shard exponent
                             (sharding.quantized_all_gather)
QL008    kept-op-escape      under a ``kept_ops="integer"`` policy no
                             ``exp``/``erf``/``logistic``/``tanh``/``rsqrt``
                             op runs outside a kernel; purely arange/
                             literal-derived constant tables (rope
                             frequencies) are exempt

QL007's quantize sites are a float->int ``_to_copy`` outside a kernel or
the float operand of a ``dfx_quantize`` / ``dfx_quantize_grouped`` call
(the port quantizes through those wrappers); an all-gather whose operand
no input reaches counts as a tensor of its own.

Graph rules (QL001/QL002/QL006/QL007/QL008) need only a trace — QL008
additionally gates on the policy carrying ``kept_ops="integer"`` anywhere;
policy rules (QL003/QL005) need the resolutions recorded with the trace
(``qpolicy.record_resolutions``); QL004 compares count dicts and is what
``analysis/dispatch.py`` delegates to.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.analysis import budget, walker
from repro_torch.analysis.budget import base_prim

__all__ = ["Finding", "ALL_RULES", "check_integer_closure",
           "check_key_discipline", "check_policy_hygiene",
           "check_dispatch_budget", "check_stability", "check_accum_budget",
           "check_wire_format", "check_kept_ops", "dispatch_counts",
           "run_rules"]


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic: a stable code, the violated rule, and the site."""

    code: str
    rule: str
    message: str
    where: str = ""

    def to_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)

    def __str__(self):
        loc = f" [{self.where}]" if self.where else ""
        return f"{self.code} {self.rule}: {self.message}{loc}"


def _kind(dtype: Optional[torch.dtype]) -> str:
    """numpy-style kind char of a torch dtype: ``i``, ``u``, ``f``, ``b``."""
    if dtype is None:
        return ""
    if dtype == torch.bool:
        return "b"
    if dtype.is_floating_point:
        return "f"
    if dtype.is_complex:
        return "c"
    return "u" if dtype == torch.uint8 else "i"


def _src(e) -> str:
    return e.where or getattr(e, "prim", "")


# =========================================================================
# aten op classes
# =========================================================================

_ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "maximum", "minimum", "remainder", "fmod",
    "div", "floor_divide", "neg", "abs", "sign", "clamp", "clamp_min",
    "clamp_max", "shift_left", "shift_right", "and", "or", "xor", "not",
    "pow", "where", "masked_fill",
})

_SHAPE_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "expand_as", "permute",
    "transpose", "t", "squeeze", "unsqueeze", "slice", "select", "index",
    "gather", "index_select", "take_along_dim", "cat", "stack", "clone",
    "contiguous", "alias", "detach", "lift_fresh", "split",
    "split_with_sizes", "unbind", "chunk", "narrow", "constant_pad_nd",
    "flip", "copy", "sum", "amax", "amin", "max", "min", "cumsum",
    "as_strided", "unfold", "repeat", "index_put", "slice_scatter",
    "select_scatter", "movedim", "view_as",
})

#: the products that stand for ``dot_general``
_DOTS = frozenset({"mm", "bmm", "addmm", "baddbmm", "_int_mm", "matmul",
                   "dot", "mv", "addmv", "addbmm"})

#: ops whose value depends on no data: index arithmetic's sources
_CONST = frozenset({"arange", "zeros", "ones", "full", "scalar_tensor",
                    "new_zeros", "new_ones", "new_full"})

#: the kernel wrappers that quantize their float operand
_QUANTIZE = ("dfx_quantize", "dfx_quantize_grouped")


def _rem_div(op: walker.Op) -> Optional[str]:
    """``rem`` / ``div`` for an integer remainder or rounding division."""
    prim = base_prim(op)
    if prim in ("remainder", "fmod"):
        return "rem"
    if prim == "floor_divide" or (prim == "div" and op.kwargs.get(
            "rounding_mode") is not None):
        return "div"
    return None


def _kept_name(op: walker.Op) -> Optional[str]:
    """The reference primitive a kept transcendental op is (``exp``,
    ``erf``, ``logistic``, ``tanh``, ``rsqrt``), else None."""
    prim = base_prim(op)
    if prim in ("exp", "erf", "tanh", "rsqrt"):
        return prim
    if prim in ("_softmax", "softmax", "_log_softmax", "log_softmax"):
        return "exp"
    if prim in ("sigmoid", "silu"):
        return "logistic"
    if prim == "gelu":
        return "tanh" if op.kwargs.get("approximate") == "tanh" \
            or "tanh" in op.args[1:] else "erf"
    return None


def _dtype_of(x) -> Optional[torch.dtype]:
    return x.dtype if isinstance(x, walker.TensorInfo) else None


# =========================================================================
# QL001 — integer closure
# =========================================================================

#: abstract tags for the closure analysis
_IOTA = "iota"        # index arithmetic (arange/literal-derived) — benign
_QINT = "qint"        # integer mantissa (rounded float / kernel output)
_QFLOAT = "qfloat"    # float that IS an immediate convert of a mantissa
_SCORE = "score"      # attention scores an integer product produced


class _ClosureSemantics(walker.Semantics):
    def __init__(self):
        self.findings: List[Finding] = []

    def literal(self, lit):
        return _IOTA

    def _flag(self, op, what):
        self.findings.append(Finding(
            code="QL001", rule="integer-closure",
            message=what, where=_src(op)))

    def op(self, op, in_vals, ctx):
        prim = base_prim(op)
        n_out = len(op.outs)
        out_int = n_out > 0 and _kind(op.outs[0].dtype) in "iu"
        score_out = False

        if not ctx.inside_kernel:
            rd = _rem_div(op)
            if prim == "rsqrt":
                self._flag(op, "rsqrt outside a pallas kernel (norm "
                               "statistics recomputed in XLA)")
            elif rd is not None and out_int \
                    and any(v == _QINT for v in in_vals):
                self._flag(op, f"integer {rd} on quantized mantissas in "
                               "XLA (limb-split chain outside the fused "
                               "quantize kernel)")
            elif prim in _DOTS:
                int_in = any(_kind(_dtype_of(x)) in "iu" for x in op.ins)
                if int_in or any(v == _QFLOAT for v in in_vals):
                    self._flag(op, "XLA dot_general contracts integer "
                                   "mantissas (sim-path fallback on the "
                                   "pallas backend)")
                    score_out = True
            elif _kept_name(op) == "exp" and any(v == _SCORE
                                                 for v in in_vals):
                self._flag(op, "exp on attention scores an XLA integer "
                               "dot_general produced (softmax outside the "
                               "fused attention kernel)")

        # ---- tag transfer ----
        if prim in _DOTS:
            return [_SCORE if score_out else None] * n_out
        if prim in _CONST:
            return [_IOTA] * n_out
        if prim == "_to_copy":
            new = op.kwargs.get("dtype")
            v = in_vals[0]
            if new is None:
                return [v]
            kind = _kind(new)
            src_int = _kind(op.ins[0].dtype) in "iub"
            if kind in "iu":
                if v == _IOTA:
                    return [_IOTA]
                # float -> int is a rounding/quantize step; int -> int keeps
                return [v if src_int else _QINT]
            if kind == "f":
                if v == _QINT:
                    return [_QFLOAT]
                return [_IOTA if v == _IOTA else None]
            return [None]
        if prim in _ELEMENTWISE or prim in _SHAPE_OPS:
            # score taint dominates: masking/scaling/max-subtracting the
            # scores still leaves "scores" for the exp check above
            if any(v == _SCORE for v in in_vals):
                return [_SCORE] * n_out
            if any(v == _QINT for v in in_vals) and out_int:
                return [_QINT] * n_out
            # unknown dominates: clamp(unknown, lit, lit) is NOT index math
            if in_vals and all(v == _IOTA for v in in_vals):
                return [_IOTA] * n_out
            return [None] * n_out
        return [None] * n_out

    def kernel(self, k, in_vals, ctx):
        return [_QINT if _kind(t.dtype) in "iu" else None for t in k.outs]


def check_integer_closure(trace: walker.Trace) -> List[Finding]:
    """QL001 on one recorded trace."""
    sem = _ClosureSemantics()
    walker.interpret(trace, sem)
    return sem.findings


# =========================================================================
# QL002 — PRNG key discipline
# =========================================================================

def check_key_discipline(trace: walker.Trace) -> List[Finding]:
    """QL002: two stochastic draws from one generator state.

    A draw's generator state before it (its digest) is the port's key
    token: draws from one generator in turn see distinct states, while a
    generator cloned from another, or re-seeded per layer, starts a second
    draw from a state an earlier one consumed.  A remat recompute's
    generator (``lm._replay_key``) replays the forward's draw: it counts as
    that draw (``Draw.replay_of``), not as a second use.  A draw on
    ``meta`` (the dry-run) takes nothing from the stream and is no use."""
    consumed: Dict[str, List[str]] = {}
    for d in trace.draws():
        if d.replay_of is not None or d.digest is None:
            continue
        consumed.setdefault(d.digest, []).append(_src(d))
    findings = []
    for digest, uses in consumed.items():
        total = len(uses)
        if total < 2:
            continue
        sites = sorted(set(uses))
        findings.append(Finding(
            code="QL002", rule="key-discipline",
            message=f"PRNG key consumed by {total} stochastic draws; "
                    "split/fold_in before reuse",
            where="; ".join(sites[:4])))
    return findings


# =========================================================================
# QL003 / QL005 — policy hygiene and stability (need recorded resolutions)
# =========================================================================

def check_policy_hygiene(policy, resolutions: Sequence[Tuple[str, ...]]
                         ) -> List[Finding]:
    """QL003 over the paths actually resolved during a recorded step.

    ``resolutions`` is the list of alias-path tuples recorded by
    ``qpolicy.record_resolutions`` — one entry per ``resolve`` call.
    """
    findings: List[Finding] = []
    path_tuples = list(dict.fromkeys(tuple(p) for p in resolutions))
    all_paths = sorted({p for tup in path_tuples for p in tup})

    if policy.rules:
        unscoped = [tup for tup in path_tuples if all(p == "" for p in tup)]
        if unscoped:
            findings.append(Finding(
                code="QL003", rule="policy-hygiene",
                message=f"{len(unscoped)} call site(s) resolved at the root "
                        "path under a scoped policy — the call site never "
                        "descended a Scope, so no rule can address it",
                where="<root>"))

    for i, r in enumerate(policy.rules):
        if not any(r.matches(p) for p in all_paths):
            findings.append(Finding(
                code="QL003", rule="policy-hygiene",
                message=f"dead rule {r.pattern!r}: matches none of the "
                        f"{len(all_paths)} path(s) this trace resolved",
                where=r.pattern))
            continue
        without = dataclasses.replace(
            policy, rules=tuple(x for j, x in enumerate(policy.rules)
                                if j != i))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            shadowed = all(policy.resolve(tup) == without.resolve(tup)
                           for tup in path_tuples)
        if shadowed:
            findings.append(Finding(
                code="QL003", rule="policy-hygiene",
                message=f"shadowed rule {r.pattern!r}: removing it changes "
                        "no resolved leaf (a more specific rule overrides "
                        "every field it sets)",
                where=r.pattern))
    return findings


def check_stability(policy, resolutions: Sequence[Tuple[str, ...]]
                    ) -> List[Finding]:
    """QL005: resolved scopes in the Fig. 4 divergence regime."""
    from repro_torch.core.qconfig import stability_violated

    findings = []
    seen = set()
    for tup in dict.fromkeys(tuple(p) for p in resolutions):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            leaf = policy.resolve(tup)
        if stability_violated(leaf) and leaf.warn_stability:
            key = (tup[0], leaf.weight_bits, leaf.act_bits)
            if key in seen:
                continue
            seen.add(key)
            findings.append(Finding(
                code="QL005", rule="stability",
                message=f"resolved scope lands in the divergence regime "
                        f"(weight_bits={leaf.weight_bits}, act_bits="
                        f"{leaf.act_bits} < 12; paper Fig. 4)",
                where=tup[0] or "<root>"))
    if not resolutions and stability_violated(policy.base) \
            and policy.base.warn_stability:
        findings.append(Finding(
            code="QL005", rule="stability",
            message=f"base config is in the divergence regime (weight_bits="
                    f"{policy.base.weight_bits}, act_bits="
                    f"{policy.base.act_bits} < 12; paper Fig. 4)",
            where="<base>"))
    return findings


# =========================================================================
# QL004 — dispatch budget
# =========================================================================

def dispatch_counts(trace: walker.Trace) -> Dict[str, int]:
    """Kernel calls of one recorded call: the reference's ``effective``
    count (the port's loops are Python loops, so there is no ``traced``
    program text)."""
    return {"effective": walker.count_kernels(trace)}


def _entry_counts(entry) -> Dict[str, int]:
    if isinstance(entry, Mapping):
        return {k: int(v) for k, v in entry.items()}
    return {"effective": int(entry)}


def check_dispatch_budget(current: Mapping[str, Mapping[str, Any]],
                          baseline: Mapping[str, Mapping[str, Any]],
                          ) -> Tuple[List[Finding], List[Tuple[str, int, int]]]:
    """QL004: diff derived counts against the pinned baseline.

    Entries are plain ints (kernel calls per call) or ``{"effective": n}``
    dicts.  Returns ``(findings, improvements)`` — any count above
    baseline, a baseline entry with no current counterpart (MISSING), or a
    current entry the baseline does not pin (UNPINNED) is a finding;
    counts below baseline are improvements to re-pin.
    """
    findings: List[Finding] = []
    improvements: List[Tuple[str, int, int]] = []
    for section, entries in baseline.items():
        for name, base_entry in entries.items():
            key = f"{section}.{name}"
            cur_entry = current.get(section, {}).get(name)
            if cur_entry is None:
                findings.append(Finding(
                    code="QL004", rule="dispatch-budget",
                    message="baseline entry has no derived counterpart "
                            "(MISSING)", where=key))
                continue
            base_c, cur_c = _entry_counts(base_entry), _entry_counts(cur_entry)
            for kind, base_n in base_c.items():
                cur_n = cur_c.get(kind)
                if cur_n is None:
                    continue
                if cur_n > base_n:
                    findings.append(Finding(
                        code="QL004", rule="dispatch-budget",
                        message=f"{kind} pallas_call count {cur_n} exceeds "
                                f"baseline {base_n}",
                        where=key))
                elif cur_n < base_n:
                    improvements.append((f"{key}.{kind}", base_n, cur_n))
    for section, entries in current.items():
        for name, cur_entry in entries.items():
            if baseline.get(section, {}).get(name) is None:
                cur_c = _entry_counts(cur_entry)
                findings.append(Finding(
                    code="QL004", rule="dispatch-budget",
                    message=f"derived counts {cur_c} not pinned by the "
                            "baseline (UNPINNED — refresh with --update)",
                    where=f"{section}.{name}"))
    return findings, improvements


# =========================================================================
# QL006 — accumulator budget
# =========================================================================

def check_accum_budget(trace: walker.Trace) -> List[Finding]:
    """QL006: overflow sites from the interval model in ``budget.py``."""
    return [Finding(
        code="QL006", rule="accum-budget",
        message=f"{s.kind} needs {s.bits_needed} bits (worst case "
                f"{s.bound}) but {s.accum} holds {s.capacity} exactly"
                + (f" — {s.detail}" if s.detail else ""),
        where=s.where) for s in budget.check_trace(trace)]


# =========================================================================
# QL007 — wire format
# =========================================================================

#: ops that preserve "this is (a scaled/shifted view of) the same tensor"
#: for origin tracking — the elementwise/shape sets plus the rounding steps
#: a quantizer applies before its int convert
_ORIGIN_PASS = _ELEMENTWISE | _SHAPE_OPS | frozenset({
    "round", "floor", "ceil", "exp2", "_to_copy"})


class _WireSemantics(walker.Semantics):
    """Origin tracking for the wire-format rule.

    Every float input mints an origin uid, and so does the float operand
    of an all-gather that no input reaches; elementwise/shape/rounding ops
    propagate the union of their operands' origins (a scaled or rounded
    view is still "the same tensor" — products and other contractions
    mint nothing and so break the chain).  Two use-sites are recorded per
    origin: a float all-gather and a quantize (a float->int ``_to_copy``
    outside a kernel, or the float operand of a quantize kernel).  An
    origin with both moved full-width bytes over a wire although its
    b-bit QTensor form demonstrably exists in the very same trace — in
    either order: quantize after the gather, or a float gather of a tensor
    quantized elsewhere.
    """

    def __init__(self):
        self._next = 0
        self.gathered: Dict[int, str] = {}    # origin uid -> gather site
        self.quantized: Dict[int, str] = {}   # origin uid -> quantize site

    def _mint(self):
        self._next += 1
        return frozenset((self._next,))

    def input(self, info, index):
        return self._mint() if _kind(info.dtype) == "f" else None

    @staticmethod
    def _union(vals):
        vs = [v for v in vals if v]
        return frozenset().union(*vs) if vs else None

    def collective(self, c, in_val, ctx):
        if c.kind != "all-gather":
            return None
        if _kind(c.src.dtype) != "f":
            return in_val
        tags = in_val or self._mint()
        for uid in tags:
            self.gathered.setdefault(uid, _src(c))
        # the gathered copy carries the same content
        return tags

    def kernel(self, k, in_vals, ctx):
        x = k.operands[0] if k.operands else None
        if k.name in _QUANTIZE and x is not None and _kind(x.dtype) == "f" \
                and in_vals[0]:
            for uid in in_vals[0]:
                self.quantized.setdefault(uid, k.where or k.name)
        return [None] * len(k.outs)

    def op(self, op, in_vals, ctx):
        prim = base_prim(op)
        tags = self._union(in_vals)
        if prim == "_to_copy":
            new = op.kwargs.get("dtype")
            if new is not None and _kind(new) in "iu" \
                    and _kind(op.ins[0].dtype) == "f" and in_vals[0]:
                for uid in in_vals[0]:
                    self.quantized.setdefault(uid, _src(op))
            return [in_vals[0]]
        if prim in _ORIGIN_PASS:
            return [tags] * len(op.outs)
        return [None] * len(op.outs)


def check_wire_format(trace: walker.Trace) -> List[Finding]:
    """QL007: float all-gather of a tensor whose QTensor form exists."""
    sem = _WireSemantics()
    walker.interpret(trace, sem)
    findings = []
    for uid, site in sorted(sem.gathered.items()):
        if uid in sem.quantized:
            findings.append(Finding(
                code="QL007", rule="wire-format",
                message="float32 all_gather of a tensor the same graph "
                        "quantizes to an integer mantissa — gather the "
                        "QTensor form (int8 limb planes + per-shard "
                        "exponent, sharding.quantized_all_gather) and move "
                        "~4x fewer bytes",
                where=site))
    return findings


# =========================================================================
# QL008 — kept-op escape
# =========================================================================

class _KeptOpsSemantics(walker.Semantics):
    """QL008 taint walk — the QL001 constant tracking reduced to one tag.

    Only ``_IOTA`` is tracked: a kept op whose every operand is
    arange/literal-derived (a data-independent constant table, e.g. rope's
    ``exp`` over scaled ``arange`` frequencies) is benign.  Anything
    touched by real data loses the tag, so a ``tanh`` on activations
    outside a kernel is flagged.
    """

    def __init__(self):
        self.findings: List[Finding] = []

    def literal(self, lit):
        return _IOTA

    def op(self, op, in_vals, ctx):
        name = _kept_name(op)
        const_only = bool(in_vals) and all(v == _IOTA for v in in_vals)
        if not ctx.inside_kernel and name is not None and not const_only:
            self.findings.append(Finding(
                code="QL008", rule="kept-op-escape",
                message=f"{name} outside a pallas kernel under a "
                        'kept_ops="integer" policy — route the call site '
                        "through the iapprox fixed-point form "
                        "(int_ops.int_activation / i_rsqrt / i_exp, "
                        "DESIGN.md §10)",
                where=_src(op)))
        if base_prim(op) in _CONST:
            return [_IOTA] * len(op.outs)
        # a value computed ONLY from literals/arange stays index math
        # through any op — it cannot carry activations
        if const_only:
            return [_IOTA] * len(op.outs)
        return [None] * len(op.outs)


#: FP32-by-design regions the kept-ops swap deliberately does not cover
#: (DESIGN.md §10): the SSD selective-scan recurrence in ``models/ssm.py``
#: and its softplus-dt / ``exp(A_log)`` reparameterization — never
#: quantized, same category as the optimizer.  Findings whose source frame
#: lands in one of these functions are suppressed.
_KEPT_OPS_EXEMPT_FNS = ("ssd_chunked", "ssd_decode_step", "mamba2_apply")


def check_kept_ops(trace: walker.Trace,
                   exempt_fns: Sequence[str] = _KEPT_OPS_EXEMPT_FNS
                   ) -> List[Finding]:
    """QL008 on one trace recorded under ``kept_ops="integer"``."""
    sem = _KeptOpsSemantics()
    walker.interpret(trace, sem)
    return [f for f in sem.findings
            if not any(f"({fn})" in f.where for fn in exempt_fns)]


# =========================================================================
# Registry / driver
# =========================================================================

ALL_RULES = {
    "QL001": "integer-closure",
    "QL002": "key-discipline",
    "QL003": "policy-hygiene",
    "QL004": "dispatch-budget",
    "QL005": "stability",
    "QL006": "accum-budget",
    "QL007": "wire-format",
    "QL008": "kept-op-escape",
}


def _policy_wants_integer_kept_ops(policy) -> bool:
    """Does the policy carry ``kept_ops="integer"`` anywhere — base config
    or any rule override?  (The activation gate for QL008.)"""
    if getattr(policy.base, "kept_ops", "fp32") == "integer":
        return True
    return any(dict(r.overrides).get("kept_ops") == "integer"
               for r in policy.rules)


def run_rules(trace: walker.Trace, *, policy=None,
              resolutions: Optional[Sequence[Tuple[str, ...]]] = None,
              kept_ops: Optional[bool] = None,
              ) -> List[Finding]:
    """All graph rules on one recorded trace, plus the policy rules when
    the step's policy and recorded resolutions are supplied.  (QL004 runs
    against a baseline via ``check_dispatch_budget`` — see
    ``analysis/dispatch.py``.)

    QL008 runs when ``kept_ops=True``, or (``kept_ops=None``) when the
    supplied policy carries ``kept_ops="integer"`` anywhere — a plain-FP32
    step legitimately keeps its float transcendentals, so the rule is
    activation-gated rather than unconditional."""
    findings = []
    findings += check_integer_closure(trace)
    findings += check_key_discipline(trace)
    findings += check_accum_budget(trace)
    findings += check_wire_format(trace)
    if kept_ops is None:
        kept_ops = policy is not None and _policy_wants_integer_kept_ops(policy)
    if kept_ops:
        findings += check_kept_ops(trace)
    if policy is not None:
        findings += check_policy_hygiene(policy, resolutions or ())
        findings += check_stability(policy, resolutions or ())
    # the same source site reappears once per layer and per recompute of
    # the step — one finding per distinct diagnostic is enough
    return list(dict.fromkeys(findings))
