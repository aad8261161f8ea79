"""Interval-arithmetic accumulator-overflow checker (quantlint QL006).

Counterpart of ``repro/analysis/budget.py``, over a recorded trace
(``walker.py``) in place of a jaxpr.  Propagates a worst-case **magnitude
interval** for every integer-valued tensor forward through the trace —
originating at quantizer clips (``clamp`` with number bounds),
``arange`` and constant factories, Python-number operands, comparison
outputs and the quantize kernels' outputs, dying at any op that destroys
exact integrality (a true division, the ``2^exp`` dequantize multiply
whose scale is a runtime value) — and checks every accumulation site
against the *exact* capacity of its accumulator:

* integer accumulators hold their dtype range (int32: ``2^31 - 1``),
* float accumulators hold integers exactly only up to ``2^mantissa``
  (f32: ``2^24``, f64: ``2^53``) — beyond that an integer-valued sum
  silently rounds, the failure mode of a direct int16 ``Σx²`` at D = 768
  (bit budget ``2(b-1) + log2 D`` ≈ 40).

Checked sites, outside the kernels: ``sum`` / ``cumsum`` (bound ×
reduced extent) and the products ``mm`` / ``bmm`` / ``addmm`` /
``baddbmm`` / ``_int_mm`` / ``matmul`` / ``convolution`` (|lhs|·|rhs| ×
contracted extent).  A kernel call is checked **structurally** from its
``Kernel`` event instead of by reading its body: the wrapper, the operand
shapes, the storage bit-width and the contraction extents the wrapper
reports determine the worst case, with the reference's bounds —

* limb matmul kernels accumulate balanced base-2⁷ digit products
  (|digit| ≤ 64) in int32: ``64² · K ≤ 2^31 - 1`` caps the contraction at
  K ≤ 524 287;
* attention kernels bound each integer dot by ``128 · 64 · K``;
* norm kernels split the mantissa into balanced base-2⁸ digits
  (|digit| ≤ 128) so each ``Σ digit²`` partial needs ``14 + log2 D`` bits,
  and sum the raw mantissa (``Σx``: ``(b-1) + log2 D`` bits, ``Σg`` over
  the rows for dbeta) in int32;
* quantize kernels accumulate nothing.

A bitwise op's result is ``[0, 1]`` for a boolean output and the
mask's range for an integer one (the digit split ``(x + 128) & 255``).

``check_trace`` returns plain ``OverflowSite`` records; ``rules.py`` turns
them into QL006 findings.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch

from repro_torch.analysis import walker

__all__ = ["Interval", "OverflowSite", "exact_capacity", "sum_bits_needed",
           "check_sum_site", "check_kernel_site", "check_trace"]

#: int32 range of the kernel accumulators.
_INT32_MAX = 2**31 - 1

#: balanced base-2⁷ limb digits of the matmul kernels (|digit| ≤ 64 — the
#: final plane's raw carry included; kernels/dfx_quant.py).
_MATMUL_DIGIT = 64

#: balanced base-2⁸ digits of the norm kernels' exact-moment split
#: (kernels/int_norm.py ``exact_sq_sum``; |hi|, |lo| ≤ 128).
_NORM_DIGIT = 128

_QUANTIZE = ("dfx_quantize", "dfx_quantize_grouped")
_NORMS = ("int_layernorm_fwd", "int_layernorm_bwd", "int_rmsnorm_fwd",
          "int_rmsnorm_bwd")


def _is_int(dtype) -> bool:
    return not dtype.is_floating_point and not dtype.is_complex \
        and dtype != torch.bool


def exact_capacity(dtype: torch.dtype) -> Optional[int]:
    """Largest magnitude the dtype accumulates *exactly* (None: bool)."""
    if dtype == torch.bool:
        return None
    if dtype.is_floating_point:
        return 1 << _NMANT[dtype]
    return int(torch.iinfo(dtype).max)


#: explicit mantissa bits (numpy's ``finfo.nmant``, which the reference
#: reads; ``torch.finfo`` has no such field)
_NMANT = {torch.float16: 10, torch.bfloat16: 7, torch.float32: 23,
          torch.float64: 52}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class Interval:
    """Inclusive bounds on an integer-valued tensor's elements.

    ``integral`` distinguishes exact integer-valued data (whose float
    accumulation can silently round past ``2^mantissa``) from merely
    bounded reals.
    """

    lo: int
    hi: int
    integral: bool = True

    @property
    def mag(self) -> int:
        return max(abs(self.lo), abs(self.hi))

    def hull(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi),
                        self.integral and other.integral)


def _dtype_interval(dtype: torch.dtype) -> Optional[Interval]:
    if dtype == torch.bool:
        return Interval(0, 1)
    if _is_int(dtype):
        info = torch.iinfo(dtype)
        return Interval(int(info.min), int(info.max))
    return None


def _number_interval(v) -> Optional[Interval]:
    if isinstance(v, bool) or not isinstance(v, (int, float)) \
            or not math.isfinite(v):
        return None
    integral = float(v) == math.floor(v)
    return Interval(math.floor(v), math.ceil(v), integral)


@dataclasses.dataclass(frozen=True)
class OverflowSite:
    """One accumulation whose worst case exceeds its accumulator."""

    kind: str         # "sum" | "cumsum" | "mm" | ... | "kernel"
    where: str        # source location or kernel name
    bound: int        # worst-case |accumulated value|
    capacity: int     # exact capacity of the accumulator
    accum: str        # accumulator dtype name
    detail: str = ""

    @property
    def bits_needed(self) -> int:
        return max(1, int(math.ceil(math.log2(max(self.bound, 2)))))


def sum_bits_needed(bits: int, extent: int, *, squared: bool = False) -> int:
    """Bit budget of ``Σ m`` (or ``Σ m²``) over ``extent`` b-bit mantissas —
    the DESIGN.md §2 formula the interval model generalizes."""
    per = (2 * (bits - 1)) if squared else (bits - 1)
    return per + max(1, int(math.ceil(math.log2(max(extent, 2)))))


def check_sum_site(bits: int, extent: int, *, squared: bool = False,
                   accum: torch.dtype = torch.int32, where: str = "<site>"
                   ) -> Optional[OverflowSite]:
    """Direct-form check of one mantissa reduction (no trace needed).

    ``check_sum_site(16, 768, squared=True)`` is the seed-style norm
    moment: a ~40-bit ``Σx²`` against int32's 31.
    """
    m = 2 ** (bits - 1) - 1
    bound = (m * m if squared else m) * extent
    cap = exact_capacity(accum)
    if cap is not None and bound > cap:
        return OverflowSite(kind="sum", where=where, bound=bound,
                            capacity=cap, accum=_dtype_name(accum),
                            detail=f"sum of {'squared ' if squared else ''}"
                                   f"{bits}-bit mantissas over {extent}")
    return None


# =========================================================================
# Interval propagation over the ops outside the kernels
# =========================================================================

_PROPAGATE = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "expand_as", "permute",
    "transpose", "t", "squeeze", "unsqueeze", "slice", "select", "index",
    "gather", "index_select", "take_along_dim", "alias", "clone", "detach",
    "lift_fresh", "contiguous", "flip", "unfold", "as_strided", "amax",
    "amin", "sort", "repeat", "split", "split_with_sizes", "unbind", "chunk",
    "narrow", "movedim", "view_as", "squeeze_copy", "unsqueeze_copy",
    "max", "min",
})

_JOIN = frozenset({"cat", "stack", "where", "constant_pad_nd", "maximum",
                   "minimum", "index_put", "slice_scatter", "select_scatter",
                   "masked_fill"})

_BOOLEAN = frozenset({"eq", "ne", "lt", "le", "gt", "ge", "isfinite",
                      "logical_and", "logical_or", "logical_not",
                      "logical_xor", "isnan", "isinf"})

_BITWISE = frozenset({"and", "or", "xor", "not"})

_SUMS = frozenset({"sum", "cumsum"})

_PRODUCTS = frozenset({"mm", "bmm", "addmm", "baddbmm", "_int_mm", "matmul",
                       "convolution"})

_FACTORY = {"zeros": 0, "zeros_like": 0, "new_zeros": 0, "ones": 1,
            "ones_like": 1, "new_ones": 1}
_FILL = frozenset({"full", "full_like", "new_full", "scalar_tensor"})

#: aten spellings -> the names the rules speak of
_ALIASES = {"__rshift__": "shift_right", "bitwise_right_shift": "shift_right",
            "__lshift__": "shift_left", "bitwise_left_shift": "shift_left",
            "__and__": "and", "bitwise_and": "and", "__or__": "or",
            "bitwise_or": "or", "__xor__": "xor", "bitwise_xor": "xor",
            "bitwise_not": "not", "__rsub__": "rsub", "clip": "clamp"}


def base_prim(op: walker.Op) -> str:
    """The op's name with an in-place op's trailing ``_`` dropped and the
    aten spellings of one operation merged (``__rshift__`` and
    ``bitwise_right_shift`` are ``shift_right``)."""
    p = op.prim
    if p.endswith("_") and not p.endswith("__"):
        p = p[:-1]
    return _ALIASES.get(p, p)


def _src(op) -> str:
    return op.where or op.prim


class IntervalSemantics(walker.Semantics):
    """Forward interval propagation; records overflow sites."""

    def __init__(self):
        self.sites: List[OverflowSite] = []

    # -- value sources ----------------------------------------------------
    def literal(self, lit):
        return _number_interval(lit.val)

    # tensors no recorded op made stay unknown: raw integer *data* (token
    # ids) is not mantissa arithmetic, and assuming its dtype range would
    # flag benign bookkeeping sums.  Mantissa chains originate at quantizer
    # clips and kernel outputs instead.

    # -- transfer ---------------------------------------------------------
    def op(self, op, in_vals, ctx):
        prim = base_prim(op)
        n_out = len(op.outs)
        out_dtype = op.outs[0].dtype if op.outs else None
        a = in_vals[0] if in_vals else None
        b = in_vals[1] if len(in_vals) > 1 else None

        if prim == "arange":
            nums = [x for x in op.args if isinstance(x, (int, float))
                    and not isinstance(x, bool)]
            if not nums:
                return [None]
            start, end, step = ((0, nums[0], 1) if len(nums) == 1 else
                                (nums[0], nums[1], nums[2] if len(nums) > 2
                                 else 1))
            last = start + step * max(math.ceil((end - start) / step) - 1, 0)
            lo, hi = min(start, last), max(start, last)
            return [Interval(math.floor(lo), math.ceil(hi),
                             all(float(x).is_integer() for x in nums))]
        if prim in _FACTORY:
            v = _FACTORY[prim]
            return [Interval(v, v)]
        if prim in _FILL:
            nums = [x for x in op.args if isinstance(x, (int, float))
                    and not isinstance(x, bool)]
            return [_number_interval(nums[-1]) if nums else None]

        if prim in _BOOLEAN or (prim in _BITWISE
                                and out_dtype == torch.bool):
            return [Interval(0, 1)] * n_out

        if prim == "_to_copy":
            new = op.kwargs.get("dtype")
            rng = _dtype_interval(new) if new is not None else None
            if rng is not None:                        # -> integer dtype
                if a is None:
                    return [None]
                return [Interval(max(a.lo, rng.lo), min(a.hi, rng.hi))]
            return [a]                                 # -> float, keeps bound

        if prim == "clamp":
            lo_v = _number_interval(op.args[1]) if len(op.args) > 1 else None
            hi_v = _number_interval(op.args[2]) if len(op.args) > 2 else None
            if lo_v is not None and hi_v is not None:
                integral = (lo_v.integral and hi_v.integral
                            and (a.integral if a is not None else True))
                lo = max(lo_v.lo, a.lo) if a is not None else lo_v.lo
                hi = min(hi_v.hi, a.hi) if a is not None else hi_v.hi
                return [Interval(min(lo, hi), max(lo, hi), integral)]
            return [a]

        if prim in ("add", "sub", "rsub") and a is not None \
                and b is not None:
            if prim == "rsub":
                a, b = b, a
            if prim == "add":
                return [Interval(a.lo + b.lo, a.hi + b.hi,
                                 a.integral and b.integral)]
            return [Interval(a.lo - b.hi, a.hi - b.lo,
                             a.integral and b.integral)]

        if prim == "mul" and a is not None and b is not None:
            prods = [a.lo * b.lo, a.lo * b.hi, a.hi * b.lo, a.hi * b.hi]
            return [Interval(min(prods), max(prods),
                             a.integral and b.integral)]

        if prim in ("neg", "abs", "sign", "floor", "ceil", "round", "trunc"):
            if a is None:
                return [None]
            if prim == "neg":
                return [Interval(-a.hi, -a.lo, a.integral)]
            if prim == "abs":
                return [Interval(0, a.mag, a.integral)]
            if prim == "sign":
                return [Interval(-1, 1)]
            return [Interval(a.lo, a.hi, True)]        # floor/ceil/round

        if prim == "pow" and isinstance(b, Interval) and b.lo == b.hi \
                and b.integral and b.lo >= 0:
            if a is None:
                return [None]
            p = b.lo
            vals = [a.lo ** p, a.hi ** p] + ([0] if a.lo < 0 < a.hi else [])
            return [Interval(min(vals), max(vals), a.integral)]

        if prim in ("remainder", "fmod") and b is not None and b.lo > 0:
            m = b.hi - 1
            lo = -m if (a is None or a.lo < 0) else 0
            return [Interval(lo, m)]

        if (prim == "floor_divide" or (prim == "div" and op.kwargs.get(
                "rounding_mode") is not None)) and a is not None \
                and b is not None and (b.lo > 0 or b.hi < 0):
            d = min(abs(b.lo), abs(b.hi))
            return [Interval(-(-a.lo // d) if a.lo < 0 else a.lo // d,
                             a.hi // d if a.hi >= 0 else -(-a.hi // d),
                             a.integral and b.integral)]

        if prim == "shift_right" and a is not None and b is not None \
                and b.lo >= 0:
            s = b.lo
            return [Interval(a.lo >> s, a.hi >> s)]

        if prim == "shift_left" and a is not None and b is not None \
                and b.lo == b.hi and b.lo >= 0:
            s = b.lo
            return [Interval(a.lo << s, a.hi << s)]

        if prim == "and" and out_dtype is not None and _is_int(out_dtype):
            # bitwise mask: |result| bounded by the wider operand (the
            # digit-split idiom ``(x + 128) & 255``)
            if b is not None and b.lo >= 0:
                return [Interval(0, b.hi)]
            if a is not None and a.lo >= 0:
                return [Interval(0, a.hi)]
            return [None]

        if prim in _SUMS:
            return [self._check_sum(op, prim, a)]

        if prim in _PRODUCTS:
            return [self._check_dot(op, prim, in_vals)]

        if prim == "copy":
            return [b]

        if prim in _PROPAGATE:
            return [a] * n_out

        if prim in _JOIN:
            vals = [v for v in in_vals if isinstance(v, Interval)]
            if len(vals) == len(in_vals) and vals:
                out = vals[0]
                for v in vals[1:]:
                    out = out.hull(v)
                return [out] + [None] * (n_out - 1)
            return [None] * n_out

        return [None] * n_out

    # -- accumulation checks ----------------------------------------------
    def _record(self, kind, op, bound, out_dtype, detail):
        cap = exact_capacity(out_dtype)
        if cap is not None and bound > cap:
            self.sites.append(OverflowSite(
                kind=kind, where=_src(op), bound=int(bound), capacity=cap,
                accum=_dtype_name(out_dtype), detail=detail))

    def _check_sum(self, op, prim, a: Optional[Interval]
                   ) -> Optional[Interval]:
        if a is None:
            return None
        shape = op.ins[0].shape
        if prim == "sum":
            dims = op.args[1] if len(op.args) > 1 else None
            if dims is None or (isinstance(dims, (list, tuple))
                                and not dims):
                dims = range(len(shape))
            elif isinstance(dims, int):
                dims = (dims,)
            extent = math.prod(shape[d] for d in dims) if shape else 1
        else:                                          # cumsum
            extent = shape[op.args[1]] if shape else 1
        extent = max(int(extent), 1)
        out_dtype = op.outs[0].dtype
        bound = a.mag * extent
        if a.integral or _is_int(out_dtype):
            self._record(prim, op, bound, out_dtype,
                         f"|x| <= {a.mag} summed over {extent}")
        # covers both the full sum and every cumsum prefix
        return Interval(min(a.lo, 0) * extent, max(a.hi, 0) * extent,
                        a.integral)

    def _check_dot(self, op, prim, in_vals) -> Optional[Interval]:
        tensors = [(x, v) for x, v in zip(op.ins, in_vals)
                   if isinstance(x, walker.TensorInfo)]
        if prim in ("addmm", "baddbmm"):
            tensors = tensors[1:]                      # the bias
        if len(tensors) < 2:
            return None
        (lhs, a), (rhs, b) = tensors[0], tensors[1]
        if a is None or b is None:
            return None
        if prim == "convolution":
            extent = math.prod(rhs.shape[1:])          # C_in/groups x taps
        else:
            extent = lhs.shape[-1]
        extent = max(int(extent), 1)
        out_dtype = op.outs[0].dtype
        bound = a.mag * b.mag * extent
        if (a.integral and b.integral) or _is_int(out_dtype):
            self._record(prim, op, bound, out_dtype,
                         f"|lhs| <= {a.mag}, |rhs| <= {b.mag}, K = {extent}")
        if a.integral and b.integral:
            return Interval(-bound, bound)
        return None

    # -- kernel boundary --------------------------------------------------
    def kernel(self, k, in_vals, ctx):
        self.sites.extend(check_kernel_site(k))
        return [_kernel_out_interval(k, t) for t in k.outs]


def _kernel_out_interval(k: walker.Kernel, t: walker.TensorInfo
                         ) -> Optional[Interval]:
    rng = _dtype_interval(t.dtype)
    if rng is None:
        return None
    if k.name in _QUANTIZE and k.static.get("limbs"):
        # fused limb split: balanced base-2⁷ digit planes, |digit| <= 64
        return Interval(-_MATMUL_DIGIT, _MATMUL_DIGIT)
    return rng


def check_kernel_site(k: walker.Kernel) -> List[OverflowSite]:
    """Structural worst-case check of one kernel call's int32
    accumulators, from its ``Kernel`` event."""
    name = k.name
    sites: List[OverflowSite] = []

    def add(bound, detail):
        if bound > _INT32_MAX:
            sites.append(OverflowSite(kind="kernel", where=name,
                                      bound=int(bound), capacity=_INT32_MAX,
                                      accum="int32", detail=detail))

    if name.startswith("bfp_matmul"):
        K = int(k.static["K"])
        add(_MATMUL_DIGIT * _MATMUL_DIGIT * K,
            f"limb-pair int32 accumulator: 64² x K={K}")
    elif name.startswith("int_attn"):
        # every in-kernel integer dot (QKᵀ digit pairs, P·V planes,
        # dS·K / dSᵀ·Q / Pᵀ·dO in the backward) accumulates balanced digit
        # products in int32 over its contraction: the P / dS planes are
        # <= 2^7 in magnitude, the limb side <= 64 — 128·64·K each
        for K in k.static["K"]:
            add(_NORM_DIGIT * _MATMUL_DIGIT * int(K),
                f"attention digit-pair int32 accumulator: 128·64 x K={K}")
    elif name in _NORMS:
        bits, D, R = int(k.static["bits"]), int(k.static["D"]), \
            int(k.static["R"])
        m = 2 ** (bits - 1)
        add(m * D, f"Σx over D={D} of {bits}-bit mantissas")
        add(_NORM_DIGIT * _NORM_DIGIT * D,
            f"digit-split Σx² partial: 128² x D={D}")
        if name.endswith("bwd"):
            add(m * R, f"dbeta Σg over row block (<= {R} rows)")
    return sites


def check_trace(trace: walker.Trace) -> List[OverflowSite]:
    """All overflow sites of a recorded trace: interval propagation over
    the ops outside the kernels plus the kernels' structural checks."""
    sem = IntervalSemantics()
    walker.interpret(trace, sem)
    return sem.sites
