"""quantlint — static analysis of the integer-training invariants over a
recorded trace of the port's step.

Counterpart of ``repro/analysis``.  The analyzer proves, on the recorded
forward and backward of one step, the properties the paper's recipe
depends on (DESIGN.md §5):

* integer closure — the mantissa arithmetic stays inside the kernels (no
  ``rsqrt`` / limb-split ``rem`` / ``div`` outside a kernel wrapper, no
  product over integer mantissas outside one),
* PRNG key discipline — no two stochastic-rounding draws start from one
  generator state (a remat recompute's replay is the forward's draw),
* policy hygiene — no dead or shadowed ``QuantPolicy`` rules, no unscoped
  call sites under a scoped policy,
* dispatch budget — kernel calls per call at or below
  ``analysis/dispatch_baseline.json``,
* stability — no resolved scope lands in the Fig. 4 divergence regime,
* accumulator budget — no product/reduction site whose worst-case
  mantissa magnitude overflows its accumulator's exact range,
* wire format — no float all-gather of a tensor the step quantizes,
* kept-op escape — under ``kept_ops="integer"`` no kept transcendental
  runs outside a kernel.

Layout:

* ``walker``   — the recorder and the trace walk every other module builds
  on
* ``rules``    — the QL00x diagnostics registry
* ``budget``   — the interval-arithmetic accumulator-overflow checker
* ``lint``     — the CLI (``python -m repro_torch.analysis.lint``)
* ``dispatch`` — the QL004 gate (``python -m repro_torch.analysis.dispatch``)
"""
from repro_torch.analysis.rules import (ALL_RULES, Finding, run_rules)  # noqa: F401
from repro_torch.analysis.walker import (count_kernels, count_ops,  # noqa: F401
                                         iter_ops, record)
