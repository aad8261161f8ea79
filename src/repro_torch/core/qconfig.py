"""Quantization configuration for b-bit dynamic fixed-point (DFX) layers.

Counterpart of ``repro/core/qconfig.py``: the same fields (minus
``backend``), presets and ``StabilityWarning``.  The port reads no
environment variable: the device of the tensors decides where a kernel runs
(CUDA kernel on the card, its plain PyTorch version on the CPU), so there is
no backend switch, and ``kept_ops`` defaults to the paper's ``"fp32"``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional


class StabilityWarning(UserWarning):
    """The paper's empirical stability constraint is violated: Figure 4
    shows w8·a8·g8 diverging while w8·a12·g8 tracks FP32 — 8-bit weights
    need >= 12-bit activations."""


def stability_violated(cfg: "QuantConfig") -> bool:
    """8-bit weights need >= 12-bit activations (paper, Fig. 4)."""
    return cfg.enabled and cfg.weight_bits == 8 and cfg.act_bits < 12


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static configuration of the b-bit dynamic fixed-point mapping."""

    enabled: bool = True
    weight_bits: int = 16
    act_bits: int = 16
    grad_bits: int = 16
    #: stochastic rounding for gradient quantization (training only).
    stochastic_grad: bool = True
    #: also stochastically round the forward mappings (off in the paper).
    stochastic_fwd: bool = False
    #: per-block scales are not supported by the integer kernels.
    block_size: Optional[int] = None
    #: quantize the norm statistics path (paper: yes).
    int_layernorm: bool = True
    #: quantize embedding tables / lookups (paper: yes).
    int_embedding: bool = True
    #: "fp32" keeps softmax exp / SiLU / rsqrt in FP32 (the paper's
    #: setting); "integer" swaps them for the Q.14 fixed-point forms of
    #: ``core/iapprox.py`` (in-kernel for the norms and attention).
    kept_ops: str = "fp32"
    warn_stability: bool = True

    def __post_init__(self):
        for name in ("weight_bits", "act_bits", "grad_bits"):
            b = getattr(self, name)
            if not (2 <= b <= 24):
                raise ValueError(f"{name}={b} outside supported range [2, 24]")
        if self.warn_stability and stability_violated(self):
            warnings.warn(
                f"weight_bits=8 with act_bits={self.act_bits} < 12 violates "
                "the paper's stability constraint (Fig. 4: w8-a8-g8 diverges "
                "while w8-a12-g8 matches FP32); pass warn_stability=False to "
                "silence", StabilityWarning, stacklevel=2)
        if self.block_size is not None:
            raise ValueError("the integer kernels support per-tensor scales "
                             "only (block_size must be None)")
        if self.kept_ops not in ("fp32", "integer"):
            raise ValueError(
                f"kept_ops={self.kept_ops!r} not in ('fp32', 'integer')")

    # -- presets matching the paper's experimental grid -------------------
    @staticmethod
    def fp32() -> "QuantConfig":
        """FP32 baseline (quantization disabled)."""
        return QuantConfig(enabled=False)

    @staticmethod
    def int16() -> "QuantConfig":
        return QuantConfig(weight_bits=16, act_bits=16, grad_bits=16)

    @staticmethod
    def int12() -> "QuantConfig":
        return QuantConfig(weight_bits=12, act_bits=12, grad_bits=12)

    @staticmethod
    def int10() -> "QuantConfig":
        return QuantConfig(weight_bits=10, act_bits=10, grad_bits=10)

    @staticmethod
    def int8() -> "QuantConfig":
        """Paper's headline low-bit setting: int8 weights/grads, int12 acts."""
        return QuantConfig(weight_bits=8, act_bits=12, grad_bits=8)

    @staticmethod
    def int8_naive() -> "QuantConfig":
        """w8 a8 g8 — the diverging configuration of Figure 4."""
        return QuantConfig(weight_bits=8, act_bits=8, grad_bits=8)

    @staticmethod
    def preset(name: str):
        """Config preset by name; policy-preset names return a
        ``QuantPolicy``."""
        table = {
            "fp32": QuantConfig.fp32,
            "int16": QuantConfig.int16,
            "int12": QuantConfig.int12,
            "int10": QuantConfig.int10,
            "int8": QuantConfig.int8,
            "int8_naive": QuantConfig.int8_naive,
        }
        if name in table:
            return table[name]()
        from repro_torch.core import qpolicy  # lazy: qpolicy imports this
        if name in qpolicy.POLICY_PRESETS:
            return qpolicy.preset(name)
        raise KeyError(f"unknown quant preset {name!r}; have "
                       f"{sorted(table) + sorted(qpolicy.POLICY_PRESETS)}")


PRESETS = ("fp32", "int16", "int12", "int10", "int8", "int8_naive")
