"""Architecture registry: ``--arch <id>`` -> ArchConfig, ``--quant <name>``
-> QuantConfig or QuantPolicy.

Counterpart of ``repro/configs/registry.py``.  ``ARCH_IDS`` lists every
architecture the reference knows; only ``PORTED`` ones have a config here,
and asking for another raises ``NotImplementedError``.
"""
from __future__ import annotations

import importlib

from repro_torch.core import qpolicy
from repro_torch.models.config import ArchConfig

ARCH_IDS = ("zamba2-2.7b", "qwen1.5-0.5b", "mistral-nemo-12b", "smollm-135m",
            "mistral-large-123b", "llava-next-mistral-7b", "mixtral-8x7b",
            "qwen2-moe-a2.7b", "mamba2-370m", "whisper-large-v3")

#: arch id -> config module of the archs this port runs: every family of
#: the reference (the decoder-only dense, MoE, SSM, hybrid and VLM ones
#: through ``models/lm.py``, the enc-dec one through ``models/encdec.py``)
PORTED = {
    "qwen1.5-0.5b": "qwen1p5_0p5b",
    "smollm-135m": "smollm_135m",
    "qwen2-moe-a2.7b": "qwen2_moe_a2p7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "mistral-large-123b": "mistral_large_123b",
    "mamba2-370m": "mamba2_370m",
    "zamba2-2.7b": "zamba2_2p7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "whisper-large-v3": "whisper_large_v3",
}


#: archs whose params + optimizer exceed ~8 GB a device without FSDP
FSDP_ARCHS = frozenset({
    "mistral-nemo-12b", "mistral-large-123b", "llava-next-mistral-7b",
    "mixtral-8x7b", "qwen2-moe-a2.7b", "zamba2-2.7b", "whisper-large-v3",
})


def use_fsdp(arch: str) -> bool:
    return arch in FSDP_ARCHS


def get_config(arch: str) -> ArchConfig:
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(ARCH_IDS)}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet; have {sorted(PORTED)}")
    return importlib.import_module(
        f"repro_torch.configs.{PORTED[arch]}").CONFIG


def get_quant(name: str):
    """``--quant <name>`` -> QuantConfig (uniform presets) or QuantPolicy
    (path-scoped presets like ``int8_embed16``)."""
    return qpolicy.get(name)
