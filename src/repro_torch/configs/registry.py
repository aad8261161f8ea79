"""Architecture registry: ``--arch <id>`` -> ArchConfig, ``--quant <name>``
-> QuantConfig or QuantPolicy, and the inputs of each (arch x shape)
cell.

Counterpart of ``repro/configs/registry.py``.  ``ARCH_IDS`` lists every
architecture the reference knows; only ``PORTED`` ones have a config here,
and asking for another raises ``NotImplementedError``.
"""
from __future__ import annotations

import importlib
from typing import Any, Dict

import torch

from repro_torch.core import qpolicy
from repro_torch.models import encdec, lm
from repro_torch.models.config import SHAPES, ArchConfig, shape_applicable

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


def quant_ids():
    """Every quantization preset a ``--quant`` flag accepts: the paper's
    uniform QuantConfig grid plus the mixed-precision QuantPolicy
    presets."""
    return qpolicy.ALL_PRESETS


# ---------------------------------------------------------------------------
# input specs per (arch, shape)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: str) -> Dict[str, Any]:
    """Meta tensors (shapes and dtypes, no storage) of the entry point
    ``shape`` selects, as the reference's ``ShapeDtypeStruct``s:

    train:   the batch a train step takes
    prefill: the prompt batch of ``lm_prefill`` (enc-dec: ``encode``)
    decode:  one token per row and a ``seq_len``-deep cache (bfloat16 k / v,
             as the reference's) for ``lm_decode_step``; the enc-dec's also
             every layer's bfloat16 cross K/V
    """
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape}: {why}")
    S, B, kind = SHAPES[shape]
    i32, f32 = torch.int32, torch.float32

    if kind == "train":
        if cfg.enc_dec:
            return {"frames": _meta((B, S, cfg.d_model), f32),
                    "tokens": _meta((B, S), i32),
                    "labels": _meta((B, S), i32)}
        batch = {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}
        if cfg.vlm_prefix:
            batch["tokens"] = _meta((B, S - cfg.vlm_prefix), i32)
            batch["labels"] = _meta((B, S - cfg.vlm_prefix), i32)
            batch["patch_embeds"] = _meta((B, cfg.vlm_prefix, cfg.d_model),
                                          f32)
        return batch

    if kind == "prefill":
        if cfg.enc_dec:
            return {"frames": _meta((B, S, cfg.d_model), f32),
                    "tokens": _meta((B, S), i32)}
        batch = {"tokens": _meta((B, S), i32)}
        if cfg.vlm_prefix:
            batch["tokens"] = _meta((B, S - cfg.vlm_prefix), i32)
            batch["patch_embeds"] = _meta((B, cfg.vlm_prefix, cfg.d_model),
                                          f32)
        return batch

    # decode: one new token against a seq_len-deep cache
    spec: Dict[str, Any] = {"token": _meta((B, 1), i32)}
    if cfg.enc_dec:
        spec["cache"] = encdec.encdec_init_cache(cfg, B, S, device="meta")
        KV, hd = cfg.n_kv_heads, cfg.head_dim
        spec["cross_kv"] = (
            _meta((cfg.n_layers, B, S, KV, hd), torch.bfloat16),
            _meta((cfg.n_layers, B, S, KV, hd), torch.bfloat16))
    else:
        spec["cache"] = lm.init_cache(cfg, B, S, dtype=torch.bfloat16,
                                      device="meta")
    return spec
