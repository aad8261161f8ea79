"""llava-next-mistral-7b — VLM, anyres tiling stub [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

Counterpart of ``repro/configs/llava_next_mistral_7b.py``.  The vision
tower is a stub, as in the reference: the caller hands in precomputed
patch embeddings (anyres tiling: base 576 patches + 4 tiles of 576 = a
2880-row prefix); the multimodal projector (``mm_proj``) and the
mistral-7b backbone (32 layers, 32 heads over 8 kv heads of 128) are
real.  The reference lists this arch in its registry's ``FSDP_ARCHS``; so
does the port, and ``launch.train`` under ``torchrun`` trains it with
FSDP, each layer gathered inside the layer loop: a rank holds 11.4 GB of
FP32 parameters and gradients during a step at data 8, 4.3 GB on the 16 x
16 production mesh (``tools/fsdp_footprint.py``).  About 7.2 B parameters
(29 GB of FP32).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, head_dim=128,
    frontend="vision_stub", vlm_prefix=2880,
)
