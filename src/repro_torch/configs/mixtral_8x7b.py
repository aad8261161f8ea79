"""mixtral-8x7b — 8-expert top-2 MoE, SWA [arXiv:2401.04088; hf].

Counterpart of ``repro/configs/mixtral_8x7b.py``.  The reference lists
this arch in its registry's ``FSDP_ARCHS``; so does the port, and
``launch.train`` under ``torchrun`` trains it with FSDP over the data axis
of a mesh, each layer gathered inside the layer loop.  A rank then holds
36.3 GB of FP32 parameters and gradients during a step on the 16 x 16
production mesh (396 GB with every leaf gathered whole), and 22.6 GB of
FP32 moments (``tools/fsdp_footprint.py``): its expert stacks shard over
the model axis only.  At full depth the FP32 weights (about 46.7 B
parameters, 187 GB) do not fit one card: runs on it cut the depth, never a
width.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, head_dim=128, sliding_window=4096,
    moe_experts=8, moe_topk=2,
)
