"""qwen2-moe-a2.7b — 60 routed experts top-4 + 4 shared [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

Counterpart of ``repro/configs/qwen2_moe_a2p7b.py``.  The reference lists
this arch in its registry's ``FSDP_ARCHS``; so does the port, and
``launch.train`` under ``torchrun`` trains it with FSDP over the data axis
of a mesh, each layer gathered inside the layer loop: a rank holds 15.9 GB
of FP32 parameters and gradients during a step on the 16 x 16 production
mesh (121 GB with every leaf gathered whole;
``tools/fsdp_footprint.py``).  On one card the FP32 weights (about 14.3 B
parameters, 57 GB at full depth) live whole.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=151936, head_dim=128,
    moe_experts=60, moe_topk=4,
    moe_shared_dff=5632,          # 4 shared experts = 4 x 1408
)
