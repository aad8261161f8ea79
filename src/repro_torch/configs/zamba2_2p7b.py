"""zamba2-2.7b — Mamba2 backbone + shared attention block [arXiv:2411.15242; hf].

Counterpart of ``repro/configs/zamba2_2p7b.py``.  54 Mamba2 layers of
d_inner 5120 (80 SSD heads of 64, state 64); after every 6 of them the one
shared attention block (32 heads of 80, no GQA, a SwiGLU MLP of 10240)
runs, 9 times in all, each with a KV cache of its own at decode.  The
reference lists this arch in its registry's ``FSDP_ARCHS``; so does the
port, and ``launch.train`` under ``torchrun`` trains it with FSDP, each
Mamba2 layer gathered inside the layer loop and the shared block whole: a
rank holds 4.9 GB of FP32 parameters and gradients during a step at data
8, 2.6 GB on the 16 x 16 production mesh (``tools/fsdp_footprint.py``).
About 2.4 B parameters (9.7 GB of FP32).
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, head_dim=80,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_conv=4,
    hybrid_attn_every=6,
    subquadratic=True,     # SSM state is O(1); shared-attn KV is linear in S
)
