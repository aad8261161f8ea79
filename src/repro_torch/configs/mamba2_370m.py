"""mamba2-370m — attention-free SSD [arXiv:2405.21060; unverified].

Counterpart of ``repro/configs/mamba2_370m.py``.  48 Mamba2 layers of
d_inner 2048 (32 SSD heads of 64, state 128, a 4-tap depthwise conv); the
tied head reads the 50,280-token embedding (padded to 50,432 rows).  About
0.37 B parameters: the FP32 weights fit one card at full depth for
training and serving.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4,
    subquadratic=True,
)
