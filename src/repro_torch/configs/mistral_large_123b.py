"""mistral-large-123b — dense GQA [hf:mistralai/Mistral-Large-Instruct-2407; unverified].

Counterpart of ``repro/configs/mistral_large_123b.py``, whose source the
reference marks unverified.  The reference lists this arch in its
registry's ``FSDP_ARCHS``; so does the port, and ``launch.train`` under
``torchrun`` trains it with FSDP over the data axis of a mesh, each layer
gathered inside the layer loop: a rank holds 21.4 GB of FP32 parameters
and gradients during a step on the 16 x 16 production mesh, beside 3.9 GB
of FP32 moments (985 GB with every leaf gathered whole;
``tools/fsdp_footprint.py``).  96 query heads share 8 kv heads (12 per
group).  At full depth the FP32 weights (about 123 B parameters, 491 GB)
do not fit one card: runs on it cut the depth, never a width.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=28672,
    vocab=32768, head_dim=128, rope_theta=1e6,
)
