"""mistral-nemo-12b — dense GQA kv=8, 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407; hf].

Counterpart of ``repro/configs/mistral_nemo_12b.py``.  The reference lists
this arch in its registry's ``FSDP_ARCHS``; so does the port, and
``launch.train`` under ``torchrun`` trains it with FSDP over the data axis
of a mesh, each layer gathered inside the layer loop: a rank holds 13.3 GB
of FP32 parameters and gradients during a step on the 16 x 16 production
mesh, 25.2 GB at data 8 (98-110 GB with every leaf gathered whole;
``tools/fsdp_footprint.py``).  Its attention width (32 heads x 128 = 4096)
differs from d_model (5120), and its head is untied over a 131,072-token
vocabulary.  The FP32 weights (about 12.2 B parameters, 49 GB at full
depth) fit one card for serving; training cuts the depth.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=131072, head_dim=128, rope_theta=1e6,
)
