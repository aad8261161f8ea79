"""vit-base — the paper's image fine-tuning subject (Dosovitskiy et al.
2020; the paper's Table 3).

12L d_model=768 12H d_ff=3072, 224 x 224 images in 16 x 16 patches (196
patches and the class token: 197 tokens), learned positions, pre-LN
encoder with GeLU; the patch embedding is the paper's integer
convolutional layer (``int_ops.int_patch_embed``).  Counterpart of
``repro/configs/vit_base.py``; used by ``chip_smoke.py`` to fine-tune at
full width.
"""
from repro_torch.models.paper_models import vit_config

IMG, PATCH = 224, 16

CONFIG = vit_config(n_layers=12, d_model=768, n_heads=12, d_ff=3072,
                    img=IMG, patch=PATCH, name="vit-base")
