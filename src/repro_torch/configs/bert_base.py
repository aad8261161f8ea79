"""bert-base — the paper's primary fine-tuning subject (Devlin et al. 2018).

12L d_model=768 12H d_ff=3072 vocab=30522, learned positions, pre-LN
encoder with GeLU; integer layers per the paper.  Counterpart of
``repro/configs/bert_base.py``; used by ``chip_smoke.py`` to fine-tune at
full width (the reference's registry does not list it either).
"""
from repro_torch.models.paper_models import bert_config

CONFIG = bert_config(n_layers=12, d_model=768, n_heads=12, d_ff=3072,
                     vocab=30522, name="bert-base")
