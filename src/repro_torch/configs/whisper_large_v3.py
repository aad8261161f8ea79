"""whisper-large-v3 — enc-dec, conv frontend stub [arXiv:2212.04356; unverified].

Counterpart of ``repro/configs/whisper_large_v3.py``.  32 encoder and 32
decoder layers of d_model 1280 (20 heads of 64, a GELU MLP of 5120,
layer norms); the decoder's head is tied to the 51,866-token embedding
(padded to 51,968 rows) whatever ``tie_embeddings`` says, as in the
reference's ``models/encdec.py``.  The mel + conv frontend is a stub: the
encoder takes precomputed frame embeddings.  About 1.5 B parameters.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120,
    vocab=51866, norm="layernorm", act="gelu",
    enc_dec=True, n_enc_layers=32, frontend="audio_stub",
)
