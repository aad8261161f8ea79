"""smollm-135m — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
    vocab=49152, tie_embeddings=True,
)
