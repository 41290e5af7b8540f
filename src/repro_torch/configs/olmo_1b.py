"""olmo-1b [arXiv:2402.00838] — non-parametric LayerNorm, tied embeddings."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    model=ModelConfig(
        name="olmo-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=8192, vocab_size=50304,
        norm="nonparametric", pos="rope", mlp="swiglu",
        tie_embeddings=True),
    optimizer="adamw",
)
