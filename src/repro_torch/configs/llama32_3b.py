"""llama3.2-3b [hf:meta-llama/Llama-3.2-*] — small llama3, GQA 24/8."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    model=ModelConfig(
        name="llama3.2-3b", family="dense",
        n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=128256,
        norm="rmsnorm", pos="rope", rope_theta=500000.0, mlp="swiglu",
        tie_embeddings=True),
    optimizer="adamw",
)
