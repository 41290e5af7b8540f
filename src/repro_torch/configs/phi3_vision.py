"""phi-3-vision-4.2b [hf:microsoft/Phi-3-vision-128k-instruct].

Backbone only: the CLIP frontend is a STUB — input_specs provides
precomputed patch embeddings (B, n_patches, d_model)."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    model=ModelConfig(
        name="phi-3-vision-4.2b", family="vlm",
        n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, head_dim=96,
        d_ff=8192, vocab_size=32064,
        frontend="vision_stub", n_patches=576,
        norm="rmsnorm", pos="rope", mlp="swiglu"),
    optimizer="adamw",
)
