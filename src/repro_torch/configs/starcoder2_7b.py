"""starcoder2-7b [arXiv:2402.19173] — GQA 36/4, RoPE, LayerNorm, GELU."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    model=ModelConfig(
        name="starcoder2-7b", family="dense",
        n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, head_dim=128,
        d_ff=18432, vocab_size=49152,
        norm="layernorm", pos="rope", mlp="gelu"),
    optimizer="adamw", fsdp=True,
)
