"""zamba2-1.2b [arXiv:2411.15242] — Mamba2 backbone + shared attn block."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    model=ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab_size=32000,
        ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
        attn_every=6,
        norm="rmsnorm", pos="rope", mlp="swiglu",
        seq_parallel_residual=True),
    optimizer="adamw",
    dp_over_model=True,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
