"""kimi-k2-1t-a32b [arXiv:2501.kimi2] — trillion-param MoE.

The reference trains it with Adafactor (factored second moment) and FSDP
over pod+data: AdamW's float32 states would need about 12 TB."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    model=ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=2048, vocab_size=163840,
        moe_experts=384, moe_top_k=8, moe_d_ff=2048, n_shared_experts=1,
        norm="rmsnorm", pos="rope", mlp="swiglu",
        chunked_loss_chunks=16,
        # the reference's production defaults for its MoE layers
        moe_fused_ep=True, seq_parallel_residual=True,
        moe_combine="reduce_scatter"),
    optimizer="adafactor", fsdp=True,
)
