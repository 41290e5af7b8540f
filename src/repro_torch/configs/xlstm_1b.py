"""xlstm-1.3b [arXiv:2405.04517] — mLSTM blocks with sLSTM every 8th."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    model=ModelConfig(
        name="xlstm-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512,
        d_ff=0, vocab_size=50304,
        slstm_every=8,
        norm="rmsnorm", pos="none", mlp="swiglu",
        seq_parallel_residual=True),
    optimizer="adamw",
    dp_over_model=True,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
