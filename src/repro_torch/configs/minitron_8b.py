"""minitron-8b [arXiv:2407.14679] — pruned nemotron; 256k vocab."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    model=ModelConfig(
        name="minitron-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=16384, vocab_size=256000,
        norm="rmsnorm", pos="rope", mlp="gelu",
        chunked_loss_chunks=16),
    optimizer="adamw", fsdp=True,
)
