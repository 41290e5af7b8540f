"""whisper-large-v3 [arXiv:2212.04356] — enc-dec backbone.

The conv audio frontend is a STUB: input_specs provides precomputed frame
embeddings (B, 1500, d_model).  Decoder cells exercise self-attn KV cache
+ cross-attn over the encoder output."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    model=ModelConfig(
        name="whisper-large-v3", family="audio",
        n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
        d_ff=5120, vocab_size=51866,
        encoder_layers=32, encoder_seq=1500,
        frontend="audio_stub",
        norm="layernorm", pos="learned", mlp="gelu"),
    optimizer="adamw",
)
