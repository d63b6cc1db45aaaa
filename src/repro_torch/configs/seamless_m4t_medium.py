"""seamless-m4t-medium [arXiv:2308.11596] — encoder-decoder, multimodal;
the audio frontend is a STUB (precomputed frame embeddings feed the
encoder).  LayerNorm + GELU, MHA kv=16, 256k vocab."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium", family="audio",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=256206, head_dim=64,
    norm="layernorm", act="gelu", rope="standard", rope_theta=10_000.0,
    is_encoder_decoder=True, n_enc_layers=12,
    frontend="audio_stub",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
