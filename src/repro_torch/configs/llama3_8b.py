"""llama3-8b [arXiv:2407.21783] — dense, GQA kv=8, 128k vocab,
RoPE theta=500k, SwiGLU, RMSNorm."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128256, head_dim=128,
    norm="rmsnorm", act="swiglu", rope="standard", rope_theta=500_000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
