"""chatglm3-6b [arXiv:2406.12793; hf:THUDM/chatglm3-6b] — dense, GQA kv=2,
2D (half-dim) RoPE, QKV bias, SwiGLU, RMSNorm."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=65024, head_dim=128,
    qkv_bias=True, rope="half", rope_theta=10_000.0,
    norm="rmsnorm", act="swiglu",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
