"""qwen1.5-4b [hf:Qwen/Qwen1.5-4B lineage of Qwen/Qwen1.5-0.5B] — dense,
MHA kv=20, QKV bias, SwiGLU, RMSNorm."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20,
    d_ff=6912, vocab_size=151936, head_dim=128,
    qkv_bias=True, norm="rmsnorm", act="swiglu",
    rope="standard", rope_theta=1_000_000.0,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
