"""mamba2-1.3b [arXiv:2405.21060] — attention-free SSD (state-space
duality), 48 layers, d_state=128, expand=2 (d_inner=4096, 64 heads x 64)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=1, n_kv_heads=1,
    d_ff=0, vocab_size=50280,
    rope="none", norm="rmsnorm", act="swiglu", tie_embeddings=True,
    ssm_state=128, ssm_heads=64, ssm_head_dim=64, ssm_chunk=256,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
