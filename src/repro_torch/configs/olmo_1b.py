"""olmo-1b [arXiv:2402.00838; hf:allenai/OLMo-1B] — dense, MHA (kv=16),
non-parametric LayerNorm, SwiGLU, tied embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=50304, head_dim=128,
    norm="nonparam_ln", act="swiglu", rope="standard", rope_theta=10_000.0,
    tie_embeddings=True,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
