"""qwen2-vl-2b [arXiv:2409.12191; hf:Qwen/Qwen2-VL-2B] — VLM backbone with
M-RoPE (temporal/height/width sections); the vision frontend is a STUB:
input_specs() provides precomputed patch embeddings + 3D position ids."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab_size=151936, head_dim=128,
    qkv_bias=True, rope="mrope", rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    norm="rmsnorm", act="swiglu", tie_embeddings=True,
    frontend="patch_stub",
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
