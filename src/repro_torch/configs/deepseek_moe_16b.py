"""deepseek-moe-16b [arXiv:2401.06066] — fine-grained MoE: 64 routed
experts top-6 + 2 shared experts (expert d_ff=1408), first layer dense
(d_ff=10944), MHA kv=16."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=10944, vocab_size=102400, head_dim=128,
    norm="rmsnorm", act="swiglu", rope="standard", rope_theta=10_000.0,
    n_experts=64, n_shared_experts=2, top_k=6, moe_d_ff=1408,
    first_dense_layers=1,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
