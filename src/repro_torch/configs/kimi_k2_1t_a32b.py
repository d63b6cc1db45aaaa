"""kimi-k2-1t-a32b [arXiv:2501.kimi2, paper-table] — trillion-parameter
MoE: 384 routed experts top-8 + 1 shared (expert d_ff=2048), 61 layers,
d_model=7168, GQA kv=8 (assignment-specified attention; the release uses
MLA — see DESIGN.md §Arch-applicability), first layer dense."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=18432, vocab_size=163840, head_dim=112,
    norm="rmsnorm", act="swiglu", rope="standard", rope_theta=50_000.0,
    n_experts=384, n_shared_experts=1, top_k=8, moe_d_ff=2048,
    first_dense_layers=1,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
