"""hymba-1.5b [arXiv:2411.13676] — hybrid: attention and mamba heads in
PARALLEL within every block (per-branch RMSNorm, mean-combined); GQA kv=5;
sliding-window attention (full-attention layers replaced by SWA for
scan-uniformity — see DESIGN.md §Arch-applicability); SSM state 16."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", hybrid=True,
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    attn_window=1024, rope="standard", rope_theta=10_000.0,
    norm="rmsnorm", act="swiglu",
    ssm_state=16, ssm_heads=25, ssm_head_dim=64, ssm_chunk=256,
    param_dtype="bfloat16", compute_dtype="bfloat16",
)
