"""ModelConfig — the port's copy of :mod:`repro.models.config`.

The fields and ``reduced()`` are the reference's, so one config describes
the same model in both packages; ``pdtype``/``cdtype`` return
:class:`torch.dtype` instead of JAX dtypes.  The dry-run shape table
(``ShapeSpec``/``SHAPES``) is not ported: nothing in the port lowers cells.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | hybrid | vlm | audio | moe
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # attention details
    qkv_bias: bool = False
    attn_window: int = 0  # 0 = full attention; >0 = sliding window
    rope: str = "standard"  # standard | half (chatglm 2d) | mrope | none
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, ...] = ()

    # norms / activations
    norm: str = "rmsnorm"  # rmsnorm | layernorm | nonparam_ln
    act: str = "swiglu"  # swiglu | gelu | geglu
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001

    # SSM (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4

    # hybrid (hymba): attention and SSM heads run in parallel per block
    hybrid: bool = False

    # encoder-decoder (seamless-m4t)
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0

    # modality frontend stub: the backbone consumes precomputed embeddings
    frontend: str = "none"  # none | patch_stub | audio_stub

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    # paper integration: route the embedding lookup through async_query
    query_embedding: bool = False

    # activation checkpointing policy for scan-over-layers
    remat: bool = True

    # chunked attention in the reference (same math, bounded memory)
    attn_chunk: int = 0

    # ----------------------------------------------------------------- derived
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.family == "ssm"

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    # ------------------------------------------------------------- reduction
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests (the reference's)."""
        scale = dict(
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            remat=False,
            param_dtype="float32",
            compute_dtype="float32",
        )
        if self.is_moe:
            scale.update(n_experts=4, n_shared_experts=min(self.n_shared_experts, 1),
                         top_k=2, moe_d_ff=32,
                         first_dense_layers=min(self.first_dense_layers, 1))
        if self.family in ("ssm", "hybrid"):
            scale.update(ssm_state=8, ssm_heads=4, ssm_head_dim=8, ssm_chunk=8)
        if self.is_encoder_decoder:
            scale.update(n_enc_layers=2)
        if self.attn_window:
            scale.update(attn_window=16)
        if self.mrope_sections:
            scale.update(mrope_sections=(2, 3, 3))
        return dataclasses.replace(self, name=self.name + "-reduced", **scale)
