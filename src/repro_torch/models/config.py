"""ModelConfig — the port's copy of :mod:`repro.models.config`.

The fields, ``param_count()``, ``active_param_count()`` and ``reduced()``
are the reference's, so one config describes the same model, with the
same counts, in both packages; ``pdtype``/``cdtype`` return
:class:`torch.dtype` instead of JAX dtypes.  The dry-run shape table
(``ShapeSpec``, ``SHAPES``, ``ModelConfig.shapes()``) is the reference's
too: :mod:`repro_torch.launch.dryrun` traces one step per cell.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (input-shape) cell: ``kind`` selects which step gets lowered."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The assigned LM shape set (identical for every arch, with per-family skips).
SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


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

    @property
    def supports_long_context(self) -> bool:
        """long_500k needs sub-quadratic attention: SSM or windowed hybrid."""
        return self.family in ("ssm", "hybrid")

    def shapes(self) -> list[ShapeSpec]:
        out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
        if self.supports_long_context:
            out.append(SHAPES["long_500k"])
        return out

    # ----------------------------------------------------------- param count
    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        hd, nh, nkv = self.hd, self.n_heads, self.n_kv_heads
        att = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        if self.qkv_bias:
            att += (nh + 2 * nkv) * hd
        per_layer = 0
        n_attn_layers = self.n_layers if self.family != "ssm" else 0
        n_moe_layers = max(0, self.n_layers - self.first_dense_layers) if self.is_moe else 0
        n_dense_ff_layers = self.n_layers - n_moe_layers if not self.is_ssm else 0
        # attention + norms
        if self.family != "ssm":
            per_layer += att + 2 * (d if self.norm != "nonparam_ln" else 0)
        # dense FFN
        ff_params = 3 * d * self.d_ff if self.act in ("swiglu", "geglu") else 2 * d * self.d_ff
        n_total = n + n_attn_layers * (att + (2 * d if self.norm != "nonparam_ln" else 0))
        n_total += n_dense_ff_layers * ff_params
        if self.is_moe:
            e_ff = 3 * d * self.moe_d_ff
            n_total += n_moe_layers * (
                self.n_experts * e_ff
                + self.n_shared_experts * e_ff
                + d * self.n_experts  # router
            )
        if self.family in ("ssm", "hybrid"):
            sh, sp, ns = self.ssm_heads, self.ssm_head_dim, self.ssm_state
            d_inner = sh * sp
            ssm = (
                d * (2 * d_inner + 2 * ns + sh)  # in_proj (x, z, B, C, dt)
                + d_inner * d  # out_proj
                + self.ssm_conv * (d_inner + 2 * ns)  # conv
                + 2 * sh  # A_log, D
            )
            n_total += self.n_layers * ssm
        if self.is_encoder_decoder:
            # encoder layers + cross attention in decoder
            enc = self.n_enc_layers * (att + ff_params + 2 * d)
            cross = self.n_layers * att
            n_total += enc + cross
        return int(n_total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        n_moe_layers = max(0, self.n_layers - self.first_dense_layers)
        e_ff = 3 * self.d_model * self.moe_d_ff
        inactive = n_moe_layers * (self.n_experts - self.top_k) * e_ff
        return int(full - inactive)

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
