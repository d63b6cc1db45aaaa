"""Architecture registry for the port: all ten configurations.

Port of :mod:`repro.models.registry`: ``get_arch(name)`` returns an
:class:`Arch` bundling the config with its init, training forward,
prefill, cache and one-token decode functions, dispatched by family as in
the reference: the encoder-decoder (seamless-m4t) to
:mod:`repro_torch.models.encdec`, a frontend config (qwen2-vl's patch
stub) to ``embeds=`` with its M-RoPE ``positions``, everything else to
:mod:`repro_torch.models.transformer` (the serving engines call
``transformer.prefill`` themselves, as in the reference).  ``forward``,
the training forward, runs all ten.  ``input_specs(shape)`` gives the
inputs of a dry-run cell as meta tensors (shapes and dtypes, no data).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch

from repro_torch.models import encdec as _encdec
from repro_torch.models import transformer as _tf
from repro_torch.models.config import ModelConfig, ShapeSpec

__all__ = ["Arch", "get_arch", "list_archs", "ARCH_IDS"]

ARCH_IDS = [
    "chatglm3-6b",
    "olmo-1b",
    "llama3-8b",
    "qwen1.5-4b",
    "mamba2-1.3b",
    "hymba-1.5b",
    "qwen2-vl-2b",
    "seamless-m4t-medium",
    "deepseek-moe-16b",
    "kimi-k2-1t-a32b",
]


@dataclasses.dataclass
class Arch:
    cfg: ModelConfig

    def init(self, seed: int = 0, device="cuda") -> dict:
        if self.cfg.is_encoder_decoder:
            return _encdec.init_params_encdec(self.cfg, seed, device)
        return _tf.init_params(self.cfg, seed, device)

    def forward(self, params: dict, batch: dict):
        """Training forward → (logits, aux)."""
        cfg = self.cfg
        if cfg.is_encoder_decoder:
            return _encdec.forward_encdec(cfg, params, batch["src_embeds"],
                                          batch["tgt_tokens"])
        if cfg.frontend != "none":
            return _tf.forward(cfg, params, embeds=batch["embeds"],
                               positions=batch.get("positions"))
        return _tf.forward(cfg, params, batch["tokens"])

    def labels_of(self, batch: dict):
        return batch["labels"]

    def prefill(self, params: dict, batch: dict, max_len: Optional[int] = None):
        """(logits (B, V) at the last position, cache) of a batch of
        tokens, of a frontend's embeddings and positions, or of an
        encoder-decoder's source embeddings and target tokens."""
        cfg = self.cfg
        if cfg.is_encoder_decoder:
            return _encdec.prefill_encdec(cfg, params, batch["src_embeds"],
                                          batch["tgt_tokens"], max_len=max_len)
        if cfg.frontend != "none":
            return _tf.prefill(cfg, params, embeds=batch["embeds"],
                               positions=batch.get("positions"), max_len=max_len)
        return _tf.prefill(cfg, params, batch["tokens"], max_len=max_len)

    def init_cache(self, batch: int, max_len: int, device="cuda",
                   src_len: Optional[int] = None) -> dict:
        if self.cfg.is_encoder_decoder:
            return _encdec.init_cache_encdec(self.cfg, batch, max_len, src_len or max_len,
                                             device)
        return _tf.init_cache(self.cfg, batch, max_len, device)

    def decode_step(self, params: dict, token, cache: dict, lengths):
        if self.cfg.is_encoder_decoder:
            return _encdec.decode_step_encdec(self.cfg, params, token, cache, lengths)
        return _tf.decode_step(self.cfg, params, token, cache, lengths)

    def input_specs(self, shape: ShapeSpec) -> dict:
        """Meta-tensor stand-ins for every model input of this cell (the
        reference's ``ShapeDtypeStruct``s): a train cell's batch, a prefill
        cell's, or a decode cell's token, cache of ``seq_len`` and lengths."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        i32 = torch.int32

        def sds(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            train = shape.kind == "train"
            if cfg.is_encoder_decoder:
                # src frames + tgt tokens, each seq_len/2: the cell's B x S
                s2 = S // 2
                batch = {"src_embeds": sds((B, s2, cfg.d_model), cfg.cdtype),
                         "tgt_tokens": sds((B, s2), i32)}
                if train:
                    batch["labels"] = sds((B, s2), i32)
                return batch
            if cfg.frontend != "none":
                batch = {"embeds": sds((B, S, cfg.d_model), cfg.cdtype)}
                if train:
                    batch["labels"] = sds((B, S), i32)
                if cfg.rope == "mrope":
                    batch["positions"] = sds((3, B, S), i32)
                return batch
            batch = {"tokens": sds((B, S), i32)}
            if train:
                batch["labels"] = sds((B, S), i32)
            return batch
        # decode: one new token against a cache of S
        cache = self.init_cache(B, S, device="meta",
                                src_len=(S // 2 if cfg.is_encoder_decoder else None))
        return {"token": sds((B,), i32), "cache": cache, "lengths": sds((B,), i32)}

    def shapes(self):
        return self.cfg.shapes()


def get_arch(name: str) -> Arch:
    """The :class:`Arch` of a configuration in ``repro_torch.configs``."""
    mod_name = name.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return Arch(cfg=mod.CONFIG)


def list_archs() -> list[str]:
    """The names :func:`get_arch` takes, in :data:`ARCH_IDS` order."""
    return list(ARCH_IDS)
