"""Architecture registry for the port (dense and SSM families so far).

Port of :mod:`repro.models.registry`: ``get_arch(name)`` returns an
:class:`Arch` bundling the config with its init, training forward, cache
and one-token decode functions (the serving engine calls
``transformer.prefill`` itself, as in the reference).  ``forward`` runs
the dense family; SSM, MoE, encoder-decoder and frontend archs raise
``NotImplementedError`` there (training mamba2 needs a gradient for
``ssd_scan``).  The dry-run ``input_specs`` and the other families come
with later slices.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models import transformer as _tf
from repro_torch.models.config import ModelConfig

__all__ = ["Arch", "get_arch"]


@dataclasses.dataclass
class Arch:
    cfg: ModelConfig

    def init(self, seed: int = 0, device="cuda") -> dict:
        return _tf.init_params(self.cfg, seed, device)

    def forward(self, params: dict, batch: dict):
        """Training forward → (logits, aux)."""
        cfg = self.cfg
        if (cfg.family != "dense" or cfg.is_moe or cfg.is_encoder_decoder
                or cfg.frontend != "none"):
            raise NotImplementedError(
                f"{cfg.name}: the training forward is ported for the dense family only")
        return _tf.forward(cfg, params, batch["tokens"])

    def labels_of(self, batch: dict):
        return batch["labels"]

    def init_cache(self, batch: int, max_len: int, device="cuda") -> dict:
        return _tf.init_cache(self.cfg, batch, max_len, device)

    def decode_step(self, params: dict, token, cache: dict, lengths):
        return _tf.decode_step(self.cfg, params, token, cache, lengths)


def get_arch(name: str) -> Arch:
    """The :class:`Arch` of a ported configuration (``repro_torch.configs``);
    configurations outside the dense and SSM families raise
    ``NotImplementedError``."""
    mod_name = name.replace("-", "_").replace(".", "_")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    if mod.CONFIG.family not in ("dense", "ssm"):
        raise NotImplementedError(f"{name}: only the dense and SSM families are ported")
    return Arch(cfg=mod.CONFIG)
