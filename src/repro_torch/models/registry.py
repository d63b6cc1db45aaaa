"""Architecture registry for the port (dense and SSM families so far).

Port of :mod:`repro.models.registry`: ``get_arch(name)`` returns an
:class:`Arch` bundling the config with its init, cache and one-token decode
functions (the serving engine calls ``transformer.prefill`` itself, as in
the reference).
The dry-run ``input_specs`` and the other families come with later slices.
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
