"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU path.

* importing every module of ``repro_torch`` (in a fresh interpreter)
  loads neither ``jax`` nor any module of ``repro``, and builds no kernel;
* no source line of the port or of ``chip_smoke.py`` imports them;
* an entry point left at its default device raises ``RuntimeError`` when
  CUDA is absent, instead of running on the CPU;
* ``chip_smoke.py`` exits non-zero, printing no result, without a card
  and without the rest of the checkout.
"""
from __future__ import annotations

import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import device as device_mod
from repro_torch.kernels import build
from repro_torch.models import encdec, transformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import get_arch
from repro_torch.serving.paged_kv import PagedInferenceEngine

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORTS = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_torch)|from\s+(jax|repro)\b(?!_torch))",
                      re.MULTILINE)


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(extra)
    return env


def test_importing_every_module_loads_no_jax_and_no_repro():
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "built = importlib.import_module('repro_torch.kernels.build')._libs\n"
        "print(len(mods), bad, built)\n"
        "sys.exit(1 if bad or built or len(mods) < 20 else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")] + ["chip_smoke.py"]))
def test_source_imports_neither_jax_nor_repro(path):
    text = (ROOT / path).read_text()
    assert not _IMPORTS.findall(text), path


def test_every_kernel_source_is_built():
    assert set(build.SOURCES) == {p.stem for p in (PORT / "csrc").glob("*.cu")}


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    cfg = get_arch("llama3-8b").cfg.reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_mod.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        transformer.init_cache(cfg, 2, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros(3, np.float32)}, cfg)
    ed = get_arch("seamless-m4t-medium").cfg.reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        encdec.init_params_encdec(ed)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        encdec.init_cache_encdec(ed, 2, 16, 8)
    arch = dataclasses.replace(get_arch("llama3-8b"), cfg=cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        arch.init(seed=0)
    params = arch.init(seed=0, device="cpu")  # the explicit CPU path works
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedInferenceEngine(arch, params, n_lanes=2, max_prompt_len=8, max_len=16,
                             page_size=8)
    eng = PagedInferenceEngine(arch, params, n_lanes=2, max_prompt_len=8, max_len=16,
                               page_size=8, device="cpu")
    assert eng.device == torch.device("cpu")


def test_train_launcher_default_device_raises_without_cuda(no_cuda, tmp_path):
    """The training launcher and a restore onto its default device refuse
    to run without CUDA; ``--device cpu`` trains and checkpoints."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train

    argv = ["--arch", "mamba2-1.3b", "--reduced", "--steps", "1", "--batch", "2",
            "--seq", "8", "--ckpt-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(argv)
    out = train.main(argv + ["--device", "cpu"])
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
    with CheckpointManager(tmp_path) as mgr:
        assert mgr.latest_step() == 1


def test_engine_refuses_params_on_another_device():
    cfg = get_arch("llama3-8b").cfg.reduced()
    arch = dataclasses.replace(get_arch("llama3-8b"), cfg=cfg)
    params = arch.init(seed=0, device="cpu")
    params["embed"]["table"] = params["embed"]["table"].to("meta")
    with pytest.raises(ValueError, match="params live on"):
        PagedInferenceEngine(arch, params, n_lanes=2, max_prompt_len=8, max_len=16,
                             page_size=8, device="cpu")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No card (CUDA hidden), or only the script without the checkout:
    exit non-zero and print no result line."""
    script, cwd, env = ROOT / "chip_smoke.py", ROOT, _env(CUDA_VISIBLE_DEVICES="")
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd, env = tmp_path / "chip_smoke.py", tmp_path, _env()
    env.pop("PYTHONPATH")
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
