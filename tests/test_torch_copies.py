"""The port's pure-Python modules are the JAX package's, line for line.

``repro_torch`` may import nothing of ``repro``, so it keeps its own copy
of every pure-Python module it needs, with only the imports rewritten
(``repro.`` -> ``repro_torch.``).  Each copy, with ``repro_torch`` read
back as ``repro``, must equal the reference module exactly, apart from the
notes the port adds and names here.  ``core/services.py`` is a copy up to
``ModelService``, which the port rewrites in PyTorch.
"""
from __future__ import annotations

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
PORT = ROOT / "src" / "repro_torch"

# Text the port adds to a copy, by module: removed before the comparison.
NOTES = {
    "core/loop_context.py": [
        "The port's copy of :mod:`repro.core.loop_context` (pure Python, kept\n"
        "verbatim so that the port imports nothing of the JAX package).\n\n"],
    "core/services.py": [
        "  (In this package the callable is PyTorch: ``batch_fn`` defaults to\n"
        "  ``torch.func.vmap(single_fn)`` and nothing is compiled.)\n",
        '    "torch_block",\n'],
}

VERBATIM = [
    # copies that came with the serving and trainer slices
    "serving/scheduler.py", "serving/request.py", "serving/kv.py",
    "core/strategies.py", "core/lane_policy.py", "core/concurrency.py",
    "core/resilience.py", "core/loop_context.py",
    # the paper's transformation and runtime layer
    "core/hir.py", "core/runtime.py", "core/runtime_baseline.py", "core/faults.py",
    "core/equivalence.py", "core/app_traces.py", "serving/hir_bridge.py",
]


def _port_text(rel: str) -> str:
    text = (PORT / rel).read_text()
    for note in NOTES.get(rel, ()):
        assert text.count(note) == 1, f"{rel}: note not found once: {note!r}"
        text = text.replace(note, "")
    return text.replace("repro_torch", "repro")


@pytest.mark.parametrize("rel", VERBATIM)
def test_copy_equals_reference(rel):
    assert _port_text(rel) == (REF / rel).read_text()


def test_services_equal_reference_up_to_model_service():
    marker = "class ModelService(_StatsMixin):"
    port = _port_text("core/services.py")
    ref = (REF / "core/services.py").read_text()
    assert port.split(marker)[0] == ref.split(marker)[0]
    # the rewritten tail keeps the reference's public names, torch_block for jax_block
    tail = port.split(marker)[1]
    for name in ("def execute(", "def execute_batch(", "def execute_batch_async(",
                 "def torch_block("):
        assert name in tail
    assert "jax" not in tail.replace("JAX", "")


@pytest.mark.parametrize("rel", VERBATIM + ["core/services.py"])
def test_copy_imports_only_the_port(rel):
    for line in (PORT / rel).read_text().splitlines():
        s = line.strip()
        if s.startswith(("from repro", "import repro")):
            assert s.startswith(("from repro_torch", "import repro_torch")), line
