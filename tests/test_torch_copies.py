"""The port's pure-Python modules are the JAX package's, line for line.

``repro_torch`` may import nothing of ``repro``, so it keeps its own copy
of every pure-Python module it needs, with only the imports rewritten
(``repro.`` -> ``repro_torch.``).  Each copy, with ``repro_torch`` read
back as ``repro``, must equal the reference module exactly, apart from the
notes the port adds and names here.  ``core/services.py`` is a copy up to
``ModelService``, which the port rewrites in PyTorch.
"""
from __future__ import annotations

import re
import sys
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
        "  ``torch.func.vmap(single_fn)``, and each is compiled per shape.)\n",
        '    "torch_block",\n'],
    "launch/roofline.py": [
        'RESULTS = RESULTS.with_name("dryrun_torch.json")  # the port\'s dry run writes its own\n'],
    "examples/quickstart.py": [
        "\nThe port's copy, imports rewritten: run it as\n"
        "``python -m repro_torch.examples.quickstart``.\n"],
}

VERBATIM = [
    # copies that came with the serving and trainer slices
    "serving/scheduler.py", "serving/request.py", "serving/kv.py",
    "core/strategies.py", "core/lane_policy.py", "core/concurrency.py",
    "core/resilience.py", "core/loop_context.py",
    # the paper's transformation and runtime layer
    "core/hir.py", "core/runtime.py", "core/runtime_baseline.py", "core/faults.py",
    "core/equivalence.py", "core/app_traces.py", "serving/hir_bridge.py",
    # the model configurations
    "configs/llama3_8b.py", "configs/mamba2_1_3b.py", "configs/deepseek_moe_16b.py",
    "configs/kimi_k2_1t_a32b.py", "configs/olmo_1b.py", "configs/qwen1_5_4b.py",
    "configs/chatglm3_6b.py", "configs/hymba_1_5b.py", "configs/qwen2_vl_2b.py",
    "configs/seamless_m4t_medium.py",
    # the dry run's report
    "launch/roofline.py",
]


# copies of the reference's examples (base ``examples/``, not ``src/repro/``)
EXAMPLES = ["examples/quickstart.py"]


def _port_text(rel: str) -> str:
    text = (PORT / rel).read_text()
    for note in NOTES.get(rel, ()):
        assert text.count(note) == 1, f"{rel}: note not found once: {note!r}"
        text = text.replace(note, "")
    return text.replace("repro_torch", "repro")


@pytest.mark.parametrize("rel", VERBATIM)
def test_copy_equals_reference(rel):
    assert _port_text(rel) == (REF / rel).read_text()


@pytest.mark.parametrize("rel", EXAMPLES)
def test_example_copy_equals_reference(rel):
    assert _port_text(rel) == (ROOT / rel).read_text()


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


@pytest.mark.parametrize("rel", VERBATIM + ["core/services.py"] + EXAMPLES)
def test_copy_imports_only_the_port(rel):
    for line in (PORT / rel).read_text().splitlines():
        s = line.strip()
        if s.startswith(("from repro", "import repro")):
            assert s.startswith(("from repro_torch", "import repro_torch")), line


def test_quickstart_sum_equals_reference(capsys):
    """Both quickstarts print the same ``sum (both)``: the transformed
    program's answer equals the original's in each package."""
    from repro_torch.examples import quickstart

    def printed_sum():
        out = capsys.readouterr().out
        return int(re.search(r"sum \(both\)\s*: (\d+)", out).group(1))

    sys.path.insert(0, str(ROOT / "examples"))
    try:
        reference = __import__("quickstart")
    finally:
        sys.path.pop(0)
    reference.main()
    want = printed_sum()
    quickstart.main()
    assert printed_sum() == want == sum(10 * c for c in range(300))
