"""The port's pure-Python modules are the JAX package's, line for line.

``repro_torch`` may import nothing of ``repro``, so it keeps its own copy
of every pure-Python module it needs, with only the imports rewritten
(``repro.`` -> ``repro_torch.``).  Each copy, with ``repro_torch`` read
back as ``repro``, must equal the reference module exactly, apart from the
notes the port adds and names here and the port's spans
(:mod:`repro_torch.tracing`, read away by :func:`_untraced`).
``core/services.py`` is a copy up to ``ModelService``, which the port
rewrites in PyTorch.
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


# A line that calls the port's tracer (no reference module mentions it).
_TRACES = re.compile(r"\btracing\.")


def _untraced(text: str) -> str:
    """``text`` without the port's spans: the tracer's import and every line
    that calls it are dropped, an ``if`` on it with its block, and a
    ``with`` of it with its header only, its block moved back out a level."""
    out: list[str] = []
    opened: list[int] = []  # indents of the dropped `with` headers still open
    dropping = None         # indent of a dropped `if` header while in its block
    for line in text.splitlines(keepends=True):
        body = line.strip()
        indent = len(line) - len(line.lstrip())
        if body:
            if dropping is not None and indent > dropping:
                continue
            dropping = None
            while opened and indent <= opened[-1]:
                opened.pop()
        elif dropping is not None:
            continue
        if body == "from repro_torch import tracing":
            continue
        if _TRACES.search(line):
            if body.startswith("with ") and body.endswith(":"):
                opened.append(indent)
            elif body.startswith("if ") and body.endswith(":"):
                dropping = indent
            continue
        out.append(line[4 * len(opened):] if body else line)
    return "".join(out)


def test_untraced_reads_away_exactly_the_spans():
    traced = (
        "from repro_torch import tracing\n"
        "def f(x):\n"
        "    with tracing.span(\"a\") as sp:\n"
        "        if tracing.enabled():\n"
        "            sp.set(n=[\n"
        "                x])\n"
        "        y = x  # kept\n"
        "\n"
        "        with tracing.span(\"b\"):\n"
        "            tracing.end_at(\"b\", 0.0)\n"
        "            if y:\n"
        "                y += 1\n"
        "        return y\n")
    assert _untraced(traced) == (
        "def f(x):\n"
        "    y = x  # kept\n"
        "\n"
        "    if y:\n"
        "        y += 1\n"
        "    return y\n")


def _port_text(rel: str) -> str:
    text = (PORT / rel).read_text()
    for note in NOTES.get(rel, ()):
        assert text.count(note) == 1, f"{rel}: note not found once: {note!r}"
        text = text.replace(note, "")
    return _untraced(text).replace("repro_torch", "repro")


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
