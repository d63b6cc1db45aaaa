"""The harness without the card: what it finds by name, what it refuses,
the last line's form, and whole runs of every cell on the CPU at a tiny
size, sound and with the timed path broken underneath."""
import ast
import json
import shutil
import subprocess
import sys
import time

import pytest

from portbench import harness
from portbench.faults import FAULTS

ROOT = harness.ROOT


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.models", "numpy"]) == []
    assert harness.forbidden_modules(["repro.core.hir", "repro_torch"]) == ["repro"]
    assert harness.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen", "jaxtyping"]) == \
        ["flax", "jax", "jaxlib"]


def test_reference_imports_nothing_of_jax_or_either_package():
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.common, "
            "portbench.reference.deepseek_moe_16b, portbench.reference.chatglm3_6b; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
    for path in (harness.HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in {"jax", "jaxlib", "flax", "repro", "repro_torch"}, \
                    (path.name, n)


def _cli(cwd, *extra):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "dsmoe-chat",
                           "--seed", "5", "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    p = _cli(ROOT)
    assert p.returncode != 0 and p.stdout == ""


def test_with_only_the_benchmark_files_it_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _cli(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_result_line_keys_and_checks_last():
    class R:
        trace, attempted, failed = True, 40, 0
    result = {"checks": {"logit_gap": {"value": 0.5, "limit": 1.0}},
              "memory_peak_bytes": 7, "metrics": {"tick_ms.chat": {"value": 3.0, "unit": "ms"}},
              "busy_s": 8.0, "window_s": 10.0,
              "breakdown": {"device_ops": [["k@engine.tick", 1.0]], "idle_gaps": []}}
    line = harness.result_line(R(), result, "NVIDIA H100 80GB HBM3")
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "checks"]
    assert line["correct"] is True
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                              "memory_peak_bytes": 7, "busy_s": 8.0, "window_s": 10.0}
    result["checks"]["logit_gap"]["value"] = 1.5
    assert harness.result_line(R(), result, "x")["correct"] is False
    json.dumps(line)


def test_every_metric_of_the_benchmark_has_a_reader():
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
    for w in bench["workloads"]:
        cell = harness.load_json(harness.HERE / "cells" / f"{w['name']}.json")
        assert (harness.HERE / "traffic" / f"{cell['traffic']['kind']}.py").exists()
        config = harness.load_json(harness.HERE / "configs" / f"{w['config']}.json")
        assert (harness.HERE / "reference" / f"{config['reference']}.py").exists()


def test_every_cell_names_its_own_pair_of_configuration_and_traffic():
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in bench["workloads"]:
        cell = harness.load_json(harness.HERE / "cells" / f"{w['name']}.json")
        assert (cell["config"], harness.traffic_name(cell)) == (w["config"], w["traffic"])
    over = harness.load_json(harness.HERE / "cells" / "dsmoe-chat-over.json")
    assert harness.traffic_name(over) == "open_loop_over"
    assert over["traffic"]["kind"] == "open_loop"


def test_a_cell_whose_traffic_disagrees_with_the_benchmark_is_refused():
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        if w["name"] == "dsmoe-chat-over":
            w["traffic"] = "open_loop"
    with pytest.raises(ValueError, match="disagrees"):
        harness.Run(bench, "dsmoe-chat-over", 1, 1.0, False, "cpu")


def test_a_new_configuration_traffic_kind_cell_and_metric_are_found_by_name(tmp_path):
    """Added as new files and new entries, nothing else edited."""
    root = tmp_path / "portbench"
    shutil.copytree(harness.HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    config = harness.load_json(root / "configs" / "chatglm3-6b.json")
    config["name"] = "chatglm3-6b-copy"
    (root / "configs" / "chatglm3-6b-copy.json").write_text(json.dumps(config))
    shutil.copy(root / "traffic" / "closed_loop.py", root / "traffic" / "closed_again.py")
    cell = harness.load_json(root / "cells" / "glm-longdoc.json")
    cell.update(config="chatglm3-6b-copy")
    cell["traffic"]["kind"] = "closed_again"
    (root / "cells" / "glm-again.json").write_text(json.dumps(cell))
    (root / "metrics" / "requests_served.py").write_text(
        "def read(run):\n    return float(run.counters['served'])\n")
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    bench["configs"].append(dict(bench["configs"][1], name="chatglm3-6b-copy"))
    bench["workloads"].append(dict(bench["workloads"][2], name="glm-again",
                                   config="chatglm3-6b-copy", traffic="closed_again"))
    bench["end_to_end"].append({"name": "requests_served", "unit": "requests", "better": "higher",
                                "bound": 0.25, "source": "host_clock", "workloads": ["glm-again"]})
    from conftest import TINY, shrink
    run = harness.Run(bench, "glm-again", 3, 4.0, False, "cpu",
                      model_override=dict(TINY, n_kv_heads=2, n_experts=0), root=root)
    run.cell["traffic"]["kind"] = "closed_loop"
    shrink(run)
    run.cell["traffic"]["kind"] = "closed_again"
    result = harness.run_cell(run, time.perf_counter())
    assert result["metrics"]["requests_served"]["value"] == run.counters["served"] > 0
    assert set(result["metrics"]) == {"setup_s", "requests_served"}


@pytest.mark.parametrize("cell", ["dsmoe-apps", "dsmoe-chat", "glm-longdoc", "dsmoe-chat-over"])
def test_a_sound_run_is_correct(tiny_run, cell):
    run = tiny_run(cell, seconds=3.0)
    result = harness.run_cell(run, time.perf_counter())
    line = harness.result_line(run, result, "cpu")
    assert line["correct"], line
    assert run.counters["tokens_compared"] > 0 and run.attempted > 0
    assert set(line["metrics"]) == {m["name"] for m in harness.cell_metrics(
        run.bench, cell, "end_to_end")}


@pytest.mark.parametrize("cell,fault", [
    ("dsmoe-apps", "altered_token"), ("dsmoe-apps", "state_unchanged"),
    ("dsmoe-apps", "half_batch"), ("dsmoe-chat", "altered_token"),
    ("dsmoe-chat", "state_unchanged"), ("dsmoe-chat", "half_batch"),
    ("dsmoe-apps", "misdelivered"),
    ("glm-longdoc", "altered_token"), ("glm-longdoc", "state_unchanged"),
    ("dsmoe-chat-over", "altered_token"), ("dsmoe-chat-over", "state_unchanged"),
    ("dsmoe-chat-over", "half_batch")])
def test_a_broken_timed_path_is_not_correct(tiny_run, monkeypatch, cell, fault):
    """Each fault the cell can have (``glm-longdoc`` prefills one prompt a
    dispatch, so it has no half batch; only ``dsmoe-apps`` hands answers to
    queries; one chip has no exchange), planted underneath the timed path;
    every served request is compared."""
    run = tiny_run(cell, seconds=3.0)
    run.cell["correctness"]["sample"] = 10_000
    FAULTS[fault](monkeypatch.setattr)
    result = harness.run_cell(run, time.perf_counter())
    line = harness.result_line(run, result, "cpu")
    assert not line["correct"], line["checks"]
