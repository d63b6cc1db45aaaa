"""A configuration's weights and FLOP count, looked up by its name: the two
configurations keep what ``weights.py`` and ``flops.py`` give, bit for
bit, and a configuration added as new files alone reaches its own."""
import json
import shutil
import time

import pytest
import torch

from portbench import flops, harness, layouts, weights


def _leaves(tree, path=""):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    else:
        for key in tree:
            yield from _leaves(tree[key], f"{path}.{key}" if path else key)


@pytest.mark.parametrize("cell", ["dsmoe-chat", "glm-longdoc"])
def test_without_a_layout_the_weights_and_counts_are_the_defaults(tiny_run, cell):
    run = tiny_run(cell, seed=2**31 + 77)
    assert layouts.layout(run) is None
    got = dict(_leaves(layouts.make_params(run)))
    want = dict(_leaves(weights.make_params(
        run.model, run.seed, run.device, run.config.get("init", {}).get("qk_scale", 1.0))))
    assert list(got) == list(want)
    for path, t in want.items():
        assert got[path].dtype == t.dtype and torch.equal(got[path], t), path
    mine, theirs = layouts.model_flops(run), flops.ModelFlops(run.config)
    assert type(mine) is flops.ModelFlops
    for n in (1, 17, 2048):
        assert mine.prefill(n) == theirs.prefill(n)
    assert mine.decode([0, 5, 4095]) == theirs.decode([0, 5, 4095])


TOY_LAYOUT = '''
import torch

from portbench import flops, weights


def make_params(model, seed, device, qk_scale):
    params = weights.make_params(model, seed, device, qk_scale)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) + 1)
    params["probe"] = {"w": torch.empty((model["d_model"], 8), dtype=torch.bfloat16,
                                        device=device).normal_(0.0, 1.0, generator=gen)}
    return params


class ModelFlops(flops.ModelFlops):
    def prefill(self, prompt_len):
        return 3 * super().prefill(prompt_len)

    def decode(self, positions):
        return 3 * super().decode(positions)
'''

TOY_REFERENCE = '''
from portbench.reference import chatglm3_6b


def logits(model, w, tokens, first, group_len):
    w.mat("probe.w")  # the layout's own leaf: a KeyError where the tree lacks it
    return chatglm3_6b.logits(model, w, tokens, first, group_len)
'''


def test_a_configuration_with_its_own_leaves_is_found_by_name(tmp_path, monkeypatch):
    """``toy-1.0`` arrives as new files only (``configs/``, ``cells/``,
    ``reference/``, ``layouts/``): its layout draws a leaf that
    ``weights.py`` does not know, which reaches the program and the
    reference, and its FLOP count is the one ``mfu`` reads."""
    from conftest import TINY, shrink
    from portbench import correctness
    root = tmp_path / "portbench"
    shutil.copytree(harness.HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    config = harness.load_json(root / "configs" / "chatglm3-6b.json")
    config.update(name="toy-1.0", reference="toy_1_0")
    (root / "configs" / "toy-1.0.json").write_text(json.dumps(config))
    cell = harness.load_json(root / "cells" / "glm-longdoc.json")
    cell["config"] = "toy-1.0"
    (root / "cells" / "toy-doc.json").write_text(json.dumps(cell))
    (root / "reference" / "toy_1_0.py").write_text(TOY_REFERENCE)
    (root / "layouts" / "toy_1_0.py").write_text(TOY_LAYOUT)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    bench["configs"].append(dict(bench["configs"][1], name="toy-1.0",
                                 file="portbench/configs/toy-1.0.json"))
    bench["workloads"].append(dict(bench["workloads"][2], name="toy-doc", config="toy-1.0"))
    run = harness.Run(bench, "toy-doc", 2**31 + 5, 3.0, False, "cpu",
                      model_override=dict(TINY, n_kv_heads=2, n_experts=0), root=root)
    shrink(run)
    seen = {}
    check = correctness.check

    def spy(run, params, served, cast=None):
        seen["params"] = params
        return check(run, params, served, cast)

    monkeypatch.setattr(correctness, "check", spy)
    result = harness.run_cell(run, time.perf_counter())
    line = harness.result_line(run, result, "cpu")
    assert line["correct"], line["checks"]
    assert run.counters["tokens_compared"] > 0
    probe = seen["params"]["probe"]["w"]
    assert probe.dtype == torch.bfloat16 and probe.shape == (TINY["d_model"], 8)
    mfu = harness.metric_reader("mfu", root / "metrics")
    own = mfu(run)
    run.root = harness.HERE  # no layout of toy-1.0 there: flops.py's count
    assert own == pytest.approx(3 * mfu(run), rel=1e-12) and own > 0
