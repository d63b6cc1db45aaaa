"""Each traffic kind is fixed by its seed and draws inside its stated
ranges; every seed offers the same schedule of sizes, and other tokens."""
import numpy as np
import pytest

from portbench import harness


def _cell(name):
    return harness.load_json(harness.HERE / "cells" / f"{name}.json")


def _traffic(kind):
    return harness.load_module(harness.HERE / "traffic" / f"{kind}.py", f"t_{kind}")


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 2**33 + 1])
def test_open_loop_plan(seed):
    t = _cell("dsmoe-chat")["traffic"]
    plan = _traffic("open_loop").plan
    a, b = plan(t, seed, 45.0, 102400), plan(t, seed, 45.0, 102400)
    assert [r["due"] for r in a] == [r["due"] for r in b]
    assert all(np.array_equal(x["prompt"], y["prompt"]) for x, y in zip(a, b))
    assert len(a) == round(t["rate"] * 45.0)
    dues = [r["due"] for r in a]
    assert dues == sorted(dues) and dues[0] == 0.0 and dues[-1] < 45.0
    for r in a:
        assert t["prompt"]["min"] <= len(r["prompt"]) <= t["prompt"]["max"]
        assert t["output"]["min"] <= r["max_new"] <= t["output"]["max"]
        assert r["template"] in t["templates"]
        assert r["prompt"].min() >= 0 and r["prompt"].max() < 102400
    share = sum(r["template"] == "chat" for r in a) / len(a)
    assert abs(share - t["templates"]["chat"]) < 0.02
    other = plan(t, seed + 1, 45.0, 102400)
    assert [(r["due"], len(r["prompt"]), r["max_new"], r["template"]) for r in other] == \
        [(r["due"], len(r["prompt"]), r["max_new"], r["template"]) for r in a]
    assert not np.array_equal(other[0]["prompt"], a[0]["prompt"])
    gaps = np.diff(dues)
    assert np.std(gaps) / np.mean(gaps) > 1.2  # bursty: gamma with CV 2


@pytest.mark.parametrize("seed", [3, 2**32 + 5])
def test_closed_loop_plan(seed):
    t = _cell("glm-longdoc")["traffic"]
    plan = _traffic("closed_loop").plan
    a, b = plan(t, seed, 65024), plan(t, seed, 65024)
    assert len(a) == t["clients"]
    for ca, cb in zip(a, b):
        for x, y in zip(ca, cb):
            assert np.array_equal(x["prompt"], y["prompt"]) and x["max_new"] == y["max_new"]
            assert t["prompt"]["min"] <= len(x["prompt"]) <= t["prompt"]["max"]
            assert t["output"]["min"] <= x["max_new"] <= t["output"]["max"]
            assert len(x["prompt"]) + x["max_new"] <= t["max_total"]
    other = plan(t, seed + 1, 65024)
    assert [[(len(r["prompt"]), r["max_new"]) for r in c] for c in other] == \
        [[(len(r["prompt"]), r["max_new"]) for r in c] for c in a]
    assert not np.array_equal(other[0][0]["prompt"], a[0][0]["prompt"])


@pytest.mark.parametrize("seed", [11, 2**31 + 1])
def test_apps_plan(seed):
    t = _cell("dsmoe-apps")["traffic"]
    plan = _traffic("apps").plan
    a, b = plan(t, seed), plan(t, seed)
    assert a == b and len(a) == t["clients"]
    for c, runs in enumerate(a):
        assert runs[0][0] == list(t["programs"])[c % len(t["programs"])]
        for name, inputs in runs:
            for key, (lo, hi) in t["programs"][name].items():
                assert lo <= len(inputs[key]) <= hi
    other = plan(t, seed + 1)
    assert [[(n, {k: len(v) for k, v in i.items()}) for n, i in r] for r in other] == \
        [[(n, {k: len(v) for k, v in i.items()}) for n, i in r] for r in a]
    assert other != a
