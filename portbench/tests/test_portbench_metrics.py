"""The benchmark's arithmetic on hand-worked cases: tails over every
request, rates over the whole window, roofline and model-FLOP counts,
the trace's union and labels."""
import statistics
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import flops, harness, roofline, stats, trace
from portbench.spans import Spans


def test_percentile_and_rate():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert stats.percentile(xs, 95) == pytest.approx(np.percentile(xs, 95))
    assert stats.percentile(list(range(101)), 95) == 95
    assert stats.rate(30, 10.0) == 3.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_spread_is_iqr_over_median_by_statistics_quantiles():
    xs = [10.0, 10.2, 9.9, 10.1, 10.4, 9.8]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


def _req(due, first=None, done=None, n=5):
    return SimpleNamespace(due=due, first=first, done=done,
                           req=SimpleNamespace(max_new_tokens=n,
                                               metrics=SimpleNamespace(admitted=0.0)))


def _run(requests=(), tokens=(), queries=(), t0=0.0, t1=10.0):
    run = SimpleNamespace(requests=list(requests), tokens=list(tokens), queries=list(queries),
                          t0=t0, t1=t1, device_trace=None)
    run.window_s = t1 - t0
    run.layer_window = lambda: (t0, t1)
    return run


def test_ttft_p95_counts_every_request_due_and_waits_so_far():
    reqs = [_req(0.5 * i, first=0.5 * i + 0.1) for i in range(19)] + [_req(9.0)]
    value = harness.metric_reader("ttft_p95_ms")(_run(reqs))
    waits = [0.1] * 19 + [1.0]  # the last has no first token at the close: 10 - 9
    assert value == pytest.approx(1e3 * np.percentile(waits, 95))
    late = _req(11.0, first=11.5)  # due after the window: not counted
    assert harness.metric_reader("ttft_p95_ms")(_run(reqs + [late])) == pytest.approx(value)


def test_tpot_p95_over_requests_finished_in_the_window():
    reqs = [_req(0.0, first=1.0, done=1.0 + 0.04 * 4, n=5) for _ in range(10)]
    reqs.append(_req(0.0, first=1.0, done=12.0, n=5))  # finished after the close
    assert harness.metric_reader("tpot_p95_ms")(_run(reqs)) == pytest.approx(40.0)


def test_rates_are_over_the_whole_window():
    run = _run(tokens=[(1.0, 32), (9.5, 32), (10.5, 32)], queries=[0.5, 2.0, 11.0])
    assert harness.metric_reader("output_tokens_per_s")(run) == pytest.approx(6.4)
    assert harness.metric_reader("app_queries_per_s")(run) == pytest.approx(0.2)


def test_paged_decode_and_flash_counts():
    nbytes, fl = roofline.paged_decode_call([10, 20], hq=32, hkv=2, d=128, page_size=16)
    assert nbytes == 2 * 32 * 128 * 2 * 2 + 2 * 30 * 2 * 128 * 2 + (1 + 2) * 4 + 2 * 4
    assert fl == 4 * 32 * 128 * 30
    nbytes, fl = roofline.flash_call([4, 2], hq=32, hkv=2, d=128)
    assert nbytes == (4 + 2) * (2 * 32 + 2 * 2) * 128 * 2
    assert fl == 4 * 32 * 128 * (10 + 3)
    t, by = roofline.bound_s(3.35e12, 1.0)
    assert (t, by) == (1.0, "bytes")
    t, by = roofline.bound_s(1.0, 989e12)
    assert (t, by) == (1.0, "operations")


def test_model_flops_of_the_two_configurations():
    ds = harness.load_json(harness.HERE / "configs" / "deepseek-moe-16b.json")
    mf = flops.ModelFlops(ds)
    # 2,828,648,448 active parameters a token, less the 102400 x 2048 table
    # and the 28 x 2 norm scales of 2048, which multiply no matrix
    assert (mf.body + mf.head) // 2 == 2_828_648_448 - 102400 * 2048 - 28 * 2 * 2048
    glm = harness.load_json(harness.HERE / "configs" / "chatglm3-6b.json")
    mg = flops.ModelFlops(glm)
    attn = 4096 * 4096 * 2 + 2 * 4096 * 256
    assert mg.body == 2 * 28 * (attn + 3 * 4096 * 13696)
    assert mg.per_key == 4 * 28 * 32 * 128
    assert mg.prefill(3) == 3 * mg.body + 6 * mg.per_key + mg.head
    assert mg.decode([0, 9]) == 2 * (mg.body + mg.head) + 11 * mg.per_key


def test_trace_union_labels_and_names():
    assert trace.union([(0, 2), (1, 3), (5, 6), (7, 7)], 0.5, 5.5) == [(0.5, 3), (5, 5.5)]
    spans = Spans()
    spans.add("sched.tick", 0.0, 10.0)
    spans.add("engine.tick", 1.0, 2.0)
    label = trace.Labeler(spans.items)
    assert [label(t) for t in (0.5, 1.5, 3.0, 11.0)] == ["sched.tick", "engine.tick",
                                                         "sched.tick", "none"]
    assert trace.short_name("void (anonymous namespace)::paged_cluster_kernel<__nv_bfloat16, "
                            "16, 8>(CUtensorMap, int)") == "paged_cluster_kernel"


def test_device_trace_readings_from_intervals():
    tr = trace.DeviceTrace("cpu")
    tr.t0, tr.t1 = 0.0, 10.0
    tr.kernels = [("k", 1.0, 3.0), ("k", 2.0, 4.0), ("f", 6.0, 7.0)]
    tr.by_name = {"k": 4.0, "f": 1.0}
    assert tr.busy_s == 4.0 and tr.window_s == 10.0
    assert tr.matching(r"^k$") == 4.0
    run = _run()
    run.device_trace = tr
    assert harness.metric_reader("device_idle_share.chat")(run) == pytest.approx(60.0)
    spans = Spans()
    spans.add("engine.tick", 0.5, 5.0)
    b = tr.breakdown(spans.items)
    assert b["device_ops"][0] == ["k@engine.tick", 4.0]
    assert dict(map(tuple, b["idle_gaps"])) == {"engine.tick": 3.0, "none": 3.0}
