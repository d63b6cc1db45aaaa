"""The port's compiled engine dispatches against the JAX engines.

``serving/graphs.py`` is the port's ``jax.jit``: the tick, the paged tick
(with sampling on the device) and the batch-1 chunk step run over static
buffers and, on the card, as captured CUDA graphs.  On the CPU a step
runs its function directly on the same buffers, so these tests hold the
static-buffer plumbing (one copy-in a call, the on-device position
counter of the chunk step, the staging cache copied in and out) to the
JAX engines: reduced llama3-8b, deepseek-moe-16b, mamba2-1.3b and
hymba-1.5b in float32, weights drawn by JAX and carried across, on four
workloads — main (the synchronous paged path), async (``overlap=True``
with ``chunk_tokens``, fused ticks where the arch pages its compute),
prefix (``prefix_share``, paged-compute archs) and spill (an
oversubscribed pool with a host spill pool; in dense-compute mode,
``lane_timeout`` spills and restores).  Greedy streams and the counters
must be equal exactly, and equal again under ``graphs.eager()``.

Also here: a step's first call (the function run once, its outputs
returned, the graph recorded for the calls after it, at the first or the
second call; the card's path with the graph stood in for), the
registry's capture tally across threads and on a capture stream, the
device
sampler (greedy lanes against ``jnp.argmax``, draws against the softmax),
and twins of the two public functions the port lacked,
``serving/engine.py::proportional_shares`` and
``models/registry.py::list_archs``.

The prefill steps (one per (batch, prompt) bucket, built at the bucket's
first dispatch, over one staging cache per engine): one step per
distinct bucket on the dense and the paged engines, reused by later
dispatches; two staged prefills of one bucket keep their own first
tokens and caches until committed, and then serve the JAX engine's
streams; a chunked prompt's first chunk takes the (1, ``chunk``) step.
"""
from __future__ import annotations

import dataclasses
import threading
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import strategies as j_strategies
from repro.models.registry import get_arch as j_get_arch
from repro.models.registry import list_archs as j_list_archs
from repro.serving.engine import HostSpillPool as JHostSpillPool
from repro.serving.engine import proportional_shares as j_proportional_shares
from repro.serving.paged_kv import PagedInferenceEngine as JPagedEngine
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import ContinuousBatchingScheduler as JScheduler
from repro_torch.core import strategies
from repro_torch.kernels import registry
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.paged_decode import sample_tokens
from repro_torch.models.registry import get_arch, list_archs
from repro_torch.serving import graphs
from repro_torch.serving.engine import HostSpillPool, InferenceEngine, proportional_shares
from repro_torch.serving.paged_kv import PagedInferenceEngine
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import ContinuousBatchingScheduler

ARCHS = ("llama3-8b", "deepseek-moe-16b", "mamba2-1.3b", "hymba-1.5b")
PAGED_COMPUTE = ("llama3-8b", "deepseek-moe-16b")
COUNTERS = ("dispatches", "decode_steps", "fused_folds", "kv_bytes_moved", "prefill_calls")


@pytest.fixture(scope="module")
def pairs():
    """name -> (JAX arch, JAX params, port arch, port params), built once."""
    cache = {}

    def get(name):
        if name not in cache:
            jarch = j_get_arch(name)
            jarch = dataclasses.replace(jarch, cfg=jarch.cfg.reduced())
            jparams = jarch.init(jax.random.PRNGKey(0))
            arch = get_arch(name)
            arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
            tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                        arch.cfg, device="cpu")
            cache[name] = (jarch, jparams, arch, tparams)
        return cache[name]

    return get


def _traffic(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "prefix":  # a 16-token prefix (2 pages of 8) and tails of 3-6
        prefix = rng.integers(1, 200, size=16)
        return [dict(rid=i, prompt=np.concatenate(
                    [prefix, rng.integers(1, 200, size=int(t))]).astype(np.int32),
                     max_new_tokens=5) for i, t in enumerate(rng.integers(3, 7, size=4))]
    lens = {"async": (5, 13, 7, 15, 3, 11), "spill": (6, 5, 9)}.get(kind, (4, 9, 3, 12, 6))
    new = 16 if kind == "spill" else 6
    return [dict(rid=i, prompt=rng.integers(1, 200, size=n).astype(np.int32),
                 max_new_tokens=new) for i, n in enumerate(lens)]


def _setting(kind: str, paged_compute: bool):
    """(engine keywords, scheduler keywords, strategy name, spill pool size)."""
    ekw = dict(n_lanes=3, max_prompt_len=16, max_len=48, page_size=8)
    skw = {}
    strat = "GrowingUpperThreshold"
    spill = None
    if kind == "async":
        skw = dict(overlap=True, chunk_tokens=4)
    elif kind == "prefix":  # whole prompts: the shared prefix is not cut off
        ekw.update(n_lanes=4, max_prompt_len=32, prefix_share=True)
    elif kind == "spill":
        strat, spill = "OneOrAll", 8
        if paged_compute:  # 6 pages for 3 lanes of 4: growth evicts
            ekw.update(max_len=32, n_pages=6, prefetch_pages=2)
        else:
            skw = dict(lane_timeout=3)
    return ekw, skw, strat, spill


def _serve(pair, side: str, kind: str, name: str):
    jarch, jparams, arch, tparams = pair
    jax_side = side == "jax"
    ekw, skw, strat, spill = _setting(kind, name in PAGED_COMPUTE)
    Engine, Sched, Req, strats = ((JPagedEngine, JScheduler, JRequest, j_strategies)
                                  if jax_side else
                                  (PagedInferenceEngine, ContinuousBatchingScheduler,
                                   Request, strategies))
    if spill:
        ekw["kv_spill"] = (JHostSpillPool if jax_side else HostSpillPool)(spill)
    if not jax_side:
        ekw["device"] = "cpu"
    eng = Engine(jarch if jax_side else arch, jparams if jax_side else tparams, **ekw)
    sk = {"initial_upper": 2} if strat == "GrowingUpperThreshold" else {}
    sched = Sched(eng, strategy=getattr(strats, strat)(**sk), **skw)
    reqs = [Req(**t) for t in _traffic(kind, 3)]
    for r in reqs:
        sched.submit(r)
    sched.producer_done()
    sched.run_until_drained()
    return ([r.generated for r in reqs], {a: getattr(eng, a) for a in COUNTERS},
            sched.stats)


CASES = [(name, kind) for name in ARCHS for kind in ("main", "async", "prefix", "spill")
         if kind != "prefix" or name in PAGED_COMPUTE]


@pytest.mark.parametrize("name, kind", CASES)
def test_compiled_dispatches_equal_the_jax_engine(pairs, name, kind):
    """Streams and counters through the static-buffer dispatches equal the
    JAX engine's, and equal again under ``eager()``; each workload reaches
    the path it names."""
    pair = pairs(name)
    want = _serve(pair, "jax", kind, name)
    got = _serve(pair, "torch", kind, name)
    with graphs.eager():
        assert graphs.is_eager()
        twin = _serve(pair, "torch", kind, name)
    assert not graphs.is_eager()
    assert got[:2] == want[:2]
    assert twin[:2] == got[:2]
    st, c = got[2], got[1]
    assert all(len(g) == t["max_new_tokens"] for g, t in zip(got[0], _traffic(kind, 3)))
    if kind == "async":
        assert st.spec_chunks >= 2
        assert (c["fused_folds"] >= 1) == (name in PAGED_COMPUTE)
    if kind == "prefix":
        assert st.prefix_hits >= 2
    if kind == "spill":
        assert st.kv_spilled >= 1 and st.kv_restored == st.kv_spilled


def test_chunk_step_advances_its_counters_and_copies_back(pairs):
    """``_extend`` on the CPU: the staged cache gains exactly the rows a
    one-shot prefill would hold, the returned lengths advance by the chunk,
    and the staging cache's position counter restarts at every call."""
    from repro_torch.models import transformer as tf

    _j, _jp, arch, params = pairs("llama3-8b")
    eng = InferenceEngine(arch, params, n_lanes=2, max_prompt_len=16, max_len=32,
                          device="cpu")
    prompt = np.random.default_rng(5).integers(1, 200, size=11).astype(np.int32)
    _l, cache = tf.prefill(arch.cfg, params, torch.as_tensor(prompt[None, :4]), max_len=32)
    length = torch.tensor([4], dtype=torch.int32)
    for lo, hi in ((4, 8), (8, 11)):
        logits, same, length = eng._extend(cache, prompt[None, lo:hi], length)
        assert same is cache and int(length[0]) == hi
        assert int(eng._chunk_step().inputs["j"][0]) == hi - lo
    full_logits, full = tf.prefill(arch.cfg, params, torch.as_tensor(prompt[None]), max_len=32)
    torch.testing.assert_close(logits, full_logits, rtol=1e-4, atol=1e-4)
    for name, stack in full.items():
        for key, a in stack.items():
            torch.testing.assert_close(cache[name][key][:, :, :11], a[:, :, :11],
                                       rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="one row"):
        eng._extend(cache, np.zeros((2, 3), np.int32), length)


def test_static_inputs_views_and_upload():
    """Named int32 and float32 views of one buffer; ``put`` writes the
    host twin, ``upload(n)`` copies its first n entries."""
    inp = graphs.StaticInputs({"a": (2,), "t": ((3,), torch.float32), "m": (2, 2)},
                              torch.device("cpu"))
    inp.put("a", [7, -1])
    inp.put("t", np.array([0.5, 2.0, -3.25], np.float32))
    inp.host_view("m")[:] = [[1, 2], [3, 4]]
    inp.upload(2)
    assert inp["a"].tolist() == [7, -1] and inp["t"].tolist() == [0.0, 0.0, 0.0]
    inp.upload()
    assert inp["t"].dtype == torch.float32 and inp["t"].tolist() == [0.5, 2.0, -3.25]
    assert inp["m"].tolist() == [[1, 2], [3, 4]]


def test_compiled_step_runs_its_function_on_the_cpu():
    """No graph on the CPU: each call runs the function on the buffers and
    keeps its outputs; the step's lock serialises exclusive users."""
    inp = graphs.StaticInputs({"x": (3,)}, torch.device("cpu"))
    acc = torch.zeros(3, dtype=torch.int32)

    def fn():
        acc.add_(inp["x"])
        return acc * 2

    step = graphs.CompiledStep(fn, inp, [acc], torch.device("cpu"))
    assert not step.captured
    inp.put("x", [1, 2, 3])
    inp.upload()
    with step.exclusive():
        step()
        out = step()
    assert acc.tolist() == [2, 4, 6] and out.tolist() == [4, 8, 12] and step.out is out


class _Recorded:
    """A stand-in for a recorded graph on a CPU-only build: ``replay``
    notes that it ran."""

    def __init__(self, log):
        self.log = log

    def replay(self):
        self.log.append("replay")


@pytest.mark.parametrize("start", [0, 5])
def test_first_call_is_the_dispatch(monkeypatch, start):
    """The card's path of a step, its graph stood in for: over state that
    need not be zero, the first call runs the function once (no warm-up
    run besides) and returns that run's own outputs, its launches counted;
    the graph is recorded right after that run, executing nothing; every
    later call is one replay, adding the recording's tally; under
    ``eager()`` the function runs again and the next replay returns the
    graph's outputs."""
    kernel = registry.get("batched_gather").kernel
    log, runs, state = [], [], torch.full((3,), start, dtype=torch.int32)

    def record(self):
        log.append(("record", self.calls))
        self.graph, self.tally = _Recorded(log), {kernel: 2}
        self._graph_out = (torch.zeros(3),)
        self.parts.update(record=0.0, instantiate=0.0)

    monkeypatch.setattr(graphs.CompiledStep, "_record", record)
    inp = graphs.StaticInputs({"x": (3,)}, torch.device("cpu"))

    def fn():
        runs.append(1)
        registry.count_launch(kernel)
        registry.count_launch(kernel)
        state.add_(inp["x"])
        out = (state * 2,)
        log.append(("run", out))
        return out

    step = graphs.CompiledStep(fn, inp, [state], torch.device("cuda"), pool=object())
    inp.put("x", [1, 2, 3])
    inp.upload()
    registry.reset_launches()
    first = step()
    assert len(runs) == 1 and first is log[0][1] and step.out is first
    assert state.tolist() == [start + 1, start + 2, start + 3]
    assert first[0].tolist() == [2 * v for v in state.tolist()]
    assert registry.launch_counts()["batched_gather"] == 2
    assert step.captured and "run" in step.parts
    second = step()
    assert len(runs) == 1 and second is step._graph_out and step.captured
    assert [e for e in log if e[0] == "record"] == [("record", 1)]
    assert (step.calls, step.replays) == (2, 1)
    assert registry.launch_counts()["batched_gather"] == 4
    with graphs.eager():
        third = step()
    assert len(runs) == 2 and third is log[-1][1] and (step.calls, step.replays) == (2, 1)
    assert step() is step._graph_out and (step.calls, step.replays) == (3, 2)
    assert log.count("replay") == 2
    assert registry.launch_counts()["batched_gather"] == 8
    registry.reset_launches()


def test_a_failed_recording_spoils_the_step(monkeypatch):
    """The card's path of a step whose recording raises: the first call ran
    the function once (its state written) and raises the recording's
    error; every later call raises without running the function again, so
    a caller that retries applies no update twice."""
    runs, state = [], torch.zeros((3,), dtype=torch.int32)

    def record(self):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(graphs.CompiledStep, "_record", record)
    inp = graphs.StaticInputs({"x": (3,)}, torch.device("cpu"))

    def fn():
        runs.append(1)
        state.add_(inp["x"])
        return state * 2

    step = graphs.CompiledStep(fn, inp, [state], torch.device("cuda"), pool=object())
    inp.put("x", [1, 2, 3])
    inp.upload()
    with pytest.raises(RuntimeError, match="capturing"):
        step()
    assert runs == [1] and state.tolist() == [1, 2, 3] and not step.captured
    for _ in range(2):
        with pytest.raises(RuntimeError, match="recording failed"):
            step()
    assert runs == [1] and state.tolist() == [1, 2, 3] and (step.calls, step.replays) == (1, 0)


def test_capture_tally_takes_the_capture_streams_launches_from_any_thread(monkeypatch):
    """A capture that names its stream takes the launches of another thread
    whose current stream it is (autograd's device thread in a recorded
    backward), not those of a thread on another stream."""
    kernel = registry.get("batched_gather").kernel
    current = threading.local()
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: SimpleNamespace(cuda_stream=getattr(current, "s", 0)))
    capture, other = SimpleNamespace(cuda_stream=7), 8
    registry.reset_launches()

    def launch(stream: int, n: int):
        current.s = stream
        for _ in range(n):
            registry.count_launch(kernel)

    with registry.capture_tally(capture) as tally:
        for stream, n in ((7, 3), (other, 2)):
            t = threading.Thread(target=launch, args=(stream, n))
            t.start()
            t.join()
        registry.count_launch(kernel)
    assert tally == {kernel: 4}
    assert registry.launch_counts()["batched_gather"] == 2
    launch(7, 1)  # after the capture: counted
    assert registry.launch_counts()["batched_gather"] == 3
    registry.reset_launches()


def test_capture_tally_counts_only_the_capturing_thread():
    """While one thread captures, its launches go into the tally and
    another thread's into the counts; a replay adds the tally once."""
    kernel = registry.get("batched_gather").kernel
    registry.reset_launches()
    go, done = threading.Event(), threading.Event()

    def other():
        go.wait()
        for _ in range(5):
            registry.count_launch(kernel)
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with registry.capture_tally() as tally:
        registry.count_launch(kernel)
        go.set()
        done.wait()
        registry.count_launch(kernel)
        registry.count_launch(kernel)
        with registry.capture_tally() as inner:  # a nested capture has its own
            registry.count_launch(kernel)
        registry.count_launch(kernel)
    t.join()
    assert tally == {kernel: 4} and inner == {kernel: 1}
    assert registry.launch_counts()["batched_gather"] == 5
    registry.add_launches(tally)
    registry.add_launches(tally)
    assert registry.launch_counts()["batched_gather"] == 13
    registry.count_launch(kernel)  # outside the capture: counted again
    assert registry.launch_counts()["batched_gather"] == 14
    registry.reset_launches()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_sampler_greedy_lanes_equal_jnp_argmax(seed):
    """Temperature-0 lanes take the first maximum, as ``jnp.argmax``:
    integer logits make ties common."""
    rng = np.random.default_rng(seed)
    logits = rng.integers(-3, 4, size=(9, 50)).astype(np.float32)
    temps = np.zeros(9, np.float32)
    temps[::3] = 0.8
    out = sample_tokens(torch.from_numpy(logits), temps,
                        rng.integers(0, 2 ** 31, size=9).astype(np.int32),
                        rng.integers(0, 500, size=9).astype(np.int32))
    want = np.asarray(jnp.argmax(jnp.asarray(logits), axis=-1))
    cold = temps == 0
    np.testing.assert_array_equal(out.numpy()[cold], want[cold])
    assert out.dtype == torch.int32


@pytest.mark.parametrize("temp", [1.0, 0.6])
def test_device_sampler_follows_the_softmax(temp):
    """4000 draws from one row at distinct (seed, position) pairs: each
    token's count lies within 4 sigma of its softmax probability."""
    rng = np.random.default_rng(11)
    row = rng.standard_normal(24).astype(np.float32)
    n = 4000
    seeds = (np.arange(n) // 50 + 17).astype(np.int32)
    positions = (np.arange(n) % 50 * 3).astype(np.int32)
    out = sample_tokens(torch.from_numpy(np.tile(row, (n, 1))), np.full(n, temp, np.float32),
                        seeds, positions).numpy()
    counts = np.bincount(out, minlength=row.size)
    p = np.exp(row / temp - np.max(row / temp))
    p /= p.sum()
    sigma = np.sqrt(n * p * (1 - p))
    assert np.all(np.abs(counts - n * p) <= 4 * sigma), (counts, n * p)


def test_proportional_shares_follow_weights():
    """Twin of ``tests/test_serving.py::test_proportional_shares_follow_weights``,
    both packages' functions on the same inputs."""
    for fn in (proportional_shares, j_proportional_shares):
        assert fn({"chat": 3.0, "embed": 1.0}, n_lanes=8, reserve=0.5) == \
            {"chat": 3, "embed": 1}
        assert fn({}, 8) == {}
        shares = fn({"a": 1.0, "b": 1.0, "c": 1.0}, n_lanes=4, reserve=0.5)
        assert sum(shares.values()) == 2 and all(v >= 0 for v in shares.values())
        with pytest.raises(ValueError):
            fn({"a": 0.0}, 8)
        with pytest.raises(ValueError):
            fn({"a": 1.0}, 8, reserve=1.5)
    rng = np.random.default_rng(3)
    for _ in range(50):
        k = int(rng.integers(1, 6))
        weights = {f"t{i}": float(w) for i, w in enumerate(rng.uniform(0.1, 5.0, size=k))}
        n, reserve = int(rng.integers(1, 33)), float(rng.uniform(0.0, 1.0))
        assert proportional_shares(weights, n, reserve) == \
            j_proportional_shares(weights, n, reserve)


def test_list_archs_equals_the_reference():
    assert list_archs() == j_list_archs()
    assert all(get_arch(n).cfg.name for n in list_archs())


def test_static_inputs_int64_views_start_even():
    """An int64 view starts at an even entry of the flat int32 buffer;
    device writes land in it and ``upload`` copies its host twin."""
    inp = graphs.StaticInputs({"a": (1,), "ids": ((3,), torch.int64), "s": ((), torch.int64)},
                              torch.device("cpu"))
    assert inp["ids"].dtype == torch.int64 and inp["s"].shape == ()
    assert inp.flat.numel() == 2 + 6 + 2
    inp.put("ids", np.array([2 ** 40, -1, 7], np.int64))
    inp.upload()
    assert inp["ids"].tolist() == [2 ** 40, -1, 7] and inp["a"].tolist() == [0]
    inp["s"].copy_(torch.tensor(-5))
    assert int(inp["s"]) == -5
    with pytest.raises(ValueError, match="int32, float32 or int64"):
        graphs.StaticInputs({"b": ((2,), torch.bfloat16)}, torch.device("cpu"))


def test_step_cache_builds_each_key_once_under_one_hold():
    """A key's step is built at its first use and reused; every step of the
    cache shares its hold, which serialises them across threads."""
    built = []

    def build(key, pool, hold):
        built.append(key)
        inp = graphs.StaticInputs({"x": (key,)}, torch.device("cpu"))
        return graphs.CompiledStep(lambda: inp["x"] + 1, inp, [], torch.device("cpu"),
                                   pool, hold)

    cache = graphs.StepCache(build, torch.device("cpu"))
    for key in (2, 3, 2, 2, 3):
        with cache.exclusive(key) as step:
            assert step.hold is cache.hold and step.inputs["x"].shape == (key,)
            assert step().tolist() == [1] * key
    assert built == [2, 3] and set(cache.steps) == {2, 3} and cache.replays == 0
    order = []

    def user(key):
        with cache.exclusive(key):
            order.append(("in", key))
            order.append(("out", key))

    threads = [threading.Thread(target=user, args=(k,)) for k in (2, 3, 4, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert all(order[i][0] == "in" and order[i + 1] == ("out", order[i][1])
               for i in range(0, len(order), 2))
    assert built == [2, 3, 4]


def _reqs(R, seed: int, lens, rid0: int = 0, template=None):
    rng = np.random.default_rng(seed)
    kw = {} if template is None else dict(template=template)
    return [R(rid=rid0 + i, prompt=rng.integers(1, 200, size=n).astype(np.int32),
              max_new_tokens=5, **kw) for i, n in enumerate(lens)]


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_steps_one_per_bucket_over_one_staging_cache(pairs, paged):
    """Each distinct (batch, prompt) bucket builds one prefill step at its
    first dispatch; later dispatches of the bucket run that step; every
    step writes its view of the one staging cache (``_bucket(n_lanes)``
    lanes of ``max_len`` rows), whatever the number of buckets."""
    _j, _jp, arch, params = pairs("llama3-8b")
    Engine = PagedInferenceEngine if paged else InferenceEngine
    eng = Engine(arch, params, n_lanes=3, max_prompt_len=16, max_len=32, device="cpu")
    staging = eng._prefill_out
    shapes = []
    inner = eng._prefill

    def counted(tokens, plens, out):
        shapes.append(tuple(tokens.shape))
        return inner(tokens, plens, out)

    eng._prefill = counted
    plan = [((3,), (1, 4)), ((5, 9), (2, 16)), ((2,), (1, 2)), ((4, 7, 11), (4, 16)),
            ((13, 1), (2, 16)), ((3,), (1, 4)), ((6, 2, 1), (4, 8))]
    steps = {}
    for k, (lens, bucket) in enumerate(plan):
        staged = eng.prefill_dispatch(_reqs(Request, k, lens))
        assert staged.shape == bucket
        step = eng._prefill_steps.steps[bucket]
        assert steps.setdefault(bucket, step) is step
        for name, stack in staged.cache.items():
            for key, a in stack.items():
                assert a.shape[1] == bucket[0]
                assert a.untyped_storage().data_ptr() != \
                    staging[name][key].untyped_storage().data_ptr()
    assert shapes == [b for _l, b in plan]
    assert set(eng._prefill_steps.steps) == {(1, 4), (2, 16), (1, 2), (4, 16), (4, 8)}
    assert eng._prefill_out is staging
    leaves = [a for stack in staging.values() for a in stack.values()]
    assert all(a.shape[1:3] == (4, 32) for a in leaves)
    ptrs = [a.untyped_storage().data_ptr() for a in leaves]
    for bucket, step in eng._prefill_steps.steps.items():
        assert [t.untyped_storage().data_ptr() for t in step.state[1:]] == ptrs
        assert step.inputs["tokens"].shape == bucket


def _commit_and_tick(eng, staged_list, ticks: int = 4):
    for staged in staged_list:
        eng.commit_prefill(staged)
    for _ in range(ticks):
        out = eng.decode_tick()
        for staged in staged_list:
            for r in staged.requests:
                r.generated.append(out[r.lane])
    return [r.generated for staged in staged_list for r in staged.requests]


@pytest.mark.parametrize("name", ["llama3-8b", "hymba-1.5b"])
def test_staged_prefills_of_one_bucket_keep_their_own_results(pairs, name):
    """Two dispatches of one bucket staged before either is committed: the
    second leaves the first's first tokens and cache as they were (each
    owns a copy, none the staging cache); committed in reverse order, both
    serve the JAX engine's streams."""
    jarch, jparams, arch, params = pairs(name)
    kw = dict(n_lanes=4, max_prompt_len=16, max_len=32)
    a_lens, b_lens = (5, 9), (6, 11)  # both the bucket (2, 16)
    streams = {}
    for side in ("jax", "torch"):
        if side == "jax":
            eng, R = JPagedEngine(jarch, jparams, page_size=8, **kw), JRequest
        else:
            eng = PagedInferenceEngine(arch, params, page_size=8, device="cpu", **kw)
            R = Request
        sa = eng.prefill_dispatch(_reqs(R, 7, a_lens))
        if side == "torch":
            first_a = sa.first.clone()
            cache_a = {n: {k: t.clone() for k, t in st.items()} for n, st in sa.cache.items()}
        sb = eng.prefill_dispatch(_reqs(R, 8, b_lens, rid0=2))
        assert sa.shape == sb.shape == (2, 16)
        if side == "torch":
            assert list(eng._prefill_steps.steps) == [(2, 16)]
            assert torch.equal(sa.first, first_a) and not torch.equal(sa.first, sb.first)
            for n, st in cache_a.items():
                for k, t in st.items():
                    assert torch.equal(sa.cache[n][k], t)
        streams[side] = _commit_and_tick(eng, [sb, sa])
    assert streams["torch"] == streams["jax"]


def test_chunked_first_chunk_takes_the_one_by_chunk_step(pairs):
    """A prompt longer than ``chunk`` prefills its first chunk through the
    (1, ``chunk``) step, the rest through ``_extend``; committed, it serves
    the JAX engine's stream."""
    jarch, jparams, arch, params = pairs("llama3-8b")
    kw = dict(n_lanes=2, max_prompt_len=16, max_len=48)
    streams = {}
    for side in ("jax", "torch"):
        eng = (JPagedEngine(jarch, jparams, page_size=8, **kw) if side == "jax" else
               PagedInferenceEngine(arch, params, page_size=8, device="cpu", **kw))
        staged = eng.prefill_dispatch(_reqs(JRequest if side == "jax" else Request, 9, (21,)),
                                      chunk=8)
        if side == "torch":
            assert list(eng._prefill_steps.steps) == [(1, 8)]
        while not eng.prefill_resume(staged):
            pass
        streams[side] = _commit_and_tick(eng, [staged])
        if side == "torch":
            assert list(eng._prefill_steps.steps) == [(1, 8)]
    assert streams["torch"] == streams["jax"]
