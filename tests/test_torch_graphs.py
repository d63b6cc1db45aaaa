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

Also here: the registry's capture tally across threads, the device
sampler (greedy lanes against ``jnp.argmax``, draws against the softmax),
and twins of the two public functions the port lacked,
``serving/engine.py::proportional_shares`` and
``models/registry.py::list_archs``.
"""
from __future__ import annotations

import dataclasses
import threading

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
