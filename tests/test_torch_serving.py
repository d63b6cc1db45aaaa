"""The port's scheduler and PagedInferenceEngine against the JAX package's.

Reduced llama3-8b in float32, the same weights in both (JAX draws them,
``params_from_numpy`` carries them across), the same prompts.  Greedy
token streams, ``dispatches``, decode steps, prefill calls and KV bytes
moved must be equal exactly: argmax decides on logit gaps far above the
1e-6 by which the two frameworks' float32 sums differ.  Page size 8 and
max_len 32 make lanes cross pages and reach the slot clamp (a lane at
max_len - 1 keeps rewriting its last row).
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import strategies as j_strategies
from repro.models.registry import get_arch as j_get_arch
from repro.serving.paged_kv import PagedInferenceEngine as JPagedEngine
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import ContinuousBatchingScheduler as JScheduler
from repro_torch.core import strategies
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.paged_decode import sample_tokens
from repro_torch.models.registry import get_arch
from repro_torch.serving.engine import HostSpillPool
from repro_torch.serving.paged_kv import PagedInferenceEngine
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import ContinuousBatchingScheduler


@pytest.fixture(scope="module")
def setup():
    jarch = j_get_arch("llama3-8b")
    jarch = dataclasses.replace(jarch, cfg=jarch.cfg.reduced())
    jparams = jarch.init(jax.random.PRNGKey(0))
    arch = get_arch("llama3-8b")
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                arch.cfg, device="cpu")
    return jarch, jparams, arch, tparams


def _traffic(seed: int, n: int, templates=("default",)):
    """``n`` requests; the first one runs past max_len (the slot clamp)."""
    rng = np.random.default_rng(seed)
    out = [dict(rid=i, prompt=rng.integers(1, 256, size=int(m)).astype(np.int32),
                max_new_tokens=int(rng.integers(4, 30)), template=templates[i % len(templates)])
           for i, m in enumerate(rng.integers(2, 17, size=n))]
    out[0].update(prompt=rng.integers(1, 256, size=12).astype(np.int32), max_new_tokens=28)
    return out


def _serve(Engine, Scheduler, RequestCls, strategy, arch, params, traffic, **kw):
    eng = Engine(arch, params, max_prompt_len=16, max_len=32, page_size=8, **kw)
    sched = Scheduler(eng, strategy=strategy)
    reqs = [RequestCls(**t) for t in traffic]
    for r in reqs:
        sched.submit(r)
    sched.producer_done()
    sched.run_until_drained()
    return reqs, eng, sched


CASES = {
    "lanes2-one-or-all": (2, "OneOrAll", {}, ("default",), {}),
    "lanes3-growing-upper": (3, "GrowingUpperThreshold", {"initial_upper": 2},
                             ("default",), {}),
    "lanes4-pure-async": (4, "PureAsync", {}, ("default",), {}),
    "lanes4-templates-shares": (4, "OneOrAll", {}, ("chat", "summarize"),
                                {"kv_shares": {"chat": 1}}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_streams_and_dispatches_equal_reference(setup, case):
    jarch, jparams, arch, tparams = setup
    n_lanes, strat, skw, templates, ekw = CASES[case]
    traffic = _traffic(sorted(CASES).index(case), 7, templates)
    jreqs, jeng, jsched = _serve(JPagedEngine, JScheduler, JRequest,
                                 getattr(j_strategies, strat)(**skw), jarch, jparams,
                                 traffic, n_lanes=n_lanes, **ekw)
    treqs, teng, tsched = _serve(PagedInferenceEngine, ContinuousBatchingScheduler, Request,
                                 getattr(strategies, strat)(**skw), arch, tparams,
                                 traffic, n_lanes=n_lanes, device="cpu", **ekw)
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert all(len(r.generated) == r.max_new_tokens for r in treqs)
    assert max(len(r.prompt) + r.max_new_tokens for r in treqs) > 32  # the clamp is hit
    for attr in ("dispatches", "decode_steps", "prefill_calls", "kv_bytes_moved"):
        assert getattr(teng, attr) == getattr(jeng, attr), attr
    assert tsched.stats.admission_trace == jsched.stats.admission_trace
    assert teng.pool.snapshot() == jeng.pool.snapshot()  # every page returned
    assert teng.pool.n_free_pages == teng.n_pages


def test_streams_equal_reference_pallas_interpret(setup):
    """The same equality against the JAX engine running its Pallas paged
    kernel under interpret mode."""
    jarch, jparams, arch, tparams = setup
    traffic = _traffic(11, 5)
    strat = "GrowingUpperThreshold"
    jreqs, jeng, _ = _serve(JPagedEngine, JScheduler, JRequest,
                            getattr(j_strategies, strat)(initial_upper=2), jarch, jparams,
                            traffic, n_lanes=3, interpret=True)
    treqs, teng, _ = _serve(PagedInferenceEngine, ContinuousBatchingScheduler, Request,
                            getattr(strategies, strat)(initial_upper=2), arch, tparams,
                            traffic, n_lanes=3, device="cpu")
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert teng.dispatches == jeng.dispatches


def test_engine_lane_lifecycle(setup):
    """admit → decode ticks → retire, driven by hand: block tables grow one
    page per page boundary, lengths stop at max_len - 1, retire frees the
    lane's pages."""
    _jarch, _jp, arch, tparams = setup
    eng = PagedInferenceEngine(arch, tparams, n_lanes=2, max_prompt_len=16, max_len=32,
                               page_size=8, device="cpu")
    r = Request(rid=0, prompt=np.arange(1, 8, dtype=np.int32), max_new_tokens=40)
    assert eng.admit([r]) == (1, 8)
    lane = r.lane
    assert len(eng.pool.pages(lane)) == 1 and int(eng.lengths[lane]) == 7
    for step in range(30):
        out = eng.decode_tick()
        assert set(out) == {lane}
        want_pages = min(4, (min(7 + step, 31)) // 8 + 1)
        assert len(eng.pool.pages(lane)) == want_pages
    assert int(eng.lengths[lane]) == 31 and eng.decode_steps == 30
    assert eng.dispatches == 31
    eng.retire(lane)
    assert eng.pool.n_free_pages == eng.n_pages and eng.decode_tick() == {}


def test_device_tables_and_trash_page(setup):
    """Tableless lanes read page 0 (masked by length); no table ever holds
    the trash page n_pages."""
    _jarch, _jp, arch, tparams = setup
    eng = PagedInferenceEngine(arch, tparams, n_lanes=3, max_prompt_len=16, max_len=32,
                               page_size=8, device="cpu")
    reqs = [Request(rid=i, prompt=np.arange(1, 4 + 9 * i, dtype=np.int32)) for i in range(2)]
    eng.admit(reqs)
    tabs = eng._device_tables()
    assert tabs.dtype == torch.int32 and tuple(tabs.shape) == (3, 4)
    free = [lane for lane in range(3) if not eng.pool.has_table(lane)]
    assert free and all(not tabs[lane].any() for lane in free)
    for k in eng.cache["layers"].values():
        assert k.shape[1] == eng.n_pages + 1
    assert int(tabs.max()) < eng.n_pages


def test_cow_guard_forks_an_aliased_write_page(setup):
    """A decode write into a page another table aliases forks a private
    copy first (placement through the pool, contents by one page copy):
    the other reader's page keeps its rows, the writer continues on the
    copy."""
    _jarch, _jp, arch, tparams = setup
    eng = PagedInferenceEngine(arch, tparams, n_lanes=2, max_prompt_len=16, max_len=32,
                               page_size=8, device="cpu")
    r = Request(rid=0, prompt=np.arange(1, 6, dtype=np.int32), max_new_tokens=8)
    eng.admit([r])
    (shared,) = eng.pool.pages(r.lane)
    eng.pool.share(r.lane, "reader")
    before = {k: a[:, shared].clone() for k, a in eng.cache["layers"].items()}
    eng.decode_tick()
    (mine,) = eng.pool.pages(r.lane)
    assert mine != shared and eng.pool.pages("reader") == (shared,)
    assert eng.pool.page_ref(shared) == 1 and eng.pool.page_ref(mine) == 1
    for k, a in eng.cache["layers"].items():
        torch.testing.assert_close(a[:, shared], before[k], rtol=0, atol=0)
        torch.testing.assert_close(a[:, mine, :5], before[k][:, :5], rtol=0, atol=0)
        assert not torch.equal(a[:, mine, 5], before[k][:, 5])  # the new row


@pytest.mark.parametrize("kw, match", [
    ({"prefix_share": True}, "prefix sharing"),
    ({"n_pages": 4}, "oversubscribed"),
    ({"kv_spill": HostSpillPool(4)}, "spill"),
])
def test_unported_modes_raise(setup, kw, match):
    _jarch, _jp, arch, tparams = setup
    with pytest.raises(NotImplementedError, match=match):
        PagedInferenceEngine(arch, tparams, n_lanes=2, max_prompt_len=16, max_len=32,
                             page_size=8, device="cpu", **kw)


def test_chunked_prefill_raises(setup):
    _jarch, _jp, arch, tparams = setup
    eng = PagedInferenceEngine(arch, tparams, n_lanes=2, max_prompt_len=16, max_len=32,
                               page_size=8, device="cpu")
    r = Request(rid=0, prompt=np.arange(1, 12, dtype=np.int32))
    with pytest.raises(NotImplementedError):
        eng.prefill_dispatch([r], chunk=4)
    with pytest.raises(NotImplementedError):
        eng.stage_chunk(eng.prefill_dispatch([r]))


# ------------------------------------------------------- temperature > 0

def test_sampling_draw_depends_on_seed_and_position_only():
    """A positive-temperature draw is a function of (logits, temperature,
    seed, position): it repeats at another lane index and beside other
    lanes, and temperature-0 lanes in the same batch stay argmax."""
    rng = np.random.default_rng(0)
    row = torch.from_numpy(rng.standard_normal(64, dtype=np.float32) * 3)
    other = torch.from_numpy(rng.standard_normal((3, 64), dtype=np.float32))

    def draw(lane, seed, pos, temp=0.9):
        logits = torch.cat([other[:lane], row[None], other[lane:]])
        temps = np.zeros(4, np.float32)
        seeds = np.full(4, 99, np.int32)
        lengths = np.full(4, 5, np.int32)
        temps[lane], seeds[lane], lengths[lane] = temp, seed, pos
        out = sample_tokens(logits, temps, seeds, lengths)
        cold = [i for i in range(4) if i != lane]
        assert torch.equal(out[cold], logits[cold].argmax(-1).to(torch.int32))
        return int(out[lane])

    for seed, pos in [(1, 0), (1, 7), (2, 7), (123456, 31)]:
        assert len({draw(lane, seed, pos) for lane in range(4)}) == 1
    assert len({draw(0, 1, pos) for pos in range(40)}) > 1
    assert len({draw(0, seed, 3) for seed in range(40)}) > 1
    assert draw(2, 5, 5, temp=1e-4) == int(row.argmax())


def test_sampled_streams_repeat_across_lane_assignment(setup):
    """Served through the engine, a sampled request's stream is the same
    whatever lane it lands in and whichever greedy request shares the
    batch."""
    _jarch, _jp, arch, tparams = setup
    rng = np.random.default_rng(5)
    hot = dict(prompt=rng.integers(1, 256, size=9).astype(np.int32), max_new_tokens=20,
               temperature=0.8, sample_seed=42)
    cold = [dict(prompt=rng.integers(1, 256, size=n).astype(np.int32), max_new_tokens=20)
            for n in (6, 11)]
    streams = []
    for batch in ([cold[0], hot], [hot, cold[1]]):
        traffic = [dict(rid=i, **t) for i, t in enumerate(batch)]
        reqs, _eng, _ = _serve(PagedInferenceEngine, ContinuousBatchingScheduler, Request,
                               strategies.OneOrAll(), arch, tparams, traffic,
                               n_lanes=2, device="cpu")
        (r,) = [r for r in reqs if r.temperature > 0]
        assert all(0 <= t < arch.cfg.vocab_size for t in r.generated)
        streams.append(r.generated)
    assert streams[0] == streams[1]
