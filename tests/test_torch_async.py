"""The port's asynchronous serving path against the JAX package's engines.

The dense ``InferenceEngine`` (one-token ``decode_step`` over the stacked
lane cache), chunked prefill (``prefill_dispatch(chunk=)`` /
``prefill_resume``), the scheduler's ``overlap=True`` speculation thread,
the paged engine's fused chunk tick (``stage_chunk``) and dense host
spill/restore.  Each scenario mirrors one of the reference's own tests
(named in its docstring) and runs it on both packages: reduced llama3-8b
in float32, the JAX weights carried across with ``params_from_numpy``,
the same prompts.  Greedy token streams and the ``dispatches``,
``decode_steps``, ``prefill_calls`` and ``kv_bytes_moved`` counters must
be equal exactly (argmax decides on logit gaps far above the 1e-6 by
which the two frameworks' float32 sums differ).  With the default
``spec_depth=1`` the scheduler joins its one speculation thread at every
tick boundary, so even overlap runs admit in a fixed order; streams are
still compared per request.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

from repro.core import strategies as j_strategies
from repro.models.registry import get_arch as j_get_arch
from repro.serving.engine import HostSpillPool as JHostSpillPool
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.paged_kv import PagedInferenceEngine as JPagedEngine
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import ContinuousBatchingScheduler as JScheduler
from repro_torch.core import strategies
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import get_arch
from repro_torch.serving.engine import HostSpillPool, InferenceEngine
from repro_torch.serving.paged_kv import PagedInferenceEngine
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import ContinuousBatchingScheduler

COUNTERS = ("dispatches", "decode_steps", "prefill_calls", "kv_bytes_moved")


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


@dataclasses.dataclass
class Side:
    """One package's engine classes, arch and weights."""

    Engine: type
    Paged: type
    Scheduler: type
    Request: type
    Spill: type
    strategies: object
    arch: object
    params: object
    kw: dict

    def engine(self, paged: bool = False, **kw):
        cls = self.Paged if paged else self.Engine
        return cls(self.arch, self.params, **kw, **self.kw)


def _sides(setup):
    jarch, jparams, arch, tparams = setup
    return (Side(JEngine, JPagedEngine, JScheduler, JRequest, JHostSpillPool,
                 j_strategies, jarch, jparams, {}),
            Side(InferenceEngine, PagedInferenceEngine, ContinuousBatchingScheduler,
                 Request, HostSpillPool, strategies, arch, tparams, {"device": "cpu"}))


def _counters(eng) -> dict:
    return {a: getattr(eng, a) for a in COUNTERS}


def _run(side, eng, traffic, strategy="OneOrAll", skw=None, **kw):
    sched = side.Scheduler(eng, strategy=getattr(side.strategies, strategy)(**(skw or {})),
                           **kw)
    reqs = [side.Request(**t) for t in traffic]
    for r in reqs:
        sched.submit(r)
    sched.producer_done()
    sched.run_until_drained()
    return reqs, sched


# ------------------------------------------------------------ dense engine

def _traffic(seed: int, n: int, templates=("default",)):
    """``n`` requests; the first one runs past max_len (the slot clamp)."""
    rng = np.random.default_rng(seed)
    out = [dict(rid=i, prompt=rng.integers(1, 256, size=int(m)).astype(np.int32),
                max_new_tokens=int(rng.integers(4, 30)), template=templates[i % len(templates)])
           for i, m in enumerate(rng.integers(2, 17, size=n))]
    out[0].update(prompt=rng.integers(1, 256, size=12).astype(np.int32), max_new_tokens=28)
    return out


CASES = {
    "lanes2-one-or-all": (2, "OneOrAll", {}, ("default",), {}),
    "lanes3-growing-upper": (3, "GrowingUpperThreshold", {"initial_upper": 2},
                             ("default",), {}),
    "lanes4-templates-shares": (4, "OneOrAll", {}, ("chat", "summarize"),
                                {"kv_shares": {"chat": 1}}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_engine_streams_and_counters_equal_reference(setup, case):
    """The dense engine under the scheduler: every lane decodes each tick
    through ``decode_step``, lengths stop at max_len - 1 (the first
    request runs past max_len 32), commits move whole lanes."""
    n_lanes, strat, skw, templates, ekw = CASES[case]
    traffic = _traffic(sorted(CASES).index(case) + 20, 7, templates)
    out = []
    for side in _sides(setup):
        eng = side.engine(n_lanes=n_lanes, max_prompt_len=16, max_len=32, **ekw)
        reqs, sched = _run(side, eng, traffic, strat, skw)
        out.append(([r.generated for r in reqs], _counters(eng),
                    sched.stats.admission_trace))
    assert out[1] == out[0]
    assert all(len(g) == t["max_new_tokens"] for g, t in zip(out[1][0], traffic))
    assert max(len(t["prompt"]) + t["max_new_tokens"] for t in traffic) > 32


# --------------------------------------------------------- chunked prefill

def test_engine_chunked_prefill_matches_one_shot(setup):
    """Mirrors ``tests/test_serving.py::test_engine_chunked_prefill_matches_one_shot``:
    dispatch(chunk=4) + three resumes + commit generates exactly the
    tokens one-shot admit does; a prompt that fits one chunk takes the
    one-shot path."""
    rng = np.random.default_rng(21)
    prompt = rng.integers(1, 200, size=13).astype(np.int32)
    out = []
    for side in _sides(setup):
        eng1 = side.engine(n_lanes=2, max_prompt_len=16, max_len=48)
        r1 = side.Request(rid=0, prompt=prompt, max_new_tokens=6)
        eng1.admit([r1], template="t")
        for _ in range(5):
            r1.generated.append(eng1.decode_tick()[r1.lane])
        eng2 = side.engine(n_lanes=2, max_prompt_len=16, max_len=48)
        r2 = side.Request(rid=1, prompt=prompt, max_new_tokens=6)
        staged = eng2.prefill_dispatch([r2], template="t", chunk=4)
        assert not staged.complete and staged.first is None
        resumes = 0
        while not eng2.prefill_resume(staged):
            resumes += 1
        assert resumes + 1 == 3  # ceil((13 - 4) / 4) chunks after the first
        eng2.commit_prefill(staged)
        for _ in range(5):
            r2.generated.append(eng2.decode_tick()[r2.lane])
        assert r2.generated == r1.generated
        short = side.Request(rid=2, prompt=prompt[:3], max_new_tokens=2)
        st = eng2.prefill_dispatch([short], template="t", chunk=4)
        assert st.complete and st.first is not None
        out.append((r1.generated, _counters(eng1), _counters(eng2)))
    assert out[1] == out[0]
    assert out[1][2]["dispatches"] == 1 + 3 + 5 + 1  # prefill, resumes, ticks, short


def test_batched_chunk_parent_resumes_part_by_part(setup):
    """Two oversized prompts dispatched together become one parent of two
    parts; each resume advances one chunk of the first incomplete part,
    and commit delegates to the parts in order."""
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, 200, size=n).astype(np.int32) for n in (10, 7)]
    out = []
    for side in _sides(setup):
        eng = side.engine(n_lanes=2, max_prompt_len=16, max_len=32)
        reqs = [side.Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
        staged = eng.prefill_dispatch(reqs, template="t", chunk=4)
        assert len(staged.parts) == 2 and staged.cache is None
        n = 0
        while not eng.prefill_resume(staged):
            n += 1
        assert n + 1 == 2 + 1  # part 0: two more chunks, part 1: one
        eng.commit_prefill(staged)
        for _ in range(3):
            toks = eng.decode_tick()
            for r in reqs:
                r.generated.append(toks[r.lane])
        out.append(([r.generated for r in reqs], [r.lane for r in reqs], _counters(eng)))
    assert out[1] == out[0]


def test_scheduler_chunked_prefill_overlaps_and_matches(setup):
    """Mirrors ``tests/test_serving.py::test_scheduler_chunked_prefill_overlaps_and_matches``:
    a prompt over ``chunk_tokens`` rides the speculation thread one chunk
    per tick on the dense engine and still produces the one-shot tokens,
    while other lanes keep decoding."""
    rng = np.random.default_rng(22)
    big_prompt = rng.integers(1, 200, size=14).astype(np.int32)
    smalls = [rng.integers(1, 200, 4).astype(np.int32) for _ in range(3)]
    out = []
    for side in _sides(setup):
        ref_eng = side.engine(n_lanes=4, max_prompt_len=16, max_len=48)
        (ref,), _ = _run(side, ref_eng, [dict(rid=0, prompt=big_prompt, max_new_tokens=5)])
        eng = side.engine(n_lanes=4, max_prompt_len=16, max_len=48)
        sched = side.Scheduler(eng, strategy=side.strategies.OneOrAll(),
                               overlap=True, chunk_tokens=4)
        big = side.Request(rid=1, prompt=big_prompt, max_new_tokens=5, template="big")
        small = [side.Request(rid=10 + i, prompt=p, max_new_tokens=4, template="small")
                 for i, p in enumerate(smalls)]
        sched.submit(small[0])
        sched.tick()  # occupy a lane so decode has work under the chunks
        sched.submit(big)
        for r in small[1:]:
            sched.submit(r)
        sched.producer_done()
        done = sched.run_until_drained()
        assert len(done) == 4
        assert big.generated == ref.generated  # chunked == one-shot
        assert sched.stats.spec_chunks >= 2 and big.metrics.speculative
        out.append(({r.rid: r.generated for r in [big, *small]}, _counters(eng),
                    sched.stats.spec_chunks, sched.stats.spec_committed))
    assert out[1] == out[0]


# -------------------------------------------------------------------- spill

def test_spill_restore_round_trip_preserves_decode_output(setup):
    """Mirrors ``tests/test_serving.py::test_spill_restore_round_trip_preserves_decode_output``:
    a straggler whose lane is retired after 2 ticks spills its KV to the
    host pool and resumes on re-admission with its tokens intact, never
    re-prefilled; whole-lane bytes are counted both ways."""
    rng = np.random.default_rng(31)
    prompt = rng.integers(1, 200, size=9).astype(np.int32)
    out = []
    for side in _sides(setup):
        ref_eng = side.engine(n_lanes=2, max_prompt_len=16, max_len=48)
        (ref,), _ = _run(side, ref_eng, [dict(rid=0, prompt=prompt, max_new_tokens=8)])
        eng = side.engine(n_lanes=2, max_prompt_len=16, max_len=48,
                          kv_spill=side.Spill(max_entries=4))
        (r,), sched = _run(side, eng, [dict(rid=1, prompt=prompt, max_new_tokens=8)],
                           lane_timeout=2)
        st = sched.stats
        assert st.kv_spilled >= 1 and st.kv_restored == st.kv_spilled
        assert r.generated == ref.generated and eng.prefill_calls == 1
        assert eng.kv_spill.snapshot()["restored"] == st.kv_restored
        out.append((r.generated, _counters(eng), st.kv_spilled, eng.kv_spill.snapshot()))
    assert out[1] == out[0]


def test_spill_without_pool_is_a_plain_retire(setup):
    """No pool (or a template fenced out of it): spill retires the lane,
    stages nothing and moves no bytes."""
    _j, _jp, arch, tparams = setup
    budgets = {"fenced": 0}
    for spill in (None, HostSpillPool(4, budget_for=budgets.get)):
        eng = InferenceEngine(arch, tparams, n_lanes=2, max_prompt_len=16, max_len=32,
                              device="cpu", kv_spill=spill)
        r = Request(rid=0, prompt=np.arange(1, 6, dtype=np.int32), template="fenced")
        eng.admit([r], template="fenced")
        moved = eng.kv_bytes_moved
        assert eng.spill(r.lane, key=0, template="fenced") is False
        assert eng.kv_bytes_moved == moved and not eng.has_spill(0)
        assert eng.try_restore(0, "fenced") is None and eng.n_free == 2


# ------------------------------------------------------------ fused ticks

def test_fused_tick_is_one_dispatch_and_exact(setup):
    """Mirrors ``tests/test_paged_compute.py::test_fused_tick_is_one_dispatch_and_exact``:
    a paged decode tick that folds a staged prefill chunk raises
    ``dispatches`` by exactly 1, and both the decode lane's tokens and the
    chunked prompt's first token match the unfused dense engine."""
    rng = np.random.default_rng(29)
    p0 = rng.integers(1, 200, size=6).astype(np.int32)
    pbig = rng.integers(1, 200, size=13).astype(np.int32)
    out = []
    for side in _sides(setup):
        eng = side.engine(paged=True, n_lanes=2, max_prompt_len=16, max_len=32,
                          page_size=8)
        r0 = side.Request(rid=0, prompt=p0, max_new_tokens=12)
        eng.admit([r0], None)
        big = side.Request(rid=1, prompt=pbig, max_new_tokens=4)
        staged = eng.prefill_dispatch([big], template=None, chunk=4)
        assert staged.pending and not staged.complete
        fused_ticks = 0
        while not staged.complete:
            assert eng.stage_chunk(staged)
            assert not eng.stage_chunk(staged)  # one chunk per tick
            before = eng.dispatches
            r0.generated.append(eng.decode_tick()[r0.lane])
            assert eng.dispatches - before == 1  # decode + chunk, one dispatch
            fused_ticks += 1
        assert eng.fused_folds == fused_ticks and fused_ticks >= 2
        assert not eng.stage_chunk(staged)  # nothing pending: fusion declines
        eng.commit_prefill(staged)

        dense = side.engine(n_lanes=2, max_prompt_len=16, max_len=32)
        d0 = side.Request(rid=0, prompt=p0, max_new_tokens=12)
        dense.admit([d0], None)
        for _ in range(fused_ticks):
            d0.generated.append(dense.decode_tick()[d0.lane])
        dbig = side.Request(rid=1, prompt=pbig, max_new_tokens=4)
        dense.admit([dbig], None)
        assert r0.generated == d0.generated
        assert big.generated == dbig.generated  # the first token each
        out.append((r0.generated, big.generated, _counters(eng), eng.fused_folds))
    assert out[1] == out[0]


def test_fused_chunk_without_active_lanes_resumes_plainly(setup):
    """A staged chunk whose tick finds no active lane (the last one
    retired after staging) is resumed on its own: one dispatch, no fold,
    no decode step."""
    _j, _jp, arch, tparams = setup
    eng = PagedInferenceEngine(arch, tparams, n_lanes=2, max_prompt_len=16, max_len=32,
                               page_size=8, device="cpu")
    r0 = Request(rid=0, prompt=np.arange(1, 6, dtype=np.int32))
    eng.admit([r0])
    staged = eng.prefill_dispatch([Request(rid=1, prompt=np.arange(1, 12, dtype=np.int32))],
                                  chunk=4)
    assert eng.stage_chunk(staged)
    eng.retire(r0.lane)
    before = (eng.dispatches, eng.decode_steps)
    assert eng.decode_tick() == {}
    assert (eng.dispatches, eng.decode_steps) == (before[0] + 1, before[1])
    assert eng.fused_folds == 0 and len(staged.pending) == 1
    assert not eng.stage_chunk(staged)  # no active lane: fusion declines


OVERLAP = {
    "one-or-all-chunk4": ("OneOrAll", {}, 4, 4),
    "growing-upper-chunk5": ("GrowingUpperThreshold", {"initial_upper": 2}, 5, 3),
}


@pytest.mark.parametrize("case", sorted(OVERLAP))
def test_fused_overlap_scheduler_matches_dense_and_reference(setup, case):
    """Mirrors ``tests/test_paged_compute.py::test_fused_overlap_scheduler_bit_identical``:
    overlap + chunked serving on the paged engine folds chunks into decode
    ticks and gives the dense engine's streams; the paged and dense runs
    each equal the JAX engine's, counters included."""
    strat, skw, chunk, n_lanes = OVERLAP[case]
    rng = np.random.default_rng(31 + sorted(OVERLAP).index(case))
    prompts = [rng.integers(1, 200, size=n).astype(np.int32) for n in (5, 13, 7, 15, 3, 11)]
    traffic = [dict(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    out = []
    for side in _sides(setup):
        runs = {}
        for paged in (False, True):
            kw = dict(page_size=8) if paged else {}
            eng = side.engine(paged=paged, n_lanes=n_lanes, max_prompt_len=16, max_len=48,
                              **kw)
            reqs, sched = _run(side, eng, traffic, strat, skw, overlap=True,
                               chunk_tokens=chunk)
            assert all(len(r.generated) == 6 for r in reqs)
            runs[paged] = ({r.rid: r.generated for r in reqs}, _counters(eng),
                           sched.stats.spec_chunks,
                           getattr(eng, "fused_folds", None))
        assert runs[True][0] == runs[False][0]  # paged + fused == dense
        assert runs[True][2] >= 2 and runs[True][3] >= 1
        out.append(runs)
    assert out[1] == out[0]
