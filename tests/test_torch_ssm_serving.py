"""The port's serving of mamba2 (the dense engine) against the JAX package.

Reduced mamba2-1.3b in float32, the JAX weights carried across with
``params_from_numpy``, the same requests through the port's
``ContinuousBatchingScheduler`` over its ``InferenceEngine`` and through
the JAX package's.  An SSM stack's lane cache is ``{"ssm" (L, lanes, H,
P, N) float32, "conv" (L, lanes, K-1, Ch)}``: commits, spill and restore
move whole lanes of both, and chunked prefill feeds the tokens past the
first chunk through the one-token recurrent decode.  Greedy token streams
and the ``dispatches``, ``decode_steps``, ``prefill_calls`` and
``kv_bytes_moved`` counters must be equal exactly (argmax decides on logit
gaps far above the 1e-6 by which the two frameworks' float32 sums differ).

The prompts are ragged on purpose: the dense engine right-pads every
batch to a power-of-two bucket, and an SSM's state runs over the pad
tokens in both packages (``tests/test_torch_ssm.py`` pins that).
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
    jarch = j_get_arch("mamba2-1.3b")
    jarch = dataclasses.replace(jarch, cfg=jarch.cfg.reduced())
    jparams = jarch.init(jax.random.PRNGKey(0))
    arch = get_arch("mamba2-1.3b")
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                arch.cfg, device="cpu")
    return jarch, jparams, arch, tparams


@dataclasses.dataclass
class Side:
    """One package's engine classes, arch and weights."""

    Engine: type
    Scheduler: type
    Request: type
    Spill: type
    strategies: object
    arch: object
    params: object
    kw: dict

    def engine(self, **kw):
        return self.Engine(self.arch, self.params, **kw, **self.kw)


def _sides(setup):
    jarch, jparams, arch, tparams = setup
    return (Side(JEngine, JScheduler, JRequest, JHostSpillPool, j_strategies, jarch,
                 jparams, {}),
            Side(InferenceEngine, ContinuousBatchingScheduler, Request, HostSpillPool,
                 strategies, arch, tparams, {"device": "cpu"}))


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


def _traffic(seed: int, n: int, templates=("default",), lo=2, hi=17):
    """``n`` ragged requests; the first one runs past max_len 32."""
    rng = np.random.default_rng(seed)
    out = [dict(rid=i, prompt=rng.integers(1, 256, size=int(m)).astype(np.int32),
                max_new_tokens=int(rng.integers(4, 20)), template=templates[i % len(templates)])
           for i, m in enumerate(rng.integers(lo, hi, size=n))]
    out[0].update(prompt=rng.integers(1, 256, size=12).astype(np.int32), max_new_tokens=24)
    return out


CASES = {
    "lanes2-one-or-all": (2, "OneOrAll", {}, ("default",), {}),
    "lanes3-growing-upper": (3, "GrowingUpperThreshold", {"initial_upper": 2},
                             ("default",), {}),
    "lanes4-templates-shares": (4, "OneOrAll", {}, ("chat", "summarize"),
                                {"kv_shares": {"chat": 1}}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ssm_dense_engine_streams_and_counters_equal_reference(setup, case):
    """Ragged, right-padded prefill batches; every lane decodes each tick
    through the recurrent step (inactive lanes too, overwritten by the
    next commit); commits move whole ``ssm``/``conv`` lanes."""
    n_lanes, strat, skw, templates, ekw = CASES[case]
    traffic = _traffic(sorted(CASES).index(case) + 40, 7, templates)
    out = []
    for side in _sides(setup):
        eng = side.engine(n_lanes=n_lanes, max_prompt_len=16, max_len=32, **ekw)
        reqs, sched = _run(side, eng, traffic, strat, skw)
        out.append(([r.generated for r in reqs], _counters(eng),
                    sched.stats.admission_trace))
    assert out[1] == out[0]
    assert all(len(g) == t["max_new_tokens"] for g, t in zip(out[1][0], traffic))
    assert any(len(t["prompt"]) & (len(t["prompt"]) - 1) for t in traffic)  # padded


def test_ssm_engine_commit_moves_whole_state_lanes(setup):
    """One admit: the padded batch's state lands in the allocated lanes,
    and ``kv_bytes_moved`` counts both arrays' whole lanes."""
    _j, _jp, arch, tparams = setup
    eng = InferenceEngine(arch, tparams, n_lanes=4, max_prompt_len=16, max_len=32,
                          device="cpu")
    reqs = [Request(rid=i, prompt=np.arange(1, n + 1, dtype=np.int32))
            for i, n in enumerate((5, 11, 3))]
    staged = eng.prefill_dispatch(reqs)
    assert staged.shape == (4, 16)
    eng.commit_prefill(staged)
    cfg = arch.cfg
    lane_bytes = cfg.n_layers * (4 * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state
                                 + 4 * (cfg.ssm_conv - 1)
                                 * (cfg.ssm_heads * cfg.ssm_head_dim + 2 * cfg.ssm_state))
    assert eng.kv_bytes_moved == 3 * lane_bytes
    for i, r in enumerate(reqs):
        for k in ("ssm", "conv"):
            assert np.array_equal(eng.cache["layers"][k][:, r.lane].numpy(),
                                  staged.cache["layers"][k][:, i].numpy())


def test_ssm_chunked_prefill_and_batched_parts_equal_reference(setup):
    """``prefill_dispatch(chunk=4)`` of one 13-token prompt and of two
    oversized prompts together (a parent of two parts): every resume feeds
    one chunk through the recurrent decode; commit and a few ticks give
    the JAX engine's tokens and counters."""
    rng = np.random.default_rng(41)
    big = rng.integers(1, 200, size=13).astype(np.int32)
    pair = [rng.integers(1, 200, size=n).astype(np.int32) for n in (10, 7)]
    out = []
    for side in _sides(setup):
        eng = side.engine(n_lanes=3, max_prompt_len=16, max_len=48)
        r = side.Request(rid=0, prompt=big, max_new_tokens=6)
        staged = eng.prefill_dispatch([r], template="t", chunk=4)
        resumes = 0
        while not eng.prefill_resume(staged):
            resumes += 1
        assert resumes + 1 == 3
        eng.commit_prefill(staged)
        reqs = [side.Request(rid=1 + i, prompt=p, max_new_tokens=4) for i, p in enumerate(pair)]
        parent = eng.prefill_dispatch(reqs, template="t", chunk=4)
        assert len(parent.parts) == 2
        while not eng.prefill_resume(parent):
            pass
        eng.commit_prefill(parent)
        for _ in range(4):
            toks = eng.decode_tick()
            for q in [r, *reqs]:
                q.generated.append(toks[q.lane])
        out.append(([q.generated for q in [r, *reqs]], _counters(eng)))
    assert out[1] == out[0]


OVERLAP = {
    "one-or-all-chunk4": ("OneOrAll", {}, 4, 4),
    "growing-upper-chunk5": ("GrowingUpperThreshold", {"initial_upper": 2}, 5, 3),
}


@pytest.mark.parametrize("case", sorted(OVERLAP))
def test_ssm_overlap_chunked_scheduler_equals_reference(setup, case):
    """``overlap=True`` with ``chunk_tokens``: prefills and chunk resumes
    ride the speculation thread while the main thread decodes; ragged
    prompts, some longer than a chunk."""
    strat, skw, chunk, n_lanes = OVERLAP[case]
    rng = np.random.default_rng(51 + sorted(OVERLAP).index(case))
    prompts = [rng.integers(1, 200, size=n).astype(np.int32) for n in (5, 13, 7, 15, 3, 11)]
    traffic = [dict(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    out = []
    for side in _sides(setup):
        eng = side.engine(n_lanes=n_lanes, max_prompt_len=16, max_len=48)
        reqs, sched = _run(side, eng, traffic, strat, skw, overlap=True, chunk_tokens=chunk)
        assert all(len(r.generated) == 6 for r in reqs)
        assert sched.stats.spec_chunks >= 2 and sched.stats.spec_crashes == 0
        out.append(({r.rid: r.generated for r in reqs}, _counters(eng),
                    sched.stats.spec_chunks))
    assert out[1] == out[0]


def test_ssm_spill_restore_equals_reference(setup):
    """A straggler whose lane is retired after 2 ticks spills its state to
    the host pool and resumes on re-admission, never re-prefilled; whole
    lanes of both arrays are counted both ways, and the stream equals an
    unspilled run's."""
    rng = np.random.default_rng(61)
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
        out.append((r.generated, _counters(eng), st.kv_spilled, eng.kv_spill.snapshot()))
    assert out[1] == out[0]


def test_paged_engine_still_refuses_ssm(setup):
    """The paged engine's dense-compute mode (how the reference pages SSM
    stacks) is not ported: it raises."""
    _j, _jp, arch, tparams = setup
    with pytest.raises(NotImplementedError, match="dense-compute"):
        PagedInferenceEngine(arch, tparams, n_lanes=2, max_prompt_len=16, max_len=32,
                             page_size=8, device="cpu")
