"""The port's PagedInferenceEngine against the JAX package's, mode by mode.

Twins of the reference's engine tests (``tests/test_prefix_share.py``,
``tests/test_paged_kv.py``, ``tests/test_paged_compute.py``): prefix
sharing with ``_shared_tail``, copy-on-write forks, partial eviction of a
shared reader, spill/restore with a prefetch tail, oversubscribed pools
with mid-decode eviction, page quotas, ``paged_view``, the
dense-compute mode that pages mamba2's state, and ``ChaosEngine``'s
seeded lane crashes over the paged and the dense engine.  Each test runs the same
traffic through both packages on the same weights (JAX draws them,
``params_from_numpy`` carries them across) in float32: reduced llama3-8b,
and reduced mamba2 for dense-compute.  Greedy streams and the counters
(``dispatches``, ``decode_steps``, ``prefill_calls``, ``kv_bytes_moved``,
``prefix_hits``, ``prefill_flops_saved``, ``prefill_flops_total``,
``page_evictions``) and the pool's ``snapshot()`` must be equal exactly:
argmax decides on logit gaps far above the 1e-6 by which the two
frameworks' float32 sums differ.  The reference's own invariants (shared =
unshared, evict/restore = no evict, paged = dense) are checked within the
port as well.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import faults as j_faults
from repro.core import resilience as j_resilience
from repro.core import strategies as j_strategies
from repro.models.registry import get_arch as j_get_arch
from repro.serving.engine import HostSpillPool as JHostSpillPool
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.engine import KVPartition as JKVPartition
from repro.serving.paged_kv import PagedInferenceEngine as JPagedEngine
from repro.serving.paged_kv import PagedKVPool as JPagedKVPool
from repro.serving.paged_kv import PagedKVView as JPagedKVView
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import ContinuousBatchingScheduler as JScheduler
from repro_torch.core import faults, resilience, strategies
from repro_torch.kernels.decode_attention.ref import decode_ref
from repro_torch.kernels.paged_attention.ops import paged_decode_op
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import get_arch
from repro_torch.serving.engine import HostSpillPool, InferenceEngine, KVPartition
from repro_torch.serving.paged_kv import PagedInferenceEngine, PagedKVPool, PagedKVView
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import ContinuousBatchingScheduler

COUNTERS = ("dispatches", "decode_steps", "prefill_calls", "kv_bytes_moved",
            "prefix_hits", "prefill_flops_saved", "prefill_flops_total",
            "page_evictions")


@dataclasses.dataclass
class Side:
    """One package's engine classes, arch and weights."""

    name: str
    Paged: type
    Dense: type
    Scheduler: type
    Request: type
    Spill: type
    strategies: object
    faults: object
    resilience: object
    arch: object
    params: object
    kw: dict

    def paged(self, **kw):
        return self.Paged(self.arch, self.params, **kw, **self.kw)

    def dense(self, **kw):
        return self.Dense(self.arch, self.params, **kw, **self.kw)

    def leaves(self, cache) -> list:
        """Copies of the cache's arrays as numpy, in JAX's (sorted-key)
        leaf order (the port updates its cache in place)."""
        if self.name == "jax":
            return [np.array(a) for a in jax.tree_util.tree_leaves(cache)]
        return [cache[n][k].numpy().copy() for n in sorted(cache) for k in sorted(cache[n])]


def _make_sides(name: str):
    jarch = j_get_arch(name)
    jarch = dataclasses.replace(jarch, cfg=jarch.cfg.reduced())
    jparams = jarch.init(jax.random.PRNGKey(0))
    arch = get_arch(name)
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                arch.cfg, device="cpu")
    return (Side("jax", JPagedEngine, JEngine, JScheduler, JRequest, JHostSpillPool,
                 j_strategies, j_faults, j_resilience, jarch, jparams, {}),
            Side("torch", PagedInferenceEngine, InferenceEngine, ContinuousBatchingScheduler,
                 Request, HostSpillPool, strategies, faults, resilience, arch, tparams,
                 {"device": "cpu"}))


@pytest.fixture(scope="module")
def sides():
    return _make_sides("llama3-8b")


@pytest.fixture(scope="module")
def ssm_sides():
    return _make_sides("mamba2-1.3b")


def _counters(eng) -> dict:
    out = {a: int(getattr(eng, a, 0)) for a in COUNTERS}
    if hasattr(eng, "pool"):
        out["pool"] = eng.pool.snapshot()
    return out


def _run_sched(side, eng, prompts, max_new=8, strategy="OneOrAll", **kw):
    sched = side.Scheduler(eng, strategy=getattr(side.strategies, strategy)(), **kw)
    reqs = [side.Request(rid=i, prompt=p, max_new_tokens=max_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    sched.producer_done()
    sched.run_until_drained(max_ticks=2000)
    return reqs, sched


def _tick(eng, reqs, n):
    for _ in range(n):
        out = eng.decode_tick()
        for r in reqs:
            r.generated.append(out[r.lane])


def _shared_prompts(rng, n_readers=2, prefix_tokens=16, tail_tokens=4):
    """One owner + ``n_readers`` prompts sharing a page-aligned prefix."""
    shared = rng.integers(1, 200, size=prefix_tokens).astype(np.int32)
    return [np.concatenate([shared, rng.integers(1, 200, size=tail_tokens).astype(np.int32)])
            for _ in range(1 + n_readers)]


# ---------------------------------------------------------- prefix sharing

def test_prefix_hit_bit_identical_and_zero_cost(sides):
    """Prompts sharing a page-aligned prefix alias the prefix pages (zero
    bytes moved for them), prefill only the novel tail through
    ``_shared_tail`` and give the unshared engine's tokens, the owner
    arriving in the same batch; the counters equal the JAX engine's."""
    prompts = _shared_prompts(np.random.default_rng(41))
    out = []
    for side in sides:
        runs = []
        for share in (False, True):
            eng = side.paged(n_lanes=4, max_prompt_len=32, max_len=32, page_size=8,
                             prefix_share=share)
            reqs = [side.Request(rid=i, prompt=p, max_new_tokens=4)
                    for i, p in enumerate(prompts)]
            eng.admit(reqs, None)
            _tick(eng, reqs, 4)
            runs.append(([r.generated for r in reqs], _counters(eng)))
        (g0, c0), (g1, c1) = runs
        assert g1 == g0
        assert c1["prefix_hits"] == 2 and c1["prefill_flops_saved"] > 0
        assert c1["kv_bytes_moved"] < c0["kv_bytes_moved"]
        assert c1["prefill_flops_total"] / (
            c1["prefill_flops_total"] - c1["prefill_flops_saved"]) > 1.5
        assert c1["dispatches"] == c0["dispatches"] + 2  # one per hit
        out.append(runs)
    assert out[1] == out[0]


def test_shared_tail_logits_match_a_full_prefill(sides):
    """The hit's first-token logits from ``_shared_tail`` (aliased pages
    gathered dense, the tail fed through the decode path) equal a flash
    prefill of the whole prompt, and the JAX engine picks the same token."""
    from repro_torch.models import transformer as tf

    prompts = _shared_prompts(np.random.default_rng(42), n_readers=1, tail_tokens=7)
    firsts = []
    for side in sides:
        eng = side.paged(n_lanes=2, max_prompt_len=32, max_len=32, page_size=8,
                         prefix_share=True)
        reqs = [side.Request(rid=i, prompt=p, max_new_tokens=2) for i, p in enumerate(prompts)]
        eng.admit(reqs, None)
        firsts.append([r.generated[0] for r in reqs])
        if side.name != "torch":
            continue
        assert eng.prefix_hits == 1
        idx = torch.as_tensor(eng.pool.pages(reqs[1].lane)[:2])
        logits, _ = eng._shared_tail(idx, prompts[1][None, 16:], 16)
        full = tf.prefill(side.arch.cfg, side.params, torch.as_tensor(prompts[1][None]))[0]
        torch.testing.assert_close(logits, full, rtol=1e-4, atol=1e-4)
        assert int(logits.argmax()) == reqs[1].generated[0]
    assert firsts[1] == firsts[0]


def test_cow_guard_forks_before_shared_page_write(sides):
    """A decode write into an aliased page forks a private copy first: the
    sibling's page bytes stay identical and the writer's tokens equal an
    unshared run's."""
    prompt = np.random.default_rng(43).integers(1, 200, size=12).astype(np.int32)
    out = []
    for side in sides:
        streams = []
        for share in (True, False):
            eng = side.paged(n_lanes=2, max_prompt_len=16, max_len=32, page_size=8)
            r = side.Request(rid=0, prompt=prompt, max_new_tokens=4)
            eng.admit([r], None)
            if share:
                # Alias both pages (the one decode writes next too) to a
                # ghost reader, as a raw-pool consumer might.
                ghost_page = eng.pool.share(r.lane, "ghost", n_pages=2)[1]
                before = [a[:, ghost_page] for a in side.leaves(eng.cache)]
            _tick(eng, [r], 4)
            if share:
                assert eng.pool.pages(r.lane)[1] != ghost_page
                assert eng.pool.page_ref(ghost_page) == 1
                for b, a in zip(before, side.leaves(eng.cache)):
                    np.testing.assert_array_equal(b, a[:, ghost_page])
                eng.pool.free_table("ghost")
            streams.append((r.generated, _counters(eng)))
        assert streams[0][0] == streams[1][0]
        out.append(streams)
    assert out[1] == out[0]


def test_shared_prefix_survives_straggler_spill(sides):
    """Spilling one reader of a shared prefix moves only its private tail
    to the host; the refcounted prefix pages stay resident for the
    siblings, and the restore adopts them with outputs equal to an
    uninterrupted unshared run's."""
    prompts = _shared_prompts(np.random.default_rng(47))
    out = []
    for side in sides:
        base = side.paged(n_lanes=4, max_prompt_len=32, max_len=32, page_size=8)
        breqs = [side.Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
        base.admit(breqs, None)
        _tick(base, breqs, 6)

        eng = side.paged(n_lanes=4, max_prompt_len=32, max_len=32, page_size=8,
                         prefix_share=True, kv_spill=side.Spill(8))
        reqs = [side.Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
        eng.admit(reqs, None)
        _tick(eng, reqs, 2)
        victim = reqs[1]  # a reader, not the owner
        owner_prefix = eng.pool.pages(reqs[0].lane)[:2]
        free_before, bytes_before = eng.pool.n_free_pages, eng.kv_bytes_moved
        assert eng.spill(victim.lane, victim.rid, None)
        assert all(eng.pool.page_ref(p) >= 2 for p in owner_prefix)
        spilled = eng.kv_bytes_moved - bytes_before
        prefix_rows_bytes = sum(a.dtype.itemsize * a.shape[0] * 16 * int(np.prod(a.shape[3:]))
                                for a in side.leaves(eng.cache))
        assert 0 < spilled < prefix_rows_bytes  # only the private tail
        assert eng.pool.n_free_pages > free_before
        _tick(eng, [reqs[0], reqs[2]], 1)
        victim.lane = eng.try_restore(victim.rid, None)
        assert victim.lane is not None
        for _ in range(4):
            out_ = eng.decode_tick()
            victim.generated.append(out_[victim.lane])
            for r in (reqs[0], reqs[2]):
                if len(r.generated) < 7:
                    r.generated.append(out_[r.lane])
        assert [r.generated for r in reqs] == [r.generated for r in breqs]
        out.append(([r.generated for r in reqs], spilled, _counters(eng)))
    assert out[1] == out[0]


def test_spill_entry_drop_releases_prefix_holds(sides):
    """A spill entry that drops out of the host pool (LRU pressure)
    releases the references it held on resident prefix pages: no leak,
    the owner becomes the sole reader again."""
    out = []
    for side in sides:
        rng = np.random.default_rng(53)
        prompts = _shared_prompts(rng, n_readers=1)
        eng = side.paged(n_lanes=4, max_prompt_len=32, max_len=32, page_size=8,
                         prefix_share=True, kv_spill=side.Spill(max_entries=1))
        reqs = [side.Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
        eng.admit(reqs, None)
        owner_prefix = eng.pool.pages(reqs[0].lane)[:2]
        assert eng.spill(reqs[1].lane, reqs[1].rid, None)
        assert all(eng.pool.page_ref(p) == 2 for p in owner_prefix)
        other = side.Request(rid=9, prompt=rng.integers(1, 200, size=5).astype(np.int32),
                             max_new_tokens=2)
        eng.admit([other], None)
        assert eng.spill(other.lane, other.rid, None)
        assert reqs[1].rid not in eng.partition.spill
        assert all(eng.pool.page_ref(p) == 1 for p in owner_prefix)
        out.append((_counters(eng), eng.partition.spill.snapshot()))
    assert out[1] == out[0]


def test_scheduler_prefix_hits_stat(sides):
    """Through the scheduler with sharing on: outputs equal the dense
    engine's and ``stats.prefix_hits`` mirrors the engine's counter."""
    prompts = _shared_prompts(np.random.default_rng(59), n_readers=3)
    out = []
    for side in sides:
        d_reqs, _ = _run_sched(side, side.dense(n_lanes=4, max_prompt_len=32, max_len=32),
                               prompts, max_new=5)
        eng = side.paged(n_lanes=4, max_prompt_len=32, max_len=32, page_size=8,
                         prefix_share=True)
        p_reqs, sched = _run_sched(side, eng, prompts, max_new=5)
        assert sched.stats.prefix_hits >= 1
        assert sched.stats.prefix_hits == eng.prefix_hits
        assert [r.generated for r in p_reqs] == [r.generated for r in d_reqs]
        out.append(([r.generated for r in p_reqs], _counters(eng),
                    sched.stats.admission_trace))
    assert out[1] == out[0]


# ----------------------------------------------------- megabatch + sampling

def test_megabatch_one_dispatch_across_templates(sides):
    """One decode dispatch a tick covers every active lane, whatever its
    template or reserved pool."""
    out = []
    for side in sides:
        rng = np.random.default_rng(61)
        eng = side.paged(n_lanes=4, max_prompt_len=16, max_len=32, page_size=8,
                         kv_shares={"chat": 2, "embed": 1})
        ra = side.Request(rid=0, prompt=rng.integers(1, 200, size=6).astype(np.int32),
                          max_new_tokens=4, template="chat")
        rb = side.Request(rid=1, prompt=rng.integers(1, 200, size=9).astype(np.int32),
                          max_new_tokens=4, template="embed")
        eng.admit([ra], "chat")
        eng.admit([rb], "embed")
        for _ in range(4):
            before = eng.dispatches
            _tick(eng, [ra, rb], 1)
            assert eng.dispatches - before == 1
        assert len(ra.generated) == 5 and len(rb.generated) == 5
        out.append(([ra.generated, rb.generated], _counters(eng)))
    assert out[1] == out[0]


def test_per_lane_sampling_in_one_megabatch(sides):
    """Per-lane sampling rides the single dispatch: a temperature-0 lane
    equals the all-greedy run (and the JAX engine's), a sampled lane draws
    reproducibly, also across a spill/restore.  The port's draws keep the
    reference's contract, not its threefry bits, so only greedy streams
    are compared across packages."""
    rng = np.random.default_rng(67)
    p0 = rng.integers(1, 200, size=6).astype(np.int32)
    p1 = rng.integers(1, 200, size=9).astype(np.int32)

    def run(side, sampled, interrupt=False):
        eng = side.paged(n_lanes=2, max_prompt_len=16, max_len=32, page_size=8,
                         kv_spill=side.Spill(4))
        r0 = side.Request(rid=0, prompt=p0, max_new_tokens=6)
        r1 = side.Request(rid=1, prompt=p1, max_new_tokens=6,
                          temperature=5.0 if sampled else 0.0, sample_seed=7)
        eng.admit([r0, r1], None)
        for i in range(6):
            if interrupt and i == 3:
                assert eng.spill(r1.lane, r1.rid, None)
                r1.lane = eng.try_restore(r1.rid, None)
                assert r1.lane is not None
            _tick(eng, [r0, r1], 1)
        return r0.generated, r1.generated

    jside, tside = sides
    greedy = run(tside, sampled=False)
    assert greedy == run(jside, sampled=False)
    s0_a, s1_a = run(tside, sampled=True)
    _, s1_b = run(tside, sampled=True)
    assert s0_a == greedy[0] and s1_a == s1_b and s1_a != greedy[1]
    _, s1_c = run(tside, sampled=True, interrupt=True)
    assert s1_c == s1_a
    j0, _ = run(jside, sampled=True, interrupt=True)
    assert j0 == s0_a


# ------------------------------------------------------------ spill/restore

def test_paged_matches_dense_through_straggler_spill(sides):
    """Paged and dense engines give the same outputs per request through
    a spill/restore-heavy scheduler run, the paged one moving at most half
    the bytes."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 200, size=n).astype(np.int32) for n in (5, 9, 13, 7)]
    out = []
    for side in sides:
        dense = side.dense(n_lanes=2, max_prompt_len=16, max_len=48, kv_spill=side.Spill(8))
        d_reqs, d_sched = _run_sched(side, dense, prompts, lane_timeout=2)
        paged = side.paged(n_lanes=2, max_prompt_len=16, max_len=48, kv_spill=side.Spill(8),
                           page_size=8, prefetch_pages=1)
        p_reqs, p_sched = _run_sched(side, paged, prompts, lane_timeout=2)
        assert d_sched.stats.kv_spilled >= 1
        assert p_sched.stats.kv_spilled == d_sched.stats.kv_spilled
        assert [r.generated for r in p_reqs] == [r.generated for r in d_reqs]
        assert paged.kv_bytes_moved <= 0.5 * dense.kv_bytes_moved
        out.append(([r.generated for r in p_reqs], _counters(paged), _counters(dense),
                    p_sched.stats.kv_restored))
    assert out[1] == out[0]


@pytest.mark.parametrize("model", ["llama3-8b", "mamba2-1.3b"])
def test_dense_engine_spill_copies_rows_to_the_host(sides, ssm_sides, model):
    """The dense engine's spilled rows are a copy, also on the CPU (where
    ``.cpu()`` returns a view of the lane, which later ticks keep
    writing): straggler spills and restores give the JAX engine's
    streams."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 200, size=n).astype(np.int32) for n in (5, 9, 13, 7)]
    out = []
    for side in (sides if model == "llama3-8b" else ssm_sides):
        dense = side.dense(n_lanes=2, max_prompt_len=16, max_len=48, kv_spill=side.Spill(8))
        reqs, sched = _run_sched(side, dense, prompts, lane_timeout=2)
        assert sched.stats.kv_restored == sched.stats.kv_spilled >= 4
        out.append(([r.generated for r in reqs], _counters(dense)))
    assert out[1] == out[0]


def test_paged_spill_restore_round_trip_and_prefetch_tail(sides):
    """Restore splices ``prefetch_pages`` at once and queues the tail; the
    tail lands before the next decode step, so generation resumes where
    the eviction stopped."""
    prompt = np.random.default_rng(11).integers(1, 200, size=14).astype(np.int32)
    out = []
    for side in sides:
        eng = side.paged(n_lanes=2, max_prompt_len=16, max_len=32,
                         kv_spill=side.Spill(4), page_size=8, prefetch_pages=1)
        r = side.Request(rid=0, prompt=prompt, max_new_tokens=6)
        eng.admit([r], None)
        _tick(eng, [r], 3)
        assert eng.spill(r.lane, r.rid, None)
        r.lane = eng.try_restore(r.rid, None)
        assert r.lane is not None
        # 14 prompt tokens + 3 decodes = 17 rows = 3 pages > 1 prefetched
        assert r.lane in eng._pending_restore
        _tick(eng, [r], 1)
        assert not eng._pending_restore
        ref_eng = side.paged(n_lanes=2, max_prompt_len=16, max_len=32, page_size=8)
        ref = side.Request(rid=1, prompt=prompt, max_new_tokens=6)
        ref_eng.admit([ref], None)
        _tick(ref_eng, [ref], 4)
        assert r.generated == ref.generated
        out.append((r.generated, _counters(eng)))
    assert out[1] == out[0]


@pytest.mark.parametrize("mode", ["paged", "dense-compute"])
def test_spill_restore_gives_back_the_same_rows(sides, ssm_sides, mode):
    """A spill, other requests writing over the freed frames, then a
    restore puts back every byte of the lane's valid rows (llama's pages, or mamba2's whole
    ``ssm``/``conv`` state in dense-compute mode), and counts the bytes as
    the JAX engine does."""
    out = []
    for side in (sides if mode == "paged" else ssm_sides):
        eng = side.paged(n_lanes=3, max_prompt_len=16, max_len=32, page_size=8,
                         kv_spill=side.Spill(4), prefetch_pages=1)
        rng = np.random.default_rng(13)
        reqs = [side.Request(rid=i, prompt=rng.integers(1, 200, size=n).astype(np.int32),
                             max_new_tokens=8) for i, n in enumerate((11, 6))]
        eng.admit(reqs, None)
        _tick(eng, reqs, 3)
        r = reqs[0]
        length = int(np.asarray(eng.lengths)[r.lane])

        def rows(lane):
            if eng.paged_compute:
                pages = list(eng.pool.pages(lane))[: -(-length // 8)]
                return [np.concatenate([a[:, p] for p in pages], axis=1)[:, :length]
                        for a in side.leaves(eng.cache)]
            return [a[:, lane] for a in side.leaves(eng.cache)]

        before = rows(r.lane)
        assert eng.spill(r.lane, r.rid, None)
        # Two newcomers take the free lane and the spilled one (its pages
        # or rows), and one of them decodes over them before it retires.
        new = [side.Request(rid=5 + i, prompt=p[::-1].copy(), max_new_tokens=4)
               for i, p in enumerate((reqs[1].prompt, r.prompt))]
        eng.admit(new, None)
        _tick(eng, [reqs[1], *new], 2)
        assert not all(np.array_equal(a, b) for a, b in zip(rows(new[1].lane), before))
        eng.retire(new[1].lane)
        r.lane = eng.try_restore(r.rid, None)
        assert r.lane is not None
        eng._flush_restores()
        for b, a in zip(before, rows(r.lane)):
            np.testing.assert_array_equal(a, b)
        out.append(_counters(eng))
    assert out[1] == out[0]


def test_paged_block_tables_grow_with_decode(sides):
    """A lane's block table starts at the prompt's pages and gains one page
    each time decode crosses a page boundary."""
    out = []
    for side in sides:
        eng = side.paged(n_lanes=2, max_prompt_len=16, max_len=32, page_size=8)
        r = side.Request(rid=0, prompt=np.arange(1, 7, dtype=np.int32), max_new_tokens=16)
        eng.admit([r], None)
        sizes = [len(eng.pool.table(r.lane))]
        for _ in range(11):
            _tick(eng, [r], 1)
            sizes.append(len(eng.pool.table(r.lane)))
        assert sizes[0] == 1 and sizes[3] == 2 and sizes[11] == 3
        eng.retire(r.lane)
        assert not eng.pool.has_table(r.lane)
        assert eng.pool.n_free_pages == eng.n_lanes * eng.pages_per_lane
        out.append((sizes, r.generated, _counters(eng)))
    assert out[1] == out[0]


@pytest.mark.parametrize("engine", ["dense", "paged"])
def test_batched_oversized_prompts_admit_together(sides, engine):
    """A burst of oversized prompts goes through the chunk pipeline as one
    batched dispatch of resumable parts, with exact outputs."""
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, 200, size=13).astype(np.int32) for _ in range(3)]
    out = []
    for side in sides:
        ref_reqs, _ = _run_sched(side, side.dense(n_lanes=4, max_prompt_len=16, max_len=48),
                                 prompts, max_new=4)
        eng = (side.dense(n_lanes=4, max_prompt_len=16, max_len=48) if engine == "dense"
               else side.paged(n_lanes=4, max_prompt_len=16, max_len=48, page_size=8))
        reqs, sched = _run_sched(side, eng, prompts, max_new=4, overlap=True,
                                 chunk_tokens=4)
        assert sched.stats.spec_dispatched == 3
        assert 3 in [n for _, n in sched.stats.admission_trace]
        assert [r.generated for r in reqs] == [r.generated for r in ref_reqs]
        out.append(([r.generated for r in reqs], _counters(eng)))
    assert out[1] == out[0]


def test_paged_view_feeds_the_paged_op(sides):
    """``paged_view()`` exposes the live KV as (pages, block tables): the
    paged op over it equals the dense oracle over a dense engine's rows
    for the same requests, and the view's tables and lengths equal the
    JAX engine's."""
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, 200, size=6 + 4 * i).astype(np.int32) for i in range(2)]
    views = []
    for side in sides:
        eng = side.paged(n_lanes=2, max_prompt_len=16, max_len=32, page_size=8)
        reqs = [side.Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
        eng.admit(reqs, None)
        _tick(eng, reqs, 2)
        view = eng.paged_view()
        assert view is not None and view["lanes"] == [0, 1]
        views.append({k: np.asarray(view[k]) for k in ("block_tables", "lengths")})
    assert all(np.array_equal(views[0][k], views[1][k]) for k in views[0])
    assert eng.paged_view("absent") is None
    hkv, hd = view["k_pages"].shape[2], view["k_pages"].shape[3]
    q = torch.from_numpy(np.random.default_rng(0).standard_normal((2, hkv * 2, hd),
                                                                  dtype=np.float32))
    paged = paged_decode_op(q, view["k_pages"], view["v_pages"], view["block_tables"],
                            view["lengths"])
    dense = side.dense(n_lanes=2, max_prompt_len=16, max_len=32)
    dreqs = [side.Request(rid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    dense.admit(dreqs, None)
    for _ in range(2):
        dense.decode_tick()
    lanes = torch.as_tensor([r.lane for r in dreqs])
    k = dense.cache["layers"]["k"][0][lanes]
    v = dense.cache["layers"]["v"][0][lanes]
    torch.testing.assert_close(paged, decode_ref(q, k, v, view["lengths"]),
                               rtol=2e-5, atol=2e-5)


# -------------------------------------------------------- oversubscription

def test_oversubscribed_admission_bound(sides):
    """Below full provisioning, admission is bounded by whole-lane page
    budgets, not by free lanes."""
    out = []
    for side in sides:
        eng = side.paged(n_lanes=4, max_prompt_len=16, max_len=32, page_size=8, n_pages=8)
        assert eng.paged_compute and eng.pages_per_lane == 4
        assert eng.partition.n_free == 4
        assert eng.kv.n_free == 2 and eng.kv.n_free_for(None) == 2
        r = side.Request(rid=0, prompt=np.arange(1, 7, dtype=np.int32), max_new_tokens=4)
        eng.admit([r], None)
        assert eng.pool.n_free_pages == 7 and eng.kv.n_free == 1
        out.append(_counters(eng))
    assert out[1] == out[0]


EVICT = {
    "n5-prefetch1": (5, 1, 8, 2),
    "n6-prefetch2": (6, 2, 8, 3),
}


@pytest.mark.parametrize("case", sorted(EVICT))
def test_mid_decode_eviction_and_restore_bit_identical(sides, case):
    """An oversubscribed pool evicts the least-recently-touched lane
    mid-decode under page pressure; the scheduler re-queues it, the
    restore resumes it, and the outputs equal a fully provisioned dense
    run's.  Every tick's block tables stay off the trash page."""
    n_pages, prefetch, max_new, n_lanes = EVICT[case]
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, 200, size=n).astype(np.int32) for n in (6, 5, 9)[:n_lanes]]
    out = []
    for side in sides:
        d_reqs, _ = _run_sched(side, side.dense(n_lanes=n_lanes, max_prompt_len=16,
                                                max_len=32), prompts, max_new=2 * max_new)
        paged = side.paged(n_lanes=n_lanes, max_prompt_len=16, max_len=32, page_size=8,
                           n_pages=n_pages, kv_spill=side.Spill(8), prefetch_pages=prefetch)
        if side.name == "torch":
            tick, seen = paged.decode_tick, []

            def traced():
                seen.append(int(paged._device_tables().max()))
                return tick()

            paged.decode_tick = traced
        p_reqs, p_sched = _run_sched(side, paged, prompts, max_new=2 * max_new)
        assert paged.page_evictions >= 1
        assert p_sched.stats.kv_restored == p_sched.stats.kv_spilled >= 1
        assert [r.generated for r in p_reqs] == [r.generated for r in d_reqs]
        out.append(([r.generated for r in p_reqs], _counters(paged),
                    p_sched.stats.kv_spilled, p_sched.stats.admission_trace))
    assert seen and max(seen) < n_pages
    assert out[1] == out[0]


def test_eviction_without_a_scheduler_is_drained(sides):
    """With no ``on_lane_evicted`` callback, page-pressure evictions are
    recorded for :meth:`drain_evictions`, which returns them once."""
    out = []
    for side in sides:
        eng = side.paged(n_lanes=2, max_prompt_len=16, max_len=32, page_size=8, n_pages=4,
                         kv_spill=side.Spill(4))
        rng = np.random.default_rng(29)
        reqs = [side.Request(rid=i, prompt=rng.integers(1, 200, size=n).astype(np.int32),
                             max_new_tokens=12) for i, n in enumerate((7, 6))]
        eng.admit(reqs, None)
        ticks = 0
        while eng.page_evictions == 0:
            eng.decode_tick()
            ticks += 1
        drained = eng.drain_evictions()
        assert len(drained) == 1 and eng.drain_evictions() == []
        lane, key, template, spilled = drained[0]
        assert spilled and key in {r.rid for r in reqs} and not eng.active[lane]
        out.append((ticks, [(int(a), int(b), c, d) for a, b, c, d in drained],
                    _counters(eng)))
    assert out[1] == out[0]


def test_all_pinned_pressure_raises(sides):
    """When every page is held by the lanes asking to grow, eviction has
    no victim and the pool raises instead of spinning."""
    for side in sides:
        eng = side.paged(n_lanes=2, max_prompt_len=16, max_len=16, page_size=8, n_pages=2)
        rng = np.random.default_rng(3)
        reqs = [side.Request(rid=i, prompt=rng.integers(1, 200, size=9).astype(np.int32),
                             max_new_tokens=2) for i in range(2)]
        with pytest.raises(RuntimeError, match="pinned"):
            eng.admit(reqs, None)


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_page_quota_reserves_pages_for_template(package):
    """Lane reservations become page quotas: a shared-pool burst cannot
    take the pages a reserved template is owed (the same arithmetic in
    both packages' copies of the classes)."""
    Partition, Pool, View = ((JKVPartition, JPagedKVPool, JPagedKVView) if package == "jax"
                             else (KVPartition, PagedKVPool, PagedKVView))
    part = Partition(4, {"x": 2})
    pool = Pool(16, page_size=4)
    used = {"x": 0}
    view = View(part, pool, pages_per_lane=4, page_quota={"x": 8},
                used_pages=lambda t: used.get(t, 0))
    assert view.n_free_for("x") == 4
    assert view.n_free_for("y") == 2 and view.n_free_for(None) == 2
    used["x"] = 8
    pool.alloc_table("x0", n=8)
    assert view.n_free_for("y") == 2
    used["x"] = 0
    assert view.n_free_for("y") == 0


def test_page_quota_from_kv_shares(sides):
    """The engine derives each reserved template's page quota from its
    lane share and counts a template's held pages through its lanes."""
    out = []
    for side in sides:
        eng = side.paged(n_lanes=4, max_prompt_len=16, max_len=32, page_size=8, n_pages=12,
                         kv_shares={"chat": 2})
        assert eng.kv.page_quota == {"chat": 6}
        r = side.Request(rid=0, prompt=np.arange(1, 12, dtype=np.int32), template="chat")
        eng.admit([r], "chat")
        out.append((eng._pages_used_by("chat"), eng._pages_used_by(None),
                    eng.kv.n_free_for(None), eng.kv.n_free_for("chat")))
    assert out[1] == out[0] and out[1][0] == 2


# ------------------------------------------------------ dense-compute mode

def test_dense_compute_identity_frames_and_tick(ssm_sides):
    """mamba2 keeps its per-lane state (dense-compute mode): block tables
    are identity frames that grow with decode, fusion is declined, the
    tick is the dense decode step, and retire frees the frames."""
    out = []
    for side in ssm_sides:
        eng = side.paged(n_lanes=2, max_prompt_len=16, max_len=32, page_size=8)
        assert not eng.paged_compute and eng.paged_view() is None
        rng = np.random.default_rng(31)
        reqs = [side.Request(rid=i, prompt=rng.integers(1, 200, size=n).astype(np.int32),
                             max_new_tokens=12) for i, n in enumerate((5, 11))]
        eng.admit(reqs, None)
        tables = [eng.pool.pages(r.lane) for r in reqs]
        assert all(t == tuple(r.lane * 4 + j for j in range(len(t)))
                   for t, r in zip(tables, reqs))
        staged = eng.prefill_dispatch(
            [side.Request(rid=7, prompt=np.arange(1, 14, dtype=np.int32))], chunk=4)
        assert eng.stage_chunk(staged) is False
        _tick(eng, reqs, 9)
        grown = [eng.pool.pages(r.lane) for r in reqs]
        assert [len(t) for t in grown] == [2, 3]
        for r in reqs:
            eng.retire(r.lane)
        assert eng.pool.n_free_pages == eng.n_pages
        out.append(([r.generated for r in reqs], tables, grown, _counters(eng)))
    assert out[1] == out[0]


# ------------------------------------------------------ ChaosEngine recovery
@pytest.mark.parametrize("engine", ["paged", "dense"])
def test_chaos_crash_recovery_bit_identical(sides, engine):
    """Twin of ``test_prefix_share.py::test_chaos_crash_on_shared_reader_
    bit_identical``: ``ChaosEngine`` crashes seeded lanes before the device
    step; the scheduler quarantines the lane, salvages its KV to the spill
    pool, requeues and restores the request.  On the paged engine with
    prefix sharing on, the crashes hit shared-prefix readers; on the dense
    engine, plain lanes.  Every stream equals the fault-free run's (the
    paged engine's unshared), in each package, and the two packages agree
    on streams, faults and recovery counters."""
    prompts = _shared_prompts(np.random.default_rng(71), n_readers=4, tail_tokens=3)
    out = []
    for side in sides:
        def run(chaos, share):
            kw = dict(n_lanes=3, max_prompt_len=32, max_len=32,
                      kv_spill=side.Spill(max_entries=16))
            eng = (side.paged(page_size=8, prefix_share=share, **kw) if engine == "paged"
                   else side.dense(**kw))
            if chaos:
                eng = side.faults.ChaosEngine(eng, side.faults.ChaosPlan(
                    seed=side.faults.chaos_seed(0), decode_fault_rate=0.25))
            res = side.resilience.Resilience(quarantine_ticks=1) if chaos else None
            reqs, sched = _run_sched(side, eng, [p.copy() for p in prompts], max_new=5,
                                     resilience=res)
            assert all(len(r.generated) == 5 for r in reqs)
            return [list(r.generated) for r in reqs], eng, sched

        baseline, _, _ = run(chaos=False, share=False)
        chaotic, eng, sched = run(chaos=True, share=True)
        assert eng.injected_decode_faults > 0, "chaos never bit: rate too low"
        assert sched.stats.quarantined > 0
        if engine == "paged":
            assert sched.stats.prefix_hits >= 1  # sharing was exercised
        assert chaotic == baseline
        out.append((chaotic, eng.injected_decode_faults, eng.injected_prefill_faults,
                    sched.stats.quarantined, sched.stats.prefix_hits,
                    sched.stats.kv_spilled, sched.stats.kv_restored))
    assert out[1] == out[0]
