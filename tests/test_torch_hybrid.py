"""hymba-1.5b in the port against the JAX package: the hybrid block, the
sliding window and the ring buffer.

Reduced hymba in float32 (2 layers, window W 16, GQA 4/2, an SSM branch of
4 heads x 8 with state 8), the JAX weights carried across with
``params_from_numpy``, the same numpy inputs through both packages.
Model steps agree within ``TOL`` = 1e-4, the tolerance of
``test_torch_model.py``: the frameworks sum in another order (about 1e-6
on O(1) values), and the ring decode attends the same keys in ring order
(softmax does not depend on the keys' order: rounding only).  KV caches
agree within 1e-5.  The engines give greedy streams and counters equal to
the JAX engines' exactly: argmax decides on logit gaps far above that.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import strategies as j_strategies
from repro.models import attention as j_attention
from repro.models.registry import get_arch as j_get_arch
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.paged_kv import PagedInferenceEngine as JPagedEngine
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import ContinuousBatchingScheduler as JScheduler
from repro_torch.core import strategies
from repro_torch.launch import serve
from repro_torch.models import attention as t_attention
from repro_torch.models import transformer as t_tf
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.paged_decode import supports_paged_decode
from repro_torch.models.registry import get_arch
from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.paged_kv import PagedInferenceEngine
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import ContinuousBatchingScheduler

TOL = dict(rtol=1e-4, atol=1e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)
NAME = "hymba-1.5b"
COUNTERS = ("dispatches", "decode_steps", "prefill_calls", "kv_bytes_moved")


def _np(x):
    return np.asarray(x, dtype=np.float32)


@pytest.fixture(scope="module")
def pair():
    jarch = j_get_arch(NAME)
    jarch = dataclasses.replace(jarch, cfg=jarch.cfg.reduced())
    arch = get_arch(NAME)
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    tree = jax.tree_util.tree_map(np.asarray, jarch.init(jax.random.PRNGKey(0)))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jarch, jparams, arch, params_from_numpy(tree, arch.cfg, device="cpu"), tree


def _tokens(cfg, seed: int, b: int, s: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _assert_cache(cache, jcache, tol=KV_TOL):
    for name, stack in jcache.items():
        assert sorted(cache[name]) == sorted(stack)
        for key, a in stack.items():
            assert tuple(cache[name][key].shape) == tuple(a.shape), (name, key)
            np.testing.assert_allclose(cache[name][key].numpy(), _np(a), **tol)


# ------------------------------------------------------------------ config

def test_config_counts_and_tree_match_reference(pair):
    """The config, full width and reduced, and ``param_count``; the
    hybrid block's leaves (``ssm``, both branch norms) in ``init_params``'
    tree, shapes and float32 ``A_log``/``D``/``dt_bias`` as in the
    reference's."""
    for ref, port in ((j_get_arch(NAME).cfg, get_arch(NAME).cfg),
                      (j_get_arch(NAME).cfg.reduced(), get_arch(NAME).cfg.reduced())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
    assert get_arch(NAME).cfg.param_count() == 1_393_416_896
    _ja, _jp, arch, tparams, tree = pair
    mine = arch.init(seed=0, device="cpu")
    assert (jax.tree_util.tree_map(lambda a: tuple(a.shape), mine, is_leaf=torch.is_tensor)
            == jax.tree_util.tree_map(np.shape, tree))
    assert sorted(mine["layers"]) == ["attn", "attn_branch_norm", "ln1", "ln2", "mlp", "ssm",
                                      "ssm_branch_norm"]
    for k in ("A_log", "D", "dt_bias"):
        assert mine["layers"]["ssm"][k].dtype == torch.float32
    assert not supports_paged_decode(arch.cfg)


def test_converter_round_trip(pair):
    """numpy tree → port → numpy gives the tree back, leaf for leaf, and a
    bf16 config keeps the mixer's three float32 leaves."""
    _ja, _jp, arch, tparams, tree = pair
    back = params_to_numpy(tparams)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    bf = dataclasses.replace(arch.cfg, param_dtype="bfloat16")
    conv = params_from_numpy(tree, bf, device="cpu")
    assert conv["layers"]["ssm"]["A_log"].dtype == torch.float32
    assert conv["layers"]["attn_branch_norm"]["w"].dtype == torch.bfloat16


# --------------------------------------------------------------- attention

def test_windowed_prefill_attention_matches_reference(pair):
    """One layer's attention at W 16 over S 40 through the flash op's band
    mask, output and K/V."""
    jarch, jparams, arch, tparams, _tree = pair
    x = np.random.default_rng(1).standard_normal((2, 40, arch.cfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["attn"])
    tp = {k: v[0] for k, v in tparams["layers"]["attn"].items()}
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    y, (k, v) = t_attention.attention(tp, arch.cfg, torch.from_numpy(x), return_kv=True)
    jy, (jk, jv) = j_attention.attention(jp, jarch.cfg, jnp.asarray(x), jnp.asarray(pos),
                                         return_kv=True)
    np.testing.assert_allclose(y.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(k.numpy(), _np(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), _np(jv), **TOL)
    # the band matters: full causal attention gives another output
    wide = dataclasses.replace(arch.cfg, attn_window=0)
    assert not np.allclose(t_attention.attention(tp, wide, torch.from_numpy(x)).numpy(),
                           y.numpy(), atol=1e-3)


def test_ring_decode_across_a_wrap_matches_reference(pair):
    """The ring buffer (S_max = W = 16) over 40 steps from empty: each step
    writes slot ``length % 16`` in place and attends the admitted slots;
    the output and the cache against the reference's at every step."""
    jarch, jparams, arch, tparams, _tree = pair
    cfg = arch.cfg
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["layers"]["attn"])
    tp = {k: v[1] for k, v in tparams["layers"]["attn"].items()}
    rng = np.random.default_rng(2)
    shape = (3, 16, cfg.n_kv_heads, cfg.hd)
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    lengths = np.array([0, 5, 13], np.int32)
    jdecode = jax.jit(j_attention.decode_attention, static_argnums=(1,),
                      static_argnames=("window",))
    for _ in range(40):
        x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
        y, k_out, _v = t_attention.decode_attention(tp, cfg, torch.from_numpy(x), tk, tv,
                                                    torch.from_numpy(lengths), window=16)
        assert k_out is tk
        jy, jk, jv = jdecode(jp, jarch.cfg, jnp.asarray(x), jk, jv, jnp.asarray(lengths),
                             window=16)
        np.testing.assert_allclose(y.numpy(), _np(jy), **TOL)
        np.testing.assert_allclose(tk.numpy(), _np(jk), **KV_TOL)
        np.testing.assert_allclose(tv.numpy(), _np(jv), **KV_TOL)
        lengths = lengths + 1
    assert lengths.min() > 32  # every lane wrapped at least twice


def test_ring_longer_than_its_window_is_refused(pair):
    """A ring holds min(max_len, W) rows; a longer one (which no cache of
    either package has) raises instead of attending the wrong slots."""
    _ja, _jp, arch, tparams, _tree = pair
    tp = {k: v[0] for k, v in tparams["layers"]["attn"].items()}
    kv = torch.zeros((1, 20, arch.cfg.n_kv_heads, arch.cfg.hd))
    with pytest.raises(ValueError, match="longer than its window"):
        t_attention.decode_attention(tp, arch.cfg, torch.zeros((1, 1, arch.cfg.d_model)),
                                     kv, kv, torch.zeros(1, dtype=torch.int32), window=16)


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("s", [9, 16, 40])
def test_prefill_ring_relayout_matches_reference(pair, s):
    """``prefill``'s cache for S < W (S rows, zeros after), S = W and S > W
    (the last W rows rolled by S % W): ``k``, ``v``, ``ssm`` and
    ``conv`` against the reference's, and the last logits."""
    jarch, jparams, arch, tparams, _tree = pair
    toks = _tokens(arch.cfg, 3, 2, s)
    logits, cache = t_tf.prefill(arch.cfg, tparams, torch.from_numpy(toks), max_len=64)
    jlogits, jcache = jarch.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=64)
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **TOL)
    _assert_cache(cache, jcache)
    assert cache["layers"]["k"].shape[2] == 16


def test_prefill_and_decode_across_wraps_match_reference(pair):
    """Prefill of 40 tokens (max_len 64), then 24 greedy ``decode_step``s
    from the ring: every step's logits within TOL and the same greedy
    tokens."""
    jarch, jparams, arch, tparams, _tree = pair
    toks = _tokens(arch.cfg, 4, 3, 40)
    logits, cache = arch.prefill(tparams, {"tokens": torch.from_numpy(toks)}, max_len=64)
    jlogits, jcache = jarch.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=64)
    lengths = np.full((3,), 40, np.int32)
    streams, jstreams = [], []
    jdecode = jax.jit(jarch.decode_step)
    for _ in range(24):
        np.testing.assert_allclose(logits.numpy(), _np(jlogits), **TOL)
        tok = logits.argmax(-1).to(torch.int32)
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        streams.append(tok.numpy())
        jstreams.append(np.asarray(jtok))
        logits, cache = arch.decode_step(tparams, tok, cache, torch.from_numpy(lengths))
        jlogits, jcache = jdecode(jparams, jtok, jcache, jnp.asarray(lengths))
        lengths = lengths + 1
    np.testing.assert_array_equal(np.stack(streams), np.stack(jstreams))
    _assert_cache(cache, jcache, tol=TOL)


def test_right_padded_ring_keeps_pad_rows_as_the_reference_does(pair):
    """The reference's fault, reproduced: a right-padded batch whose bucket
    S (32) reaches W (16) keeps the last W rows of the *padded* length, so
    a 10-token prompt's ring holds only pad KV (its real rows 0-9 lie
    below S - W), and its decode attends those pad keys.  Both packages
    give the same (wrong) cache and logits, unlike the same prompt
    prefilled alone."""
    jarch, jparams, arch, tparams, _tree = pair
    cfg = arch.cfg
    toks = np.zeros((2, 32), np.int32)
    toks[0] = _tokens(cfg, 5, 1, 32)[0]
    toks[1, :10] = _tokens(cfg, 6, 1, 10)[0]
    _l, cache = t_tf.prefill(cfg, tparams, torch.from_numpy(toks), max_len=64,
                             return_all_logits=True)
    _jl, jcache = jarch.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=64)
    _assert_cache(cache, jcache)
    lengths = np.array([32, 10], np.int32)
    tok = np.array([1, 2], np.int32)
    logits, _c = t_tf.decode_step(cfg, tparams, torch.from_numpy(tok), cache,
                                  torch.from_numpy(lengths))
    jlogits, _jc = jarch.decode_step(jparams, jnp.asarray(tok), jcache, jnp.asarray(lengths))
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **TOL)
    # the pad's KV fills the ring: the same prompt prefilled alone differs
    _l1, alone = t_tf.prefill(cfg, tparams, torch.from_numpy(toks[1:, :10]), max_len=64)
    assert not np.allclose(alone["layers"]["k"][:, 0, :10].numpy(),
                           cache["layers"]["k"][:, 1, :10].numpy(), atol=1e-3)


# ----------------------------------------------------------------- engines

def _sides(pair):
    jarch, jparams, arch, tparams, _tree = pair
    return ((JEngine, JPagedEngine, JScheduler, JRequest, j_strategies, jarch, jparams, {}),
            (InferenceEngine, PagedInferenceEngine, ContinuousBatchingScheduler, Request,
             strategies, arch, tparams, {"device": "cpu"}))


def _traffic(seed: int):
    """Six requests of 3-24 tokens and one of 40 (past max_prompt_len 32:
    truncated, or chunked), 20 new tokens each: lanes wrap their rings."""
    rng = np.random.default_rng(seed)
    lens = [int(n) for n in rng.integers(3, 25, size=6)] + [40]
    return [dict(rid=i, prompt=rng.integers(1, 256, size=n).astype(np.int32),
                 max_new_tokens=20) for i, n in enumerate(lens)]


@pytest.mark.parametrize("mode", ["dense", "dense-chunked", "paged"])
def test_engines_stream_and_count_as_the_reference(pair, mode):
    """The dense engine (one-shot prefill; with ``chunk_tokens`` 8 the
    tokens past the first chunk go through ``_extend``) and the paged
    engine's dense-compute mode (rings and SSM state move whole; the
    chunked case under ``overlap=True``, which chunking needs): greedy
    streams, counters and admissions equal to the JAX engines'; the paged
    engine's streams equal the dense engine's."""
    traffic = _traffic(7)
    out = []
    for Engine, Paged, Sched, Req, strat, arch, params, kw in _sides(pair):
        cls = Paged if mode == "paged" else Engine
        ekw = dict(page_size=8) if mode == "paged" else {}
        eng = cls(arch, params, n_lanes=3, max_prompt_len=32, max_len=48, **ekw, **kw)
        skw = dict(overlap=True, chunk_tokens=8) if mode == "dense-chunked" else {}
        sched = Sched(eng, strategy=strat.GrowingUpperThreshold(initial_upper=2), **skw)
        reqs = [Req(**t) for t in traffic]
        for r in reqs:
            sched.submit(r)
        sched.producer_done()
        sched.run_until_drained()
        out.append(([r.generated for r in reqs], {a: getattr(eng, a) for a in COUNTERS},
                    sched.stats.admission_trace))
    assert out[1] == out[0]
    if mode == "paged":
        eng_dense = InferenceEngine(pair[2], pair[3], n_lanes=3, max_prompt_len=32,
                                    max_len=48, device="cpu")
        sched = ContinuousBatchingScheduler(
            eng_dense, strategy=strategies.GrowingUpperThreshold(initial_upper=2))
        reqs = [Request(**t) for t in traffic]
        for r in reqs:
            sched.submit(r)
        sched.producer_done()
        sched.run_until_drained()
        assert [r.generated for r in reqs] == out[1][0]


def test_lanes_shorter_than_the_window_are_refused(pair):
    """``max_len`` below W: the reference's commit fails on the ring's
    shape (W rows into a lane of max_len); the port refuses the engine with
    a ``ValueError`` that names the window."""
    jarch, jparams, arch, tparams, _tree = pair
    jeng = JEngine(jarch, jparams, n_lanes=2, max_prompt_len=8, max_len=12)
    with pytest.raises(Exception):
        jeng.admit([JRequest(rid=0, prompt=np.arange(1, 6, dtype=np.int32))])
    for cls in (InferenceEngine, PagedInferenceEngine):
        with pytest.raises(ValueError, match="sliding window 16"):
            cls(arch, tparams, n_lanes=2, max_prompt_len=8, max_len=12, device="cpu")


def test_launcher_serves_reduced_hymba(capsys):
    serve.main(["--arch", NAME, "--reduced", "--device", "cpu", "--requests", "4",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert "served 4 requests, 16 tokens" in out
