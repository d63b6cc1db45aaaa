"""The rest of the decoder family in the port against the JAX package.

Reduced deepseek-moe-16b and kimi-k2-1t-a32b (MoE: a ``dense_layers``
stack of one block before a ``layers`` stack of MoE blocks, so two KV
stacks), olmo-1b (non-parametric LayerNorm, tied head), qwen1.5-4b (QKV
bias) and chatglm3-6b (QKV bias, half RoPE, GQA), in float32.  The JAX
package draws the weights; the QKV biases, which the reference
initialises to zeros, are redrawn nonzero in the numpy tree so that a
missing add shows; ``params_from_numpy`` carries the tree across.

Model steps (prefill, ``decode_step``, ``paged_decode_step``, the training
``forward``) agree within ``TOL`` = 1e-4, the tolerance of
``test_torch_model.py``: the two frameworks sum in another order (about
1e-6 on O(1) values).  The engines under the scheduler (paged and dense,
synchronous, overlap + chunk with fused ticks, prefix sharing, an
oversubscribed pool with spill) give greedy streams and counters equal to
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
from repro.models import layers as j_layers
from repro.models import transformer as j_tf
from repro.models.paged_decode import paged_decode_step as j_paged_decode_step
from repro.models.registry import get_arch as j_get_arch
from repro.serving.engine import HostSpillPool as JHostSpillPool
from repro.serving.engine import InferenceEngine as JEngine
from repro.serving.paged_kv import PagedInferenceEngine as JPagedEngine
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import ContinuousBatchingScheduler as JScheduler
from repro_torch.core import strategies
from repro_torch.launch import serve
from repro_torch.models import attention as t_attention
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_tf
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.paged_decode import paged_decode_step, supports_paged_decode
from repro_torch.models.registry import get_arch
from repro_torch.serving.engine import HostSpillPool, InferenceEngine
from repro_torch.serving.paged_kv import PagedInferenceEngine
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import ContinuousBatchingScheduler

TOL = dict(rtol=1e-4, atol=1e-4)
MOE = ["deepseek-moe-16b", "kimi-k2-1t-a32b"]
DENSE = ["olmo-1b", "qwen1.5-4b", "chatglm3-6b"]
NAMES = MOE + DENSE
COUNTERS = ("dispatches", "decode_steps", "prefill_calls", "kv_bytes_moved",
            "fused_folds", "prefix_hits", "prefill_flops_saved", "page_evictions")


def _np(x):
    return np.asarray(x, dtype=np.float32)


def with_biases(tree: dict, seed: int = 1) -> dict:
    """Redraw every ``attn.bq/bk/bv`` of a numpy params tree, N(0, 0.5)."""
    rng = np.random.default_rng(seed)
    for stack in ("dense_layers", "layers"):
        attn = tree.get(stack, {}).get("attn", {})
        for b in ("bq", "bk", "bv"):
            if b in attn:
                attn[b] = (0.5 * rng.standard_normal(attn[b].shape)).astype(np.float32)
    return tree


def make_pair(name: str, **over):
    """(JAX arch, JAX params, port arch, port params, numpy tree) of the
    reduced ``name`` with ``over`` replaced in its config."""
    jarch = j_get_arch(name)
    jarch = dataclasses.replace(jarch, cfg=dataclasses.replace(jarch.cfg.reduced(), **over))
    arch = get_arch(name)
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg.reduced(), **over))
    tree = with_biases(jax.tree_util.tree_map(np.asarray, jarch.init(jax.random.PRNGKey(0))))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jarch, jparams, arch, params_from_numpy(tree, arch.cfg, device="cpu"), tree


_PAIRS: dict = {}


def _pair(name: str):
    if name not in _PAIRS:
        _PAIRS[name] = make_pair(name)
    return _PAIRS[name]


# ------------------------------------------------------------------ configs

@pytest.mark.parametrize("reduce", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_config_matches_reference(name, reduce):
    ref, port = j_get_arch(name).cfg, get_arch(name).cfg
    if reduce:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert str(port.pdtype).split(".")[-1] == np.dtype(ref.pdtype).name


@pytest.mark.parametrize("name", NAMES + ["llama3-8b", "mamba2-1.3b"])
def test_param_counts_equal_reference(name):
    """``param_count``/``active_param_count`` of every ported config, full
    width and reduced, are the reference's."""
    for ref, port in ((j_get_arch(name).cfg, get_arch(name).cfg),
                      (j_get_arch(name).cfg.reduced(), get_arch(name).cfg.reduced())):
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()


def test_deepseek_counts_and_families():
    cfg = get_arch("deepseek-moe-16b").cfg
    assert cfg.param_count() == 16_375_726_080
    assert cfg.active_param_count() < cfg.param_count()
    for name in NAMES:
        assert supports_paged_decode(get_arch(name).cfg)


@pytest.mark.parametrize("name", NAMES)
def test_init_params_tree_matches_reference(name):
    """``init_params`` on the CPU builds the reference's tree (keys, shapes;
    empty norm dicts for olmo, ``dense_layers`` for MoE) and repeats per
    seed; the biases start at zero as in the reference."""
    _ja, _jp, arch, _tp, tree = _pair(name)
    mine = t_tf.init_params(arch.cfg, seed=0, device="cpu")
    shapes = jax.tree_util.tree_map(np.shape, tree)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), mine,
                                  is_leaf=torch.is_tensor) == shapes
    again = t_tf.init_params(arch.cfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(mine),
                                                jax.tree_util.tree_leaves(again)))
    if arch.cfg.qkv_bias:
        assert not mine["layers"]["attn"]["bq"].any()
    if arch.cfg.norm == "nonparam_ln":
        assert mine["layers"]["ln1"] == {} and mine["final_norm"] == {}


# ------------------------------------------------------------------- layers

@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam_ln"])
def test_norms_match_reference(kind):
    rng = np.random.default_rng(2)
    x = (3 * rng.standard_normal((2, 5, 64)) + 1).astype(np.float32)
    ref = j_layers.norm_params(kind, 64, jnp.float32)
    init = t_layers.norm_params(kind, 64, torch.float32, "cpu")
    assert sorted(init) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(init[k].numpy(), _np(ref[k]))
    p = {k: rng.standard_normal(np.shape(v)).astype(np.float32) for k, v in ref.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = t_layers.apply_norm(kind, tp, torch.from_numpy(x))
    want = j_layers.apply_norm(kind, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d", [16, 128])
def test_half_rope_matches_reference(d):
    """ChatGLM's half RoPE: the first d/2 rotated with rope_freqs(d/2), the
    rest passed through bit for bit."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 6, 4, d)).astype(np.float32)
    k = rng.standard_normal((2, 6, 2, d)).astype(np.float32)
    pos = rng.integers(0, 500, size=(2, 6)).astype(np.int32)
    tq, tk = t_layers.apply_rope_half(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(pos), 10_000.0)
    jq, jk = j_layers.apply_rope_half(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                                      10_000.0)
    np.testing.assert_allclose(tq.numpy(), _np(jq), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), _np(jk), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tq.numpy()[..., d // 2:], q[..., d // 2:])


def test_what_is_not_ported_still_raises():
    """What stays unported raises: a ring-buffer decode over a cache
    longer than its window (no cache of either package has one),
    ``ValueError``.  Every configuration of the reference now has a copy
    in the port (and every family trains: ``test_torch_train_families.py``)."""
    cfg = get_arch("llama3-8b").cfg.reduced()
    x = torch.zeros((1, 1, cfg.d_model))
    kv = torch.zeros((1, 8, cfg.n_kv_heads, cfg.hd))
    with pytest.raises(ValueError, match="ring buffer"):
        t_attention.decode_attention({}, cfg, x, kv, kv, torch.zeros(1, dtype=torch.int32),
                                     window=4)
    for name in ("seamless-m4t-medium", "qwen2-vl-2b", "hymba-1.5b"):
        assert dataclasses.asdict(get_arch(name).cfg) == dataclasses.asdict(j_get_arch(name).cfg)


@pytest.mark.parametrize("name", ["qwen1.5-4b", "chatglm3-6b"])
def test_attention_with_biases_matches_reference(name):
    jarch, jparams, arch, tparams, _tree = _pair(name)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, arch.cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    lp = t_tf.layer_slice(tparams["layers"], 0)
    jlp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"])
    assert float(lp["attn"]["bq"].abs().max()) > 0.1
    got = t_attention.attention(lp["attn"], arch.cfg, torch.from_numpy(x),
                                torch.from_numpy(pos.copy()))
    want = j_attention.attention(jlp["attn"], jarch.cfg, jnp.asarray(x), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# ------------------------------------------------------------- model steps

@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_reference(name):
    """A right-padded batch's logits at every position and the KV of every
    stack, ``max_len`` padding included."""
    jarch, jparams, arch, tparams, _tree = _pair(name)
    toks = np.random.default_rng(5).integers(0, 256, size=(3, 10)).astype(np.int32)
    logits, cache = t_tf.prefill(arch.cfg, tparams, torch.from_numpy(toks), max_len=16,
                                 return_all_logits=True)
    jlogits, jcache = j_tf.prefill(jarch.cfg, jparams, jnp.asarray(toks), max_len=16,
                                   return_all_logits=True)
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **TOL)
    assert sorted(cache) == sorted(jcache)
    for stack in cache:
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[stack][key].numpy(), _np(jcache[stack][key]),
                                       **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_matches_reference(name):
    jarch, jparams, arch, tparams, _tree = _pair(name)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, 256, size=(3, 10)).astype(np.int32)
    _l, cache = t_tf.prefill(arch.cfg, tparams, torch.from_numpy(toks), max_len=16)
    _jl, jcache = j_tf.prefill(jarch.cfg, jparams, jnp.asarray(toks), max_len=16)
    token = rng.integers(0, 256, size=3).astype(np.int32)
    lengths = np.array([10, 4, 15], np.int32)
    logits, cache = t_tf.decode_step(arch.cfg, tparams, torch.from_numpy(token), cache,
                                     torch.from_numpy(lengths))
    jlogits, jcache = j_tf.decode_step(jarch.cfg, jparams, jnp.asarray(token), jcache,
                                       jnp.asarray(lengths))
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **TOL)
    for stack in cache:
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[stack][key].numpy(), _np(jcache[stack][key]),
                                       **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_paged_decode_step_matches_reference(name):
    """Four lanes over one page pool per stack: mid page, at capacity, past
    it (the slot clamp) and inactive (the trash page); every stack shares
    the block tables.  Logits of every lane, all pages but the trash page
    (the reference's jnp path attends mean(V) on an inactive lane)."""
    jarch, jparams, arch, tparams, _tree = _pair(name)
    cfg = arch.cfg
    rng = np.random.default_rng(7)
    ps, np_, b = 8, 4, 4
    n_phys = b * np_ + 1
    cache = {stack: {k: rng.standard_normal((n, n_phys, ps, cfg.n_kv_heads, cfg.hd),
                                            dtype=np.float32) for k in ("k", "v")}
             for stack, _kind, n in t_tf._stack_names(cfg)}
    tables = rng.permutation(n_phys - 1).reshape(b, np_).astype(np.int32)
    lengths = np.array([11, 31, 35, 6], np.int32)
    active = np.array([True, True, True, False])
    token = rng.integers(0, cfg.vocab_size, size=b).astype(np.int32)
    tcache = {s: {k: torch.from_numpy(a.copy()) for k, a in st.items()}
              for s, st in cache.items()}
    logits, out = paged_decode_step(cfg, tparams, torch.from_numpy(token), tcache,
                                    torch.from_numpy(tables), torch.from_numpy(lengths),
                                    torch.from_numpy(active))
    jlogits, jout = j_paged_decode_step(
        jarch.cfg, jparams, jnp.asarray(token), jax.tree_util.tree_map(jnp.asarray, cache),
        jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(active), use_kernel=False)
    np.testing.assert_allclose(logits.numpy()[active], _np(jlogits)[active], **TOL)
    for stack in cache:
        for key in ("k", "v"):
            np.testing.assert_allclose(out[stack][key].numpy()[:, :-1],
                                       _np(jout[stack][key])[:, :-1], **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_reference(name):
    """The training forward's logits and the summed MoE aux loss (0 for a
    dense config)."""
    jarch, jparams, arch, tparams, _tree = _pair(name)
    toks = np.random.default_rng(8).integers(0, 256, size=(2, 12)).astype(np.int32)
    logits, aux = arch.forward(tparams, {"tokens": torch.from_numpy(toks)})
    jlogits, jaux = jarch.forward(jparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(logits.detach().numpy(), _np(jlogits), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5, atol=1e-7)
    assert (float(aux) > 0) == arch.cfg.is_moe


# ------------------------------------------------------------------ engines

def _sides(name: str):
    jarch, jparams, arch, tparams, _tree = _pair(name)
    return (dict(Paged=JPagedEngine, Dense=JEngine, Sched=JScheduler, Req=JRequest,
                 Spill=JHostSpillPool, strat=j_strategies, arch=jarch, params=jparams,
                 kw={}),
            dict(Paged=PagedInferenceEngine, Dense=InferenceEngine,
                 Sched=ContinuousBatchingScheduler, Req=Request, Spill=HostSpillPool,
                 strat=strategies, arch=arch, params=tparams, kw={"device": "cpu"}))


def _traffic(mode: str):
    rng = np.random.default_rng(40)
    if mode == "prefix":  # three prompts on one 16-token (two-page) prefix
        shared = rng.integers(1, 256, size=16)
        lens = [3, 5, 2, 4]
        prompts = [np.concatenate([shared, rng.integers(1, 256, size=n)]) for n in lens]
        prompts.insert(2, rng.integers(1, 256, size=7))
    elif mode == "overlap":  # two prompts past max_prompt_len: chunked
        prompts = [rng.integers(1, 256, size=n) for n in (5, 13, 21, 7, 30, 3)]
    elif mode == "spill":  # lanes outgrow 5 pages of 8 mid-decode
        prompts = [rng.integers(1, 256, size=n) for n in (6, 5, 9, 4)]
    else:
        prompts = [rng.integers(1, 256, size=int(n)) for n in rng.integers(2, 17, size=6)]
    return [dict(rid=i, prompt=p.astype(np.int32), max_new_tokens=16 if mode == "spill" else 6)
            for i, p in enumerate(prompts)]


MODES = {
    # mode: (paged engine?, engine kw, scheduler kw)
    "paged": (True, {}, {}),
    "dense": (False, {}, {}),
    "overlap": (True, {}, dict(overlap=True, chunk_tokens=8)),
    "dense-overlap": (False, {}, dict(overlap=True, chunk_tokens=8)),
    "prefix": (True, dict(prefix_share=True, max_prompt_len=24), {}),
    "spill": (True, dict(n_pages=5, prefetch_pages=1), {}),
}


def _serve(side: dict, mode: str):
    paged, ekw, skw = MODES[mode]
    ekw = dict(dict(n_lanes=3, max_prompt_len=16, max_len=32), **ekw, **side["kw"])
    if mode == "spill":
        ekw["kv_spill"] = side["Spill"](8)
    if paged:
        eng = side["Paged"](side["arch"], side["params"], page_size=8, **ekw)
    else:
        eng = side["Dense"](side["arch"], side["params"], **ekw)
    sched = side["Sched"](eng, strategy=side["strat"].GrowingUpperThreshold(initial_upper=2),
                          **skw)
    reqs = [side["Req"](**t) for t in _traffic(mode)]
    for r in reqs:
        sched.submit(r)
    sched.producer_done()
    sched.run_until_drained(max_ticks=2000)
    counters = {a: int(getattr(eng, a, 0)) for a in COUNTERS}
    for a in ("spec_chunks", "kv_spilled", "kv_restored"):
        counters[a] = getattr(sched.stats, a)
    return {r.rid: list(r.generated) for r in reqs}, counters


def engine_case(name: str, mode: str):
    """Serve ``mode``'s traffic through both packages; assert equal streams
    and counters and that the mode did what it is for."""
    jax_out, port_out = (_serve(side, mode) for side in _sides(name))
    assert port_out == jax_out
    streams, c = port_out
    assert all(len(g) == t["max_new_tokens"] for g, t in zip(streams.values(), _traffic(mode)))
    if mode == "overlap":
        assert c["spec_chunks"] >= 2 and c["fused_folds"] >= 1
    if mode == "prefix":
        assert c["prefix_hits"] >= 2 and c["prefill_flops_saved"] > 0
    if mode == "spill":
        assert c["page_evictions"] >= 1 and c["kv_restored"] == c["kv_spilled"] >= 1
    return streams


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", DENSE)
def test_engine_streams_and_counters_equal_reference(name, mode):
    engine_case(name, mode)


def test_launcher_runs_on_the_cpu(capsys):
    serve.main(["--arch", "chatglm3-6b", "--reduced", "--device", "cpu", "--requests", "4",
                "--max-new", "4"])
    out = capsys.readouterr().out
    assert "served 4 requests, 16 tokens" in out
