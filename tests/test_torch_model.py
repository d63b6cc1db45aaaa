"""The port's dense llama3-8b path on the CPU against the JAX package.

Reduced llama3-8b in float32, weights drawn once by the JAX package and
carried across with ``params_from_numpy``.  Tolerance for logits and KV:
1e-4 absolute and relative, because the two frameworks sum the matrix
products and softmaxes in another order (observed differences are about
1e-6 on O(1) values); the dense decode step's cache, 1e-5 (it holds
projections only, no softmax).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as j_attention
from repro.models import layers as j_layers
from repro.models import mlp as j_mlp
from repro.models import transformer as j_tf
from repro.models.paged_decode import paged_decode_step as j_paged_decode_step
from repro.models.paged_decode import sample_tokens as j_sample_tokens
from repro.models.registry import get_arch as j_get_arch
from repro_torch.models import attention as t_attention
from repro_torch.models import layers as t_layers
from repro_torch.models import mlp as t_mlp
from repro_torch.models import transformer as t_tf
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.paged_decode import paged_decode_step, sample_tokens
from repro_torch.models.registry import get_arch

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def setup():
    jarch = j_get_arch("llama3-8b")
    jarch = dataclasses.replace(jarch, cfg=jarch.cfg.reduced())
    jparams = jarch.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    arch = get_arch("llama3-8b")
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    return jarch, jparams, arch, params_from_numpy(tree, arch.cfg, device="cpu"), tree


def _np(x):
    return np.asarray(x, dtype=np.float32)


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("reduce", [False, True])
def test_config_matches_reference(reduce):
    """Same fields, same values, full width and reduced; only the dtype
    properties change type."""
    ref = j_get_arch("llama3-8b").cfg
    port = get_arch("llama3-8b").cfg
    if reduce:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.n_layers, port.d_model, port.n_heads, port.n_kv_heads, port.hd) == (
        ref.n_layers, ref.d_model, ref.n_heads, ref.n_kv_heads, ref.hd)
    assert str(port.pdtype).split(".")[-1] == np.dtype(ref.pdtype).name


def test_init_params_keys_and_shapes_match_reference(setup):
    """``init_params`` on the CPU draws the reference's tree: same keys,
    shapes and scales (different numbers: the generators differ)."""
    _jarch, _jp, arch, _tp, tree = setup
    mine = t_tf.init_params(arch.cfg, seed=0, device="cpu")
    shapes = jax.tree_util.tree_map(np.shape, tree)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), mine,
                                  is_leaf=torch.is_tensor) == shapes
    again = t_tf.init_params(arch.cfg, seed=0, device="cpu")
    other = t_tf.init_params(arch.cfg, seed=1, device="cpu")
    w = mine["layers"]["attn"]["wq"]
    assert torch.equal(w, again["layers"]["attn"]["wq"])
    assert not torch.equal(w, other["layers"]["attn"]["wq"])
    ref_std = float(np.std(tree["layers"]["attn"]["wq"]))
    assert abs(float(w.std()) - ref_std) < 0.1 * ref_std


def test_params_from_numpy_round_trip(setup):
    _jarch, _jp, _arch, tparams, tree = setup
    back = params_to_numpy(tparams)
    flat_ref = jax.tree_util.tree_leaves_with_path(tree)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_back]
    for (_p, a), (_q, b) in zip(flat_ref, flat_back):
        np.testing.assert_array_equal(a, b)
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for t in jax.tree_util.tree_leaves(tparams))


# ------------------------------------------------------------------ layers

def test_rmsnorm_rope_and_mlp_match_reference(setup):
    jarch, jparams, arch, tparams, _tree = setup
    cfg = arch.cfg
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, cfg.d_model), dtype=np.float32)
    w = rng.standard_normal((cfg.d_model,), dtype=np.float32)
    np.testing.assert_allclose(
        t_layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        _np(j_layers.rmsnorm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    q = rng.standard_normal((2, 5, 4, 16), dtype=np.float32)
    k = rng.standard_normal((2, 5, 2, 16), dtype=np.float32)
    pos = rng.integers(0, 600, size=(2, 5)).astype(np.int32)
    got = t_layers.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(pos), cfg.rope_theta)
    want = j_layers.apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos),
                               cfg.rope_theta)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w_), **TOL)
    lp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["mlp"])
    tp = {k_: v[0] for k_, v in tparams["layers"]["mlp"].items()}
    np.testing.assert_allclose(t_mlp.mlp(tp, cfg, torch.from_numpy(x)).numpy(),
                               _np(j_mlp.mlp(lp, jarch.cfg, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("window", [0, 4])
def test_attention_matches_reference(setup, window):
    """Causal self-attention through the op (window 0) and the plain
    sliding-window branch, against the reference's jnp attention."""
    jarch, jparams, arch, tparams, _tree = setup
    jcfg = dataclasses.replace(jarch.cfg, attn_window=window)
    cfg = dataclasses.replace(arch.cfg, attn_window=window)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, cfg.d_model), dtype=np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["layers"]["attn"])
    tp = {k: v[1] for k, v in tparams["layers"]["attn"].items()}
    y, (k, v) = t_attention.attention(tp, cfg, torch.from_numpy(x),
                                      torch.from_numpy(pos.copy()), return_kv=True)
    jy, (jk, jv) = j_attention.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                         return_kv=True)
    np.testing.assert_allclose(y.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(k.numpy(), _np(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), _np(jv), **TOL)


# ----------------------------------------------------------------- prefill

def test_prefill_right_padded_batch_matches_reference(setup):
    """Logits at every position and the KV cache (padded to max_len) of a
    right-padded batch, as the engine dispatches it."""
    jarch, jparams, arch, tparams, _tree = setup
    rng = np.random.default_rng(2)
    plens = [12, 7, 3, 1]
    toks = np.zeros((4, 16), np.int32)
    for i, n in enumerate(plens):
        toks[i, :n] = rng.integers(1, arch.cfg.vocab_size, size=n)
    logits, cache = t_tf.prefill(arch.cfg, tparams, torch.from_numpy(toks),
                                 max_len=32, return_all_logits=True)
    jlogits, jcache = j_tf.prefill(jarch.cfg, jparams, tokens=jnp.asarray(toks),
                                   max_len=32, return_all_logits=True)
    assert tuple(logits.shape) == (4, 16, arch.cfg.vocab_size)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **TOL)
    for name in jcache:
        for key in ("k", "v"):
            assert tuple(cache[name][key].shape) == jcache[name][key].shape
            np.testing.assert_allclose(cache[name][key].numpy(),
                                       _np(jcache[name][key]), **TOL)
    # Real rows' first tokens do not depend on the padding.
    last = logits[torch.arange(4), torch.tensor(plens) - 1].argmax(-1)
    for i, n in enumerate(plens):
        alone, _ = t_tf.prefill(arch.cfg, tparams, torch.from_numpy(toks[i:i + 1, :n]))
        assert int(alone.argmax(-1)[0]) == int(last[i])


def test_prefill_last_position_logits(setup):
    _jarch, _jp, arch, tparams, _tree = setup
    toks = torch.arange(1, 11, dtype=torch.int32)[None]
    last, cache = t_tf.prefill(arch.cfg, tparams, toks)
    every, _ = t_tf.prefill(arch.cfg, tparams, toks, return_all_logits=True)
    torch.testing.assert_close(last, every[:, -1], rtol=1e-5, atol=1e-5)
    assert tuple(cache["layers"]["k"].shape) == (2, 1, 10, 2, 16)


# ------------------------------------------------------------ paged decode

def _paged_inputs(cfg, seed: int):
    """Four lanes, page size 8, four pages a lane (s_max 32): a lane mid
    page, a lane at capacity (length s_max - 1), a lane past it (the slot
    clamp min(length, s_max - 1)) and an inactive lane, whose write goes
    to the trash page P - 1."""
    rng = np.random.default_rng(seed)
    L, ps, np_, b = cfg.n_layers, 8, 4, 4
    n_phys = b * np_ + 1
    shape = (L, n_phys, ps, cfg.n_kv_heads, cfg.hd)
    cache = {"layers": {"k": rng.standard_normal(shape, dtype=np.float32),
                        "v": rng.standard_normal(shape, dtype=np.float32)}}
    tables = rng.permutation(n_phys - 1).reshape(b, np_).astype(np.int32)
    lengths = np.array([11, 31, 35, 6], np.int32)
    active = np.array([True, True, True, False])
    token = rng.integers(0, cfg.vocab_size, size=b).astype(np.int32)
    return token, cache, tables, lengths, active


@pytest.mark.parametrize("pallas", [False, True])
def test_paged_decode_step_matches_reference(setup, pallas):
    """Logits and pages against the reference's step, through its jnp ref
    or its Pallas kernel under interpret.  Against the Pallas kernel every
    lane and every page (trash page included: one inactive lane, so its
    content is deterministic).  Against the jnp ref only the active lanes:
    for a length-0 row it returns mean(V), the kernel and the port zeros."""
    jarch, jparams, arch, tparams, _tree = setup
    token, cache, tables, lengths, active = _paged_inputs(arch.cfg, seed=3)
    tcache = {n: {k: torch.from_numpy(a.copy()) for k, a in st.items()}
              for n, st in cache.items()}
    logits, out = paged_decode_step(arch.cfg, tparams, torch.from_numpy(token), tcache,
                                    torch.from_numpy(tables), torch.from_numpy(lengths),
                                    torch.from_numpy(active))
    assert out is tcache  # updated in place
    jlogits, jout = j_paged_decode_step(
        jarch.cfg, jparams, jnp.asarray(token),
        jax.tree_util.tree_map(jnp.asarray, cache), jnp.asarray(tables),
        jnp.asarray(lengths), jnp.asarray(active), use_kernel=pallas, interpret=pallas)
    rows = slice(None) if pallas else active
    np.testing.assert_allclose(logits.numpy()[rows], _np(jlogits)[rows], **TOL)
    # Through the jnp ref the inactive lane's hidden state differs after
    # layer 0 (mean(V) against zeros), and so does what it writes into the
    # trash page from layer 1 on: there, every page but the trash page.
    pages = slice(None) if pallas else slice(0, -1)
    for key in ("k", "v"):
        np.testing.assert_allclose(out["layers"][key].numpy()[:, pages],
                                   _np(jout["layers"][key])[:, pages], **TOL)


def test_paged_decode_writes_exactly_the_slot(setup):
    """Each active lane writes one row, at page table[min(len, s_max-1) //
    ps], offset min(len, s_max-1) % ps; the inactive lane writes only the
    trash page; no other row changes."""
    _jarch, _jp, arch, tparams, _tree = setup
    token, cache, tables, lengths, active = _paged_inputs(arch.cfg, seed=4)
    before = cache["layers"]["k"].copy()
    tcache = {"layers": {k: torch.from_numpy(a.copy()) for k, a in cache["layers"].items()}}
    paged_decode_step(arch.cfg, tparams, torch.from_numpy(token), tcache,
                      torch.from_numpy(tables), torch.from_numpy(lengths),
                      torch.from_numpy(active))
    changed = np.argwhere((tcache["layers"]["k"].numpy() != before).any(axis=(3, 4)))
    written = {(int(p), int(o)) for _l, p, o in changed}
    n_phys = before.shape[1]
    expect = set()
    for lane, (n, on) in enumerate(zip(lengths, active)):
        slot = min(int(n), 31)
        expect.add((int(tables[lane, slot // 8]), slot % 8) if on else (n_phys - 1, slot % 8))
    assert written == expect


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_tokens_greedy_matches_jnp_argmax(seed):
    """Temperature 0 is argmax with the first maximum on ties."""
    rng = np.random.default_rng(seed)
    logits = rng.integers(0, 3, size=(6, 50)).astype(np.float32)  # many ties
    zeros = np.zeros(6, np.float32)
    got = sample_tokens(torch.from_numpy(logits), zeros, np.zeros(6, np.int32),
                        np.arange(6, dtype=np.int32))
    want = j_sample_tokens(jnp.asarray(logits), jnp.asarray(zeros),
                           jnp.zeros(6, jnp.int32), jnp.arange(6, dtype=jnp.int32))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -------------------------------------------------------------------- head

def test_head_bf16_keeps_float32_accumulators(setup):
    """At bf16 the logits are the float32 accumulation of the bf16
    operands, as the reference's ``preferred_element_type=float32``: a
    bf16-rounded product is off by up to a bf16 ulp of the logit (about
    0.03 here), far outside 1e-4."""
    jarch, _jp, arch, _tp, _tree = setup
    cfg = dataclasses.replace(arch.cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = dataclasses.replace(jarch.cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 3, cfg.d_model), dtype=np.float32)
    w = rng.standard_normal((cfg.d_model, cfg.vocab_size), dtype=np.float32)
    tx, tw = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    got = t_tf._head(cfg, {"lm_head": {"w": tw}}, tx)
    want = j_tf._head(jcfg, {"lm_head": {"w": jnp.asarray(tw.float().numpy())}},
                      jnp.asarray(tx.float().numpy()))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-4)


# ------------------------------------------------------------ dense decode

def _dense_inputs(cfg, seed: int, s_max: int = 12):
    """Four lanes over a random cache: mid-cache, at capacity (s_max - 1),
    past it (the slot clamp min(length, s_max - 1)) and at length 0."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, 4, s_max, cfg.n_kv_heads, cfg.hd)
    cache = {"layers": {"k": rng.standard_normal(shape, dtype=np.float32),
                        "v": rng.standard_normal(shape, dtype=np.float32)}}
    lengths = np.array([5, s_max - 1, s_max + 3, 0], np.int32)
    token = rng.integers(0, cfg.vocab_size, size=4).astype(np.int32)
    return token, cache, lengths


@pytest.mark.parametrize("window", [0, 4])
def test_decode_attention_matches_reference(setup, window):
    """One layer's one-token decode through the op: output and both cache
    slices against the reference's.  Window 0 over a 12-row cache; window
    4 over a ring of 4 rows (a cache holds min(max_len, W) rows), where
    the lanes at 5, 11 and 15 have wrapped and the one at 0 has not."""
    jarch, jparams, arch, tparams, _tree = setup
    jcfg = dataclasses.replace(jarch.cfg, attn_window=window)
    cfg = dataclasses.replace(arch.cfg, attn_window=window)
    _tok, cache, lengths = _dense_inputs(cfg, seed=5)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 1, cfg.d_model), dtype=np.float32)
    ck, cv = (cache["layers"][k][1][:, :window or None] for k in ("k", "v"))
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["layers"]["attn"])
    tp = {k: v[1] for k, v in tparams["layers"]["attn"].items()}
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    kw = {"window": window} if window else {}
    y, k_out, v_out = t_attention.decode_attention(
        tp, cfg, torch.from_numpy(x), tk, tv, torch.from_numpy(lengths), **kw)
    assert k_out is tk and v_out is tv  # written in place
    jy, jk, jv = j_attention.decode_attention(
        jp, jcfg, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(lengths), **kw)
    np.testing.assert_allclose(y.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(tk.numpy(), _np(jk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), _np(jv), rtol=1e-5, atol=1e-5)


def test_decode_step_matches_reference(setup):
    """The whole one-token step over the stacked cache: logits within
    1e-4, caches within 1e-5, and exactly one row written per lane and
    layer, at the reference's slot min(length, s_max - 1)."""
    jarch, jparams, arch, tparams, _tree = setup
    token, cache, lengths = _dense_inputs(arch.cfg, seed=7)
    before = {k: a.copy() for k, a in cache["layers"].items()}
    tcache = {"layers": {k: torch.from_numpy(a.copy()) for k, a in before.items()}}
    logits, out = arch.decode_step(tparams, torch.from_numpy(token), tcache,
                                   torch.from_numpy(lengths))
    assert out is tcache and logits.dtype == torch.float32
    jlogits, jout = jarch.decode_step(jparams, jnp.asarray(token),
                                      jax.tree_util.tree_map(jnp.asarray, cache),
                                      jnp.asarray(lengths))
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **TOL)
    s_max = before["k"].shape[2]
    slots = np.minimum(lengths, s_max - 1)
    for key in ("k", "v"):
        got, want = out["layers"][key].numpy(), _np(jout["layers"][key])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        changed = np.argwhere((got != before[key]).any(axis=(3, 4)))
        assert {(int(l_), int(b), int(t)) for l_, b, t in changed} == {
            (l_, b, int(slots[b])) for l_ in range(arch.cfg.n_layers) for b in range(4)}
        jchanged = np.argwhere((want != before[key]).any(axis=(3, 4)))
        np.testing.assert_array_equal(changed, jchanged)
