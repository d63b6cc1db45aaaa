"""seamless-m4t-medium in the port against the JAX package: the
encoder-decoder, cross attention and the GELU MLPs.

Reduced seamless-m4t in float32 (2 encoder and 2 decoder layers, MHA 4/2
at head dim 16, LayerNorm, GELU), the JAX weights carried across with
``params_from_numpy``.  The source embeddings are seeded normals made
with numpy, as the reference's own test draws them
(``tests/test_models_smoke.py::test_encdec_prefill_decode``).  Model steps
agree within ``TOL`` = 1e-4 (another summation order, about 1e-6 on O(1)
values); the activations within 1e-5: ``jax.nn.gelu``'s default is the
tanh approximation, which ``approximate="tanh"`` computes.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as j_attention
from repro.models import encdec as j_encdec
from repro.models import mlp as j_mlp
from repro.models.registry import get_arch as j_get_arch
from repro_torch.models import attention as t_attention
from repro_torch.models import encdec as t_encdec
from repro_torch.models import mlp as t_mlp
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.paged_decode import supports_paged_decode
from repro_torch.models.registry import get_arch

TOL = dict(rtol=1e-4, atol=1e-4)
ACT_TOL = dict(rtol=1e-5, atol=1e-5)
NAME = "seamless-m4t-medium"


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


def _inputs(cfg, seed: int, b: int = 2, s_src: int = 24, s_tgt: int = 7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s_src, cfg.d_model)).astype(np.float32),
            rng.integers(0, cfg.vocab_size, (b, s_tgt)).astype(np.int32))


# ------------------------------------------------------------- config, mlp

def test_config_tree_and_converter_match_reference(pair):
    """The config and ``param_count`` (full width and reduced), the
    parameter tree's keys and shapes (``enc_layers``, ``enc_norm``,
    ``ln_cross``, ``cross_attn``; no ``w_gate`` in the GELU MLP), and the
    converter's round trip."""
    for ref, port in ((j_get_arch(NAME).cfg, get_arch(NAME).cfg),
                      (j_get_arch(NAME).cfg.reduced(), get_arch(NAME).cfg.reduced())):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
    assert get_arch(NAME).cfg.param_count() == 877_080_576
    _ja, _jp, arch, tparams, tree = pair
    mine = arch.init(seed=0, device="cpu")
    assert (jax.tree_util.tree_map(lambda a: tuple(a.shape), mine, is_leaf=torch.is_tensor)
            == jax.tree_util.tree_map(np.shape, tree))
    assert sorted(mine["layers"]) == ["attn", "cross_attn", "ln1", "ln2", "ln_cross", "mlp"]
    assert sorted(mine["layers"]["mlp"]) == ["w_in", "w_out"]
    back = params_to_numpy(tparams)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert not supports_paged_decode(arch.cfg)


@pytest.mark.parametrize("act", ["gelu", "geglu"])
def test_gelu_mlps_match_reference(pair, act):
    """GELU (seamless) and GeGLU on the same weights and input: the tanh
    approximation in float32, as ``jax.nn.gelu`` computes it."""
    jarch, _jp, arch, _tp, _tree = pair
    jcfg = dataclasses.replace(jarch.cfg, act=act)
    cfg = dataclasses.replace(arch.cfg, act=act)
    p = jax.tree_util.tree_map(np.asarray, j_mlp.mlp_params(jax.random.PRNGKey(3), jcfg))
    gen = torch.Generator().manual_seed(0)
    assert sorted(t_mlp.mlp_params(gen, cfg, "cpu")) == sorted(p)
    x = 3 * np.random.default_rng(4).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    got = t_mlp.mlp({k: torch.from_numpy(v.copy()) for k, v in p.items()}, cfg,
                    torch.from_numpy(x))
    want = j_mlp.mlp({k: jnp.asarray(v) for k, v in p.items()}, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), _np(want), **ACT_TOL)


# -------------------------------------------------------------- attention

def test_cross_and_encoder_attention_match_reference(pair):
    """Cross attention over a 24-frame memory (no RoPE, T != S) and the
    encoder's non-causal self-attention through the flash op."""
    jarch, jparams, arch, tparams, _tree = pair
    cfg = arch.cfg
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["cross_attn"])
    tp = {k: v[0] for k, v in tparams["layers"]["cross_attn"].items()}
    y, (k, v) = t_attention.attention(tp, cfg, torch.from_numpy(x), causal=False,
                                      kv_x=torch.from_numpy(mem), return_kv=True)
    jy, (jk, jv) = j_attention.attention(jp, jarch.cfg, jnp.asarray(x), jnp.asarray(pos),
                                         causal=False, kv_x=jnp.asarray(mem), return_kv=True)
    np.testing.assert_allclose(y.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(k.numpy(), _np(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), _np(jv), **TOL)
    ep = jax.tree_util.tree_map(lambda a: a[1], jparams["enc_layers"]["attn"])
    tep = {k_: v_[1] for k_, v_ in tparams["enc_layers"]["attn"].items()}
    mpos = np.broadcast_to(np.arange(24, dtype=np.int32), (2, 24))
    np.testing.assert_allclose(
        t_attention.attention(tep, cfg, torch.from_numpy(mem), causal=False).numpy(),
        _np(j_attention.attention(ep, jarch.cfg, jnp.asarray(mem), jnp.asarray(mpos),
                                  causal=False)), **TOL)


def test_cross_decode_matches_reference(pair):
    """``cross_decode``: one query per lane over the whole fixed memory KV
    through the decode op (lengths = S_src), which it leaves unchanged."""
    jarch, jparams, arch, tparams, _tree = pair
    cfg = arch.cfg
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    xk, xv = (rng.standard_normal((3, 24, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
              for _ in range(2))
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["layers"]["cross_attn"])
    tp = {k: v[1] for k, v in tparams["layers"]["cross_attn"].items()}
    tk = torch.from_numpy(xk.copy())
    y = t_attention.cross_decode(tp, cfg, torch.from_numpy(x), tk, torch.from_numpy(xv))
    jy = j_encdec._cross_decode(jp, jarch.cfg, jnp.asarray(x), jnp.asarray(xk),
                                jnp.asarray(xv))
    np.testing.assert_allclose(y.numpy(), _np(jy), **TOL)
    assert np.array_equal(tk.numpy(), xk)


# ------------------------------------------------------------------ model

def test_encode_and_forward_match_reference(pair):
    """The encoder's memory and the teacher-forced training forward."""
    jarch, jparams, arch, tparams, _tree = pair
    src, tgt = _inputs(arch.cfg, 7)
    np.testing.assert_allclose(
        t_encdec.encode(arch.cfg, tparams, torch.from_numpy(src)).numpy(),
        _np(j_encdec.encode(jarch.cfg, jparams, jnp.asarray(src))), **TOL)
    tl, taux = arch.forward(tparams, {"src_embeds": torch.from_numpy(src),
                                      "tgt_tokens": torch.from_numpy(tgt)})
    jl, _jaux = jarch.forward(jparams, {"src_embeds": jnp.asarray(src),
                                        "tgt_tokens": jnp.asarray(tgt)})
    assert tl.dtype == torch.float32 and float(taux) == 0.0
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)


def test_prefill_and_decode_match_reference(pair):
    """``prefill_encdec`` (self KV padded to max_len, cross KV of every
    layer) and 12 greedy ``decode_step_encdec``s: logits, tokens, the self
    KV written in place and the cross KV left as it was."""
    jarch, jparams, arch, tparams, _tree = pair
    src, tgt = _inputs(arch.cfg, 8)
    batch = {"src_embeds": src, "tgt_tokens": tgt}
    logits, cache = arch.prefill(tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
                                 max_len=24)
    jlogits, jcache = jarch.prefill(jparams, {k: jnp.asarray(v) for k, v in batch.items()},
                                    max_len=24)
    for key in ("k", "v", "cross_k", "cross_v"):
        assert tuple(cache[key].shape) == tuple(jcache[key].shape)
        np.testing.assert_allclose(cache[key].numpy(), _np(jcache[key]), **TOL)
    cross = cache["cross_k"].clone()
    lengths = np.full((2,), 7, np.int32)
    jdecode = jax.jit(jarch.decode_step)
    for _ in range(12):
        np.testing.assert_allclose(logits.numpy(), _np(jlogits), **TOL)
        tok = logits.argmax(-1).to(torch.int32)
        assert np.array_equal(tok.numpy(), np.asarray(jnp.argmax(jlogits, -1)))
        logits, out = arch.decode_step(tparams, tok, cache, torch.from_numpy(lengths))
        assert out is cache
        jlogits, jcache = jdecode(jparams, jnp.asarray(tok.numpy()), jcache,
                                  jnp.asarray(lengths))
        lengths = lengths + 1
    np.testing.assert_allclose(cache["k"].numpy(), _np(jcache["k"]), **TOL)
    assert torch.equal(cache["cross_k"], cross)


def test_init_cache_takes_src_len(pair):
    """``Arch.init_cache(batch, max_len, src_len=)``: self KV of max_len
    rows, cross KV of src_len (max_len when not given), as the reference's."""
    jarch, _jp, arch, _tp, _tree = pair
    for src_len in (None, 24):
        mine = arch.init_cache(3, 16, device="cpu", src_len=src_len)
        ref = jarch.init_cache(3, 16, src_len=src_len)
        assert {k: tuple(v.shape) for k, v in mine.items()} == \
            {k: tuple(v.shape) for k, v in ref.items()}
