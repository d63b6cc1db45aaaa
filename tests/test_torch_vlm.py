"""qwen2-vl-2b in the port against the JAX package: M-RoPE, the patch
embeddings' frontend stub and the paged engine; the registry's ten
architectures.

Reduced qwen2-vl in float32 (2 layers, GQA 4/2, head dim 16, M-RoPE
sections (2, 3, 3), QKV bias, tied head), the JAX weights carried across
with ``params_from_numpy`` and the QKV biases, which the reference
initialises to zeros, redrawn nonzero so that a missing add shows.  The
stub inputs are seeded normals made with numpy, as the reference's own
encoder-decoder test draws its source embeddings: 16 patch embeddings on
a 4 x 4 grid at temporal position 0 (rows h and w run over the grid), then
text, whose three rows are equal and continue after the grid.  The
reference masks on the temporal row, so the patches attend each other
both ways; the port's flash op masks on those positions too.  Model steps
agree within ``TOL`` = 1e-4 (another summation order, about 1e-6 on
O(1) values); RoPE within 1e-5; engines give equal greedy streams.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import strategies as j_strategies
from repro.models import layers as j_layers
from repro.models.registry import ARCH_IDS
from repro.models.registry import get_arch as j_get_arch
from repro.serving.paged_kv import PagedInferenceEngine as JPagedEngine
from repro.serving.request import Request as JRequest
from repro.serving.scheduler import ContinuousBatchingScheduler as JScheduler
from repro_torch.core import strategies
from repro_torch.launch import serve
from repro_torch.models import attention as t_attention
from repro_torch.models import layers as t_layers
from repro_torch.models import registry as t_registry
from repro_torch.models import transformer as t_tf
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.paged_decode import paged_decode_step, supports_paged_decode
from repro_torch.models.registry import get_arch
from repro_torch.serving.paged_kv import PagedInferenceEngine
from repro_torch.serving.request import Request
from repro_torch.serving.scheduler import ContinuousBatchingScheduler

TOL = dict(rtol=1e-4, atol=1e-4)
ROPE_TOL = dict(rtol=1e-5, atol=1e-5)
NAME = "qwen2-vl-2b"


def _np(x):
    return np.asarray(x, dtype=np.float32)


@pytest.fixture(scope="module")
def pair():
    jarch = j_get_arch(NAME)
    jarch = dataclasses.replace(jarch, cfg=jarch.cfg.reduced())
    arch = get_arch(NAME)
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    tree = jax.tree_util.tree_map(np.asarray, jarch.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for b in ("bq", "bk", "bv"):
        a = tree["layers"]["attn"][b]
        tree["layers"]["attn"][b] = (0.5 * rng.standard_normal(a.shape)).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    return jarch, jparams, arch, params_from_numpy(tree, arch.cfg, device="cpu"), tree


def grid_positions(b: int, s: int, side: int = 4) -> np.ndarray:
    """(3, B, S) positions: ``side`` x ``side`` patches at temporal 0, then
    text at ``side``, ``side`` + 1, ... on all three rows."""
    n = side * side
    pos = np.zeros((3, b, s), np.int32)
    pos[1, :, :n], pos[2, :, :n] = np.arange(n) // side, np.arange(n) % side
    pos[:, :, n:] = side + np.arange(s - n)
    return pos


def _embeds(cfg, seed: int, b: int, s: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((b, s, cfg.d_model)).astype(np.float32)


# ------------------------------------------------------------------ layers

def test_mrope_matches_reference_and_degenerates_to_rope():
    """M-RoPE with distinct rows against the reference's; with three equal
    rows it is the standard RoPE (exactly: the same angles)."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 7, 2, 16)).astype(np.float32)
    pos3 = rng.integers(0, 300, size=(3, 2, 7)).astype(np.int32)
    tq, tk = t_layers.apply_mrope(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(pos3), 1e6, (2, 3, 3))
    jq, jk = j_layers.apply_mrope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos3), 1e6,
                                  (2, 3, 3))
    np.testing.assert_allclose(tq.numpy(), _np(jq), **ROPE_TOL)
    np.testing.assert_allclose(tk.numpy(), _np(jk), **ROPE_TOL)
    same = np.broadcast_to(pos3[:1], pos3.shape).copy()
    mq, mk = t_layers.apply_mrope(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(same), 1e6, (2, 3, 3))
    rq, rk = t_layers.apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(same[0]), 1e6)
    assert torch.equal(mq, rq) and torch.equal(mk, rk)
    with pytest.raises(ValueError, match="sections"):
        t_layers.apply_mrope(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(pos3), 1e6, (2, 3, 2))


def test_rope_dispatch_broadcasts_2d_positions(pair):
    """``_rope`` for M-RoPE takes (B, S) positions as three equal rows (the
    decode path's), and (3, B, S) as they are."""
    _ja, _jp, arch, _tp, _tree = pair
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.standard_normal((1, 5, 4, 16)).astype(np.float32))
    pos = torch.arange(5)[None]
    a = t_attention._rope(arch.cfg, q, q, pos)
    b = t_attention._rope(arch.cfg, q, q, pos.expand(3, 1, 5))
    assert torch.equal(a[0], b[0])


# ------------------------------------------------------------------ model

def test_forward_and_prefill_with_embeds_match_reference(pair):
    """The training forward and ``prefill`` on patch embeddings with grid
    positions (the mask on the temporal row: patches attend each other
    both ways), logits at every position and the KV cache."""
    jarch, jparams, arch, tparams, _tree = pair
    emb, pos = _embeds(arch.cfg, 5, 2, 24), grid_positions(2, 24)
    tl, _aux = arch.forward(tparams, {"embeds": torch.from_numpy(emb),
                                      "positions": torch.from_numpy(pos)})
    jl, _jaux = jarch.forward(jparams, {"embeds": jnp.asarray(emb),
                                        "positions": jnp.asarray(pos)})
    np.testing.assert_allclose(tl.numpy(), _np(jl), **TOL)
    logits, cache = arch.prefill(tparams, {"embeds": torch.from_numpy(emb),
                                           "positions": torch.from_numpy(pos)}, max_len=40)
    jlogits, jcache = jarch.prefill(jparams, {"embeds": jnp.asarray(emb),
                                              "positions": jnp.asarray(pos)}, max_len=40)
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache["layers"][key].numpy(), _np(jcache["layers"][key]),
                                   **TOL)
    # the first patch sees the last one: an index-causal mask would differ
    causal, _c = arch.prefill(tparams, {"embeds": torch.from_numpy(emb[:, :1])})
    assert not np.allclose(tl[:, 0].numpy(), causal.numpy(), atol=1e-3)


def test_decode_after_embeds_prefill_matches_reference(pair):
    """``Arch.decode_step`` after the embeddings' prefill: 8 greedy tokens
    at positions ``lengths`` (three equal rows), logits and tokens."""
    jarch, jparams, arch, tparams, _tree = pair
    emb, pos = _embeds(arch.cfg, 6, 2, 24), grid_positions(2, 24)
    logits, cache = arch.prefill(tparams, {"embeds": torch.from_numpy(emb),
                                           "positions": torch.from_numpy(pos)}, max_len=40)
    jlogits, jcache = jarch.prefill(jparams, {"embeds": jnp.asarray(emb),
                                              "positions": jnp.asarray(pos)}, max_len=40)
    lengths = np.full((2,), 24, np.int32)
    jdecode = jax.jit(jarch.decode_step)
    for _ in range(8):
        np.testing.assert_allclose(logits.numpy(), _np(jlogits), **TOL)
        tok = logits.argmax(-1).to(torch.int32)
        assert np.array_equal(tok.numpy(), np.asarray(jnp.argmax(jlogits, -1)))
        logits, cache = arch.decode_step(tparams, tok, cache, torch.from_numpy(lengths))
        jlogits, jcache = jdecode(jparams, jnp.asarray(tok.numpy()), jcache,
                                  jnp.asarray(lengths))
        lengths = lengths + 1


def test_paged_decode_step_matches_dense(pair):
    """M-RoPE decodes through the paged kernel's op: ``paged_decode_step``
    over a text prefill's KV (the serving engines' ``transformer.prefill``)
    cut into pages equals the dense ``decode_step``."""
    _ja, _jp, arch, tparams, _tree = pair
    cfg = arch.cfg
    assert supports_paged_decode(cfg)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    _l, cache = t_tf.prefill(cfg, tparams, torch.from_numpy(toks), max_len=32)
    pages = {"layers": {k: torch.cat([a.reshape(cfg.n_layers, 8, 8, cfg.n_kv_heads, cfg.hd),
                                      torch.zeros((cfg.n_layers, 1, 8, cfg.n_kv_heads,
                                                   cfg.hd))], dim=1)
                        for k, a in cache["layers"].items()}}
    tables = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    token = torch.tensor([3, 9], dtype=torch.int32)
    lengths = torch.tensor([16, 16], dtype=torch.int32)
    paged, _p = paged_decode_step(cfg, tparams, token, pages, tables, lengths,
                                  torch.tensor([True, True]))
    dense, _d = arch.decode_step(tparams, token, cache, lengths)
    np.testing.assert_allclose(paged.numpy(), dense.numpy(), **TOL)


# ----------------------------------------------------------------- engines

def test_paged_engine_streams_equal_reference(pair):
    """Text requests through both packages' paged engines: greedy streams
    and counters equal."""
    jarch, jparams, arch, tparams, _tree = pair
    rng = np.random.default_rng(8)
    traffic = [dict(rid=i, prompt=rng.integers(1, 256, size=int(n)).astype(np.int32),
                    max_new_tokens=12) for i, n in enumerate(rng.integers(3, 20, size=6))]
    out = []
    for Eng, Sched, Req, strat, a, p, kw in (
            (JPagedEngine, JScheduler, JRequest, j_strategies, jarch, jparams, {}),
            (PagedInferenceEngine, ContinuousBatchingScheduler, Request, strategies, arch,
             tparams, {"device": "cpu"})):
        eng = Eng(a, p, n_lanes=3, max_prompt_len=32, max_len=48, page_size=8, **kw)
        sched = Sched(eng, strategy=strat.GrowingUpperThreshold(initial_upper=2))
        reqs = [Req(**t) for t in traffic]
        for r in reqs:
            sched.submit(r)
        sched.producer_done()
        sched.run_until_drained()
        out.append(([r.generated for r in reqs], eng.dispatches, eng.decode_steps,
                    eng.kv_bytes_moved))
    assert out[1] == out[0]


def test_launcher_serves_reduced_qwen2_vl(capsys):
    serve.main(["--arch", NAME, "--reduced", "--device", "cpu", "--requests", "4",
                "--max-new", "4"])
    assert "served 4 requests, 16 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------- registry

@pytest.mark.parametrize("name", ARCH_IDS)
def test_registry_has_every_architecture(name):
    """``get_arch`` gives an ``Arch`` for all ten of the reference's
    ``ARCH_IDS``, with the reference's config, full width and reduced."""
    assert t_registry.ARCH_IDS == ARCH_IDS
    arch = get_arch(name)
    assert isinstance(arch, t_registry.Arch)
    assert dataclasses.asdict(arch.cfg) == dataclasses.asdict(j_get_arch(name).cfg)
    assert arch.cfg.reduced().param_count() == j_get_arch(name).cfg.reduced().param_count()


def test_converter_round_trip(pair):
    _ja, _jp, arch, tparams, tree = pair
    back = params_to_numpy(tparams)
    assert sorted(back) == sorted(tree) and "lm_head" not in back  # tied head
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
    assert get_arch(NAME).cfg.param_count() == 1_543_712_768
