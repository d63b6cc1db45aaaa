"""Decode on a mesh: 4 ``gloo`` CPU ranks at mesh (data=2, model=2), spawned
once for the module.

Each case is a reduced config in float32, the JAX package's weights carried
across with ``params_from_numpy``, a random cache of 4 lanes with ragged
lengths, and 6 decode steps fed fixed tokens.  The cache, token and
lengths are placed as the dry run places a decode cell's
(``launch.dryrun._input_placements``): the default layout (lanes over
``data``, the caches replicated over ``model``) and ``kv_seq_shard`` (the
KV caches' rows over ``model``: the split-KV decode, whose three
all-reduces combine each rank's partial softmax).  Each step's logits lie
within 1e-5 of the port's unsharded ``decode_step`` (the same float32
arithmetic, summed in another order) and within 1e-4 of the JAX package's;
after the 6 steps every cache leaf equals the unsharded cache within 1e-6,
so each new token's K/V was written where the cache lives.

Also on those ranks: the split-KV decode against one plain decode over the
whole cache, for ragged lengths where one rank holds no valid row of a
lane; and, on a ``fake`` process group, a cache placement the decode
cannot keep is refused with ``ValueError`` instead of being written as a
redistributed copy.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.registry import get_arch as jget_arch
from repro_torch.distributed.launch import run_ranks
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import get_arch

CASES = ("llama3-8b", "hymba-1.5b", "qwen2-vl-2b", "seamless-m4t-medium", "deepseek-moe-16b")
LAYOUTS = ("default", "kv_seq_shard")
B, MAX_LEN, SRC_LEN, STEPS = 4, 16, 8, 6
TIMEOUT_S = 600
# Lane lengths before the first step: lane 1 starts empty; lanes 0, 1 and
# 3 stay within the first rank's rows under kv_seq_shard (8 of 16), so the
# other rank holds none of theirs.  hymba's ring (16 rows = its window)
# wraps lanes 0 and 2 during the steps.
LENGTHS = {"hymba-1.5b": [14, 3, 20, 9]}
DEFAULT_LENGTHS = [2, 0, 9, 1]


def _archs(name: str):
    ja, ta = jget_arch(name), get_arch(name)
    return (dataclasses.replace(ja, cfg=ja.cfg.reduced()),
            dataclasses.replace(ta, cfg=ta.cfg.reduced()))


def _case(name: str, seed: int) -> dict:
    """Numpy weights, a random cache, the lengths and the steps' tokens."""
    ja, ta = _archs(name)
    params = jax.tree_util.tree_map(np.asarray, ja.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    spec = ta.init_cache(B, MAX_LEN, device="meta",
                         src_len=SRC_LEN if ta.cfg.is_encoder_decoder else None)
    cache = torch.utils._pytree.tree_map(
        lambda t: rng.standard_normal(t.shape).astype(np.float32), spec)
    tokens = rng.integers(0, ta.cfg.vocab_size, size=(STEPS, B)).astype(np.int32)
    lengths = np.array(LENGTHS.get(name, DEFAULT_LENGTHS), np.int32)
    return {"params": params, "cache": cache, "tokens": tokens, "lengths": lengths}


def _tree(fn, tree):
    return torch.utils._pytree.tree_map(fn, tree)


def _split_kv_case(seed: int) -> dict:
    """q (4, 8, 16), caches (4, 16, 2, 16): lane lengths 0, 3, 8, 13 over
    two sequence shards of 8 rows (rank 1 holds no valid row of lanes 0-2)."""
    rng = np.random.default_rng(seed)
    return {"q": rng.standard_normal((4, 8, 16)).astype(np.float32),
            "k": rng.standard_normal((4, 16, 2, 16)).astype(np.float32),
            "v": rng.standard_normal((4, 16, 2, 16)).astype(np.float32),
            "lengths": np.array([0, 3, 8, 13], np.int32)}


def _decode_worker(rank, world, cases, kv_case):
    """One rank: each case's sharded decode in both layouts, then the
    split-KV decode on its own."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed.sharding import distribute_params, full, mesh_context
    from repro_torch.distributed.split_kv import split_kv_decode
    from repro_torch.launch.dryrun import _input_placements
    from repro_torch.launch.mesh import make_test_mesh

    mesh = make_test_mesh(2, 2, device_type="cpu")
    out = {}
    for name, case in cases.items():
        _ja, ta = _archs(name)
        params = distribute_params(mesh, params_from_numpy(case["params"], ta.cfg,
                                                           device="cpu"))
        for layout in LAYOUTS:
            opts = frozenset({layout}) - {"default"}
            inputs = {"token": torch.from_numpy(case["tokens"][0]),
                      "cache": _tree(torch.from_numpy, case["cache"]),
                      "lengths": torch.from_numpy(case["lengths"])}
            placed = torch.utils._pytree.tree_map(
                lambda t, pl: distribute_tensor(t.clone(), mesh, pl, src_data_rank=None),
                inputs, _input_placements(mesh, inputs, opts),
                is_leaf=lambda x: isinstance(x, tuple))
            cache, logits = placed["cache"], []
            with mesh_context(mesh):
                for step in range(STEPS):
                    tok = distribute_tensor(torch.from_numpy(case["tokens"][step]), mesh,
                                            placed["token"].placements, src_data_rank=None)
                    lg, cache = ta.decode_step(params, tok, cache, placed["lengths"] + step)
                    logits.append(full(lg).numpy())
            full_cache = _tree(lambda t: t.full_tensor().numpy(), cache)
            out[(name, layout)] = {"logits": np.stack(logits),
                                   "cache": full_cache if rank == 0 else None}
    # The split-KV decode alone: lanes over data, rows over model.
    q = distribute_tensor(torch.from_numpy(kv_case["q"]), mesh, [Shard(0), Replicate()],
                          src_data_rank=None)
    k, v = (distribute_tensor(torch.from_numpy(kv_case[n]), mesh, [Shard(0), Shard(1)],
                              src_data_rank=None) for n in ("k", "v"))
    lengths = distribute_tensor(torch.from_numpy(kv_case["lengths"]), mesh,
                                [Shard(0), Replicate()], src_data_rank=None)
    with mesh_context(mesh):
        o = split_kv_decode(q, k, v, lengths)
    out["split_kv"] = o.full_tensor().numpy()
    return out


@pytest.fixture(scope="module")
def ranks():
    cases = {name: _case(name, i) for i, name in enumerate(CASES)}
    kv_case = _split_kv_case(7)
    return cases, kv_case, run_ranks(_decode_worker, 4, cases, kv_case, timeout_s=TIMEOUT_S)


def _unsharded(name: str, case: dict):
    """The port's decode on one device: logits per step, final cache."""
    _ja, ta = _archs(name)
    params = params_from_numpy(case["params"], ta.cfg, device="cpu")
    cache = _tree(lambda a: torch.from_numpy(a.copy()), case["cache"])
    lengths = torch.from_numpy(case["lengths"])
    logits = []
    for step in range(STEPS):
        lg, cache = ta.decode_step(params, torch.from_numpy(case["tokens"][step]), cache,
                                   lengths + step)
        logits.append(lg.numpy())
    return np.stack(logits), _tree(lambda t: t.numpy(), cache)


def _jax_logits(name: str, case: dict) -> np.ndarray:
    ja, _ta = _archs(name)
    params = jax.tree_util.tree_map(jnp.asarray, case["params"])
    cache = jax.tree_util.tree_map(jnp.asarray, case["cache"])
    step_fn = jax.jit(ja.decode_step)
    logits = []
    for step in range(STEPS):
        lg, cache = step_fn(params, jnp.asarray(case["tokens"][step]), cache,
                            jnp.asarray(case["lengths"] + step))
        logits.append(np.asarray(lg))
    return np.stack(logits)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name", CASES)
def test_mesh_decode_matches_unsharded_and_jax(ranks, name, layout):
    cases, _kv, results = ranks
    want, want_cache = _unsharded(name, cases[name])
    jlogits = _jax_logits(name, cases[name])
    np.testing.assert_allclose(want, jlogits, rtol=0, atol=1e-4)
    for r in results:
        got = r[(name, layout)]["logits"]
        for step in range(STEPS):
            np.testing.assert_allclose(got[step], want[step], rtol=0, atol=1e-5,
                                       err_msg=f"{name} {layout} step {step}")
            np.testing.assert_allclose(got[step], jlogits[step], rtol=0, atol=1e-4,
                                       err_msg=f"{name} {layout} step {step} vs JAX")
    got_cache = results[0][(name, layout)]["cache"]
    flat_got = dict(torch.utils._pytree.tree_flatten_with_path(got_cache)[0])
    for path, a in torch.utils._pytree.tree_flatten_with_path(want_cache)[0]:
        np.testing.assert_allclose(flat_got[path], a, rtol=0, atol=1e-5,
                                   err_msg=f"{name} {layout} cache {path}")


def test_split_kv_decode_matches_one_plain_decode(ranks):
    """Ragged lengths 0, 3, 8, 13 over two shards of 8 rows: the three
    all-reduces' combine equals one plain decode over all 16 rows, and a
    lane of length 0 gives zeros."""
    from repro_torch.kernels.decode_attention.ref import decode_ref

    _cases, kv, results = ranks
    want = decode_ref(*(torch.from_numpy(kv[n]) for n in ("q", "k", "v", "lengths"))).numpy()
    assert not want[0].any()
    for r in results:
        np.testing.assert_allclose(r["split_kv"], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("placement", ["Shard(3)", "Partial()", "Shard(1)"])
def test_decode_refuses_a_cache_it_would_write_as_a_copy(placement):
    """A cache whose placement no local decode keeps (its head dim split,
    a partial sum, or its rows split, which only the split-KV decode of
    ``models.attention`` combines) raises ``ValueError``: the op never
    writes into a redistributed copy of it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed.sharding import mesh_context
    from repro_torch.kernels.decode_attention.ops import decode_op
    from repro_torch.launch.dryrun import fake_process_group
    from repro_torch.launch.mesh import make_test_mesh

    pl = {"Shard(3)": [Replicate(), Shard(3)], "Partial()": [Replicate(), Partial()],
          "Shard(1)": [Replicate(), Shard(1)]}[placement]
    with fake_process_group(4):
        mesh = make_test_mesh(2, 2, device_type="cpu")
        k = DTensor.from_local(torch.zeros(2, 8, 2, 16), mesh, pl, run_check=False)
        v = DTensor.from_local(torch.zeros(2, 8, 2, 16), mesh, pl, run_check=False)
        rep = [Replicate(), Replicate()]
        q = DTensor.from_local(torch.zeros(2, 4, 16), mesh, rep, run_check=False)
        lengths = DTensor.from_local(torch.ones(2, dtype=torch.int32), mesh, rep,
                                     run_check=False)
        k_new = DTensor.from_local(torch.ones(2, 2, 16), mesh, rep, run_check=False)
        with mesh_context(mesh), pytest.raises(ValueError, match="cache"):
            decode_op(q, k, v, lengths, k_new=k_new, v_new=k_new,
                      slot=torch.zeros(2, dtype=torch.long))
        assert not k.to_local().any()
