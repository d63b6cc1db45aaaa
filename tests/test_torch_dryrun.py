"""The port's dry run, per-op cost and roofline report, on the CPU; the
kernels' sharding rules and the ``decode_attention`` custom op on the
card (marker ``gpu``).

Dry-run cells on a fake (data=4, model=2) process group, for reduced
llama3-8b, deepseek-moe-16b and mamba2-1.3b, train / prefill / decode:
each traces, counts flops and collectives and writes the reference's
keys.  Each ``moe`` call of the MoE forward holds one all-reduce over
``model``, counted around the call (the twin of
``test_multidevice.py::test_small_mesh_moe_compiles_with_collectives``).
A pure data-parallel cell's per-device flops are the one-rank cell's
over dp, exactly.  Each custom op's flop formula equals a hand count.
This file imports no JAX: its ``gpu`` tests run on the card's machine,
which has none.  GPU tolerances: float32 1e-4 (sums in another order),
bf16 1e-2 (one bf16 ulp), as ``test_torch_gpu.py``'s; the decode op
bit for bit against the launch it wraps.
"""
from __future__ import annotations

import dataclasses
import io
import json
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import dryrun, op_cost, roofline
from repro_torch.models import transformer
from repro_torch.models.config import SHAPES, ShapeSpec
from repro_torch.models.registry import get_arch

ARCHS = ["llama3-8b", "deepseek-moe-16b", "mamba2-1.3b"]
KINDS = ["train", "prefill", "decode"]
KEYS = ("flops_per_device", "bytes_per_device", "collectives", "t_compute_s", "t_memory_s",
        "t_collective_s", "dominant", "model_flops_per_chip", "useful_flops_ratio",
        "argument_size_bytes", "temp_size_bytes", "hbm_fit", "live_bytes")


def _reduced(name: str):
    a = get_arch(name)
    return dataclasses.replace(a, cfg=a.cfg.reduced())


def _cell(name, kind, mesh_shape=(4, 2), b=8, s=16, opts=frozenset()):
    return dryrun.run_cell(_reduced(name), ShapeSpec(f"{kind}_{s}", s, b, kind), "single",
                           opts=opts, mesh_shape=mesh_shape)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ARCHS)
def test_reduced_cell_traces_on_fake_ranks(name, kind):
    row = _cell(name, kind)
    assert not dist.is_initialized()  # the cell's fake process group is gone
    for k in KEYS:
        assert k in row, k
    assert row["chips"] == 8 and row["mesh"] == "4x2" and row["step"] == kind
    assert row["flops_per_device"] > 0 and row["bytes_per_device"] > 0
    assert row["collectives"]["total_count"] > 0
    assert row["live_bytes"] >= row["argument_size_bytes"] > 0 and row["hbm_fit"]
    json.dumps(row)


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "mamba2-1.3b", "seamless-m4t-medium"])
def test_train_cell_with_one_row_per_rank(name):
    """A batch of 4 on dp=4: each rank's single row.  The shared experts'
    gradient, mamba2's norm over a ``model``-split d_inner and the
    decoder's embedding are constrained where a partial sum over ``model``
    would otherwise be split over the sequence (a layout the backward's
    products cannot take)."""
    row = _cell(name, "train", b=4)
    assert row["flops_per_device"] > 0 and row["collectives"]["reduce-scatter"]["count"] > 0


# (option, step kind, global batch): microbatch8 needs 8 rows on each of dp=4
_OPT_CELLS = [("kv_seq_shard", "decode", 8), ("donate_cache", "decode", 8),
              ("chunked_prefill", "prefill", 8), ("microbatch8", "train", 32),
              ("int8_moments", "train", 8)]


@pytest.mark.parametrize("opt,kind,b", _OPT_CELLS)
@pytest.mark.parametrize("name", ARCHS)
def test_each_option_traces_on_fake_ranks(name, opt, kind, b):
    """Every ``OPTS`` entry on the (4, 2) fake mesh, against the cell
    without it: flops within 1 % (the options change layout, memory or the
    loop, not the model's products; a rank's share of the small ones can
    move, as mamba2's decode with its state split over ``model``, or
    deepseek's router and capacity per microbatch), and for each its own
    effect on the row.  Under ``kv_seq_shard`` a rank's decode attention
    covers half the rows (the default layout's covers all of them on each
    ``model`` rank, its caches replicated there), so those flops halve."""
    base = _cell(name, kind, b=b)
    row = _cell(name, kind, b=b, opts=frozenset({opt}))
    assert row["opts"] == [opt]
    flops = base["flops_per_device"]
    if opt == "kv_seq_shard":  # each rank decodes its half of the rows
        assert _decode_flops(row) * 2 == _decode_flops(base)
        flops -= _decode_flops(base) / 2
    assert abs(row["flops_per_device"] - flops) <= 1e-2 * flops
    if opt == "kv_seq_shard":  # the cache split over `model` too
        assert row["argument_size_bytes"] < base["argument_size_bytes"]
        assert row["live_bytes"] <= base["live_bytes"]
        _assert_split_kv_counts(row, base, _attention_layers(name))
    elif opt == "int8_moments":  # 1 byte + a float32 scale per 64, not 4 bytes, per moment
        assert row["argument_size_bytes"] < base["argument_size_bytes"]
    elif opt == "microbatch8":  # one FSDP gather of each weight per microbatch
        gathers = [r["collectives"]["all-gather"]["count"] for r in (row, base)]
        assert gathers[0] > gathers[1]
        assert row["live_bytes"] < base["live_bytes"]
    else:  # the port's decode writes its cache in place anyway; flash is chunked anyway
        assert row["argument_size_bytes"] == base["argument_size_bytes"]
        assert row["live_bytes"] == base["live_bytes"]


def _decode_flops(row) -> float:
    """A row's flops in the decode kernels' ops."""
    return sum(f for op, f in row["flops_by_op"].items() if op.startswith("decode_attention"))


def _attention_layers(name: str) -> int:
    """Decode attentions a step: every layer of a dense, MoE or hybrid
    stack; an encoder-decoder's self and cross attention; none in mamba2."""
    cfg = _reduced(name).cfg
    if cfg.is_encoder_decoder:
        return 2 * cfg.n_layers
    return 0 if cfg.family == "ssm" else cfg.n_layers


def _assert_split_kv_counts(row, base, n_attn: int) -> None:
    """The split-KV decode against the default layout: three all-reduces
    over ``model`` (max, sum, out) per attention, and no all-gather over
    ``model`` that the default layout does not make (q's, which both
    make): no KV cache is gathered."""
    got, want = row["collectives_by_axis"], base["collectives_by_axis"]
    assert got.get("all-reduce@model", 0) - want.get("all-reduce@model", 0) == 3 * n_attn
    if n_attn:
        assert got.get("all-gather@model", 0) == want.get("all-gather@model", 0)


@pytest.mark.parametrize("name", ["hymba-1.5b", "seamless-m4t-medium"])
def test_kv_seq_shard_decode_splits_each_attention(name):
    """hymba's ring layers and seamless's self and cross attention under
    ``kv_seq_shard``: the split-KV decode's three all-reduces over
    ``model`` for each, and no more live bytes than the default layout."""
    base = _cell(name, "decode")
    row = _cell(name, "decode", opts=frozenset({"kv_seq_shard"}))
    assert row["live_bytes"] <= base["live_bytes"]
    got, want = row["collectives_by_axis"], base["collectives_by_axis"]
    n_attn = _attention_layers(name)
    assert got["all-reduce@model"] - want["all-reduce@model"] == 3 * n_attn
    if name == "seamless-m4t-medium":  # no SSM state, whose heads hymba gathers
        assert got["all-gather@model"] == want["all-gather@model"]


def test_each_moe_call_holds_one_all_reduce_over_model(monkeypatch):
    """Around every ``moe`` call of a deepseek prefill on the (4, 2) fake
    mesh: exactly one all-reduce over ``model`` (the ``psum``)."""
    from repro_torch.distributed.sharding import current_mesh

    inner, counts = transformer.moe, []

    def counted(p, cfg, x):
        oc = op_cost.OpCost(current_mesh())
        with oc:
            out = inner(p, cfg, x)
        counts.append((oc.count("all-reduce", "model"), oc.collectives["all-reduce"]["count"]))
        return out

    monkeypatch.setattr(transformer, "moe", counted)
    row = _cell("deepseek-moe-16b", "prefill")
    n_moe = _reduced("deepseek-moe-16b").cfg.n_layers - 1
    assert len(counts) == n_moe and all(c[0] == 1 for c in counts), counts
    assert row["collectives"]["all-reduce"]["count"] >= n_moe


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_pure_data_parallel_flops_divide_by_dp(kind):
    one = _cell("llama3-8b", kind, mesh_shape=(1, 1))
    four = _cell("llama3-8b", kind, mesh_shape=(4, 1))
    assert four["flops_per_device"] * 4 == one["flops_per_device"]
    assert one["collectives"]["total_count"] == 0


def test_custom_op_flop_formulas_equal_hand_counts():
    f = op_cost.flop_registry
    ops = torch.ops.repro_torch
    b, hq, hkv, s, d = 2, 4, 2, 8, 16
    q, k = torch.empty(b, hq, s, d), torch.empty(b, hkv, s, d)
    causal_pairs = s * (s + 1) // 2
    assert f[ops.flash_attention](q, k, k, True, 0, None) == 4 * b * hq * d * causal_pairs
    assert f[ops.flash_attention](q, k, k, False, 0, None) == 4 * b * hq * d * s * s
    band = sum(min(i + 1, 3) for i in range(s))  # window 3: keys i-2..i
    assert f[ops.flash_attention](q, k, k, True, 3, None) == 4 * b * hq * d * band
    assert op_cost.attention_pairs(4, 6, True, 0) == 1 + 2 + 3 + 4
    assert f[ops.batched_gather](torch.empty(10, 4), torch.empty(5, dtype=torch.long)) == 0
    st, dec = torch.empty(2, 3, 4, 5, 6), torch.empty(2, 3, 4)
    assert f[ops.ssd_scan](st, dec, None) == 2 * 2 * 3 * 4 * 5 * 6
    assert f[ops.ssd_scan_bwd](st, None, st, dec) == 4 * 2 * 3 * 4 * 5 * 6
    cache = torch.empty(b, 32, hkv, d)
    assert f[ops.decode_attention](torch.empty(b, hq, d), cache, cache,
                                   torch.empty(b), None, None, None) == 4 * b * hq * d * 32
    assert f[ops.decode_attention_lse](torch.empty(b, hq, d), cache, cache,
                                       torch.empty(b)) == 4 * b * hq * d * 32


def test_op_cost_counts_a_custom_op_once_on_real_tensors():
    q = torch.randn(1, 2, 8, 16)
    with op_cost.OpCost() as oc:
        torch.ops.repro_torch.flash_attention(q, q, q, True, 0, None)
    assert oc.flops_by_op == {"flash_attention": 4 * 2 * 16 * 36}


def test_roofline_renders_the_ports_rows(tmp_path, monkeypatch):
    rows = {"llama3-8b|train_16|single": _cell("llama3-8b", "train", mesh_shape=(2, 2))}
    path = tmp_path / "dryrun_torch.json"
    path.write_text(json.dumps(rows, default=str))
    monkeypatch.setattr(sys, "argv", ["roofline", "--json", str(path), "--md"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        roofline.main()
    out = buf.getvalue()
    assert "| llama3-8b | train_16 |" in out and "hillclimb candidates" in out


def test_results_path_and_shapes_are_the_reference_set():
    assert roofline.RESULTS == dryrun.RESULTS and dryrun.RESULTS.name == "dryrun_torch.json"
    assert list(SHAPES) == ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    assert [s.name for s in get_arch("mamba2-1.3b").cfg.shapes()][-1] == "long_500k"
    assert dryrun.run_cell("llama3-8b", "long_500k", "single") == {
        "skipped": "full attention cannot serve 524k context (see DESIGN.md)"}


# ------------------------------------------------------------------ card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture
def nccl_mesh():
    """A (1, 1) NCCL mesh over this process alone."""
    _card()
    from repro_torch.distributed.launch import _free_port
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        from repro_torch.launch.mesh import make_test_mesh
        yield make_test_mesh(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_op_equals_the_launch_it_wraps(dtype):
    _card()
    from repro_torch.kernels.decode_attention.ops import (
        _decode_op,
        decode_attention_cuda,
        decode_op,
    )
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(4, 8, 64, generator=g, device="cuda").to(dtype)
    k = torch.randn(4, 96, 2, 64, generator=g, device="cuda").to(dtype)
    v = torch.randn(4, 96, 2, 64, generator=g, device="cuda").to(dtype)
    lens = torch.tensor([1, 50, 96, 7], dtype=torch.int32, device="cuda")
    want = decode_attention_cuda(q, k, v, lens)
    assert torch.equal(_decode_op(q, k, v, lens, None, None, None), want)  # the custom op
    assert torch.equal(decode_op(q, k, v, lens), want)
    # with the write: the same as writing by hand, then the launch
    kn, vn = torch.randn(4, 2, 64, generator=g, device="cuda").to(dtype), \
        torch.randn(4, 2, 64, generator=g, device="cuda").to(dtype)
    slot = torch.tensor([1, 50, 95, 7], device="cuda")
    k2, v2, k3, v3 = k.clone(), v.clone(), k.clone(), v.clone()
    got = decode_op(q, k, v, lens + 1, k_new=kn, v_new=vn, slot=slot)
    got_op = _decode_op(q, k3, v3, lens + 1, kn, vn, slot)
    rows = torch.arange(4, device="cuda")
    k2[rows, slot], v2[rows, slot] = kn, vn
    for kk, vv in ((k, v), (k3, v3)):
        assert torch.equal(kk, k2) and torch.equal(vv, v2)
    want = decode_attention_cuda(q, k2, v2, lens + 1)
    assert torch.equal(got, want) and torch.equal(got_op, want)


def _rule_cases(dtype):
    from repro_torch.kernels.decode_attention.ops import decode_op

    g = torch.Generator(device="cuda").manual_seed(1)

    def r(*s):
        return torch.randn(*s, generator=g, device="cuda").to(dtype)

    ops = torch.ops.repro_torch
    return [
        ("flash", ops.flash_attention.default, (r(2, 4, 32, 64), r(2, 2, 32, 64),
                                                r(2, 2, 32, 64), True, 0, None)),
        # the decode op has no DTensor rule: decode_op runs it on the shards
        ("decode", decode_op, (r(2, 4, 64), r(2, 16, 2, 64), r(2, 16, 2, 64),
                               torch.tensor([3, 16], device="cuda", dtype=torch.int32))),
    ]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["flash", "decode"])
def test_sharding_rule_on_a_one_rank_mesh_equals_the_op(nccl_mesh, case):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed.sharding import mesh_context

    _name, op, args = dict((c[0], c) for c in _rule_cases(torch.float32))[case]
    want = op(*args)
    placed = [distribute_tensor(a, nccl_mesh, [Shard(0), Replicate()])
              if isinstance(a, torch.Tensor) and a.is_floating_point() else
              distribute_tensor(a, nccl_mesh, [Replicate(), Replicate()])
              if isinstance(a, torch.Tensor) else a for a in args]
    with mesh_context(nccl_mesh):
        got = op(*placed)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.full_tensor().float().cpu().numpy(),
                                   b.float().cpu().numpy(), rtol=0, atol=1e-4)
