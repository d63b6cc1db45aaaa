"""The port's kernel ops on the CPU: plain PyTorch versions against the JAX
package's jnp references and Pallas kernels (interpret mode), plus the
device-keyed dispatch policy.

Inputs are drawn with numpy and handed to both packages.  Tolerances:
float32 plain versions against float32 jnp/Pallas, 2e-5 absolute and
relative, because the two sides sum the softmax and the PV product in
another order (observed differences are about 1e-6); the dense decode op,
1e-5 (the same sums over fewer keys; also about 1e-6 observed).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from repro.kernels import registry as jreg
from repro.kernels.batched_gather.ref import gather_ref as j_gather_ref
from repro.kernels.decode_attention.kernel import decode_attention_kernel
from repro.kernels.decode_attention.ref import decode_ref as j_decode_ref
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.kernels.paged_attention.ref import paged_decode_ref as j_paged_ref
from repro_torch.kernels import registry
from repro_torch.kernels.batched_gather import ops as gather_ops
from repro_torch.kernels.batched_gather.ref import gather_ref
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention.ref import decode_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import paged_decode_ref

TOL = dict(rtol=2e-5, atol=2e-5)
DECODE_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _paged_case(seed: int, b=3, hq=8, hkv=2, d=64, ps=16, np_=6, zero_lane=True):
    rng = np.random.default_rng(seed)
    n_pages = b * np_ + 1  # page 0 stays out of the tables
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    kp = rng.standard_normal((n_pages, ps, hkv, d), dtype=np.float32)
    vp = rng.standard_normal((n_pages, ps, hkv, d), dtype=np.float32)
    tables = rng.permutation(np.arange(1, n_pages)).reshape(b, np_).astype(np.int32)
    lengths = rng.integers(1, np_ * ps + 1, size=(b,)).astype(np.int32)
    if zero_lane:
        lengths[0] = 0
    return q, kp, vp, tables, lengths


# ------------------------------------------------------------ paged decode

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_sample_matches_jnp_ref_and_pallas(seed):
    """The op's registered sample (the reference's ``_sample`` shapes):
    plain version == jnp ref == Pallas kernel under interpret."""
    s = registry.get("paged_decode_attention").sample(np.random.default_rng(seed))
    got = paged_decode_ref(*map(_t, s.args)).numpy()
    jargs = tuple(jnp.asarray(a) for a in s.args)
    np.testing.assert_allclose(got, np.asarray(j_paged_ref(*jargs)), **TOL)
    pallas = jreg.get("paged_decode_attention").kernel(*jargs, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("seed", [3, 4])
def test_paged_length_zero_rows_are_zeros(seed):
    """Length-0 rows return zeros, as the Pallas kernel does (the jnp ref
    returns mean(V) there); rows with length >= 1 match both."""
    q, kp, vp, tables, lengths = _paged_case(seed)
    got = paged_decode_ref(_t(q), _t(kp), _t(vp), _t(tables), _t(lengths)).numpy()
    assert np.isfinite(got).all() and not got[0].any()
    jargs = tuple(jnp.asarray(a) for a in (q, kp, vp, tables, lengths))
    pallas = np.asarray(jreg.get("paged_decode_attention").kernel(*jargs, interpret=True))
    assert not pallas[0].any()
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got[1:], np.asarray(j_paged_ref(*jargs))[1:], **TOL)


def test_paged_ignores_table_entries_past_length():
    """Entries past ceil(length / ps) are padding: pointing them at other
    pages changes nothing."""
    q, kp, vp, tables, lengths = _paged_case(5, zero_lane=False)
    lengths[:] = [5, 17, 40]
    base = paged_decode_ref(_t(q), _t(kp), _t(vp), _t(tables), _t(lengths))
    scrambled = tables.copy()
    for row, n in enumerate(lengths):
        used = -(-int(n) // kp.shape[1])
        scrambled[row, used:] = 0
    again = paged_decode_ref(_t(q), _t(kp), _t(vp), _t(scrambled), _t(lengths))
    torch.testing.assert_close(base, again, rtol=0, atol=0)


def test_paged_bf16_plain_matches_jnp_ref():
    """bf16 operands: both sides compute in float32 and round once to bf16,
    so they agree to one bf16 ulp of an O(1) value (1e-2)."""
    q, kp, vp, tables, lengths = _paged_case(6, zero_lane=False)
    tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, kp, vp))
    got = paged_decode_ref(tq, tk, tv, _t(tables), _t(lengths))
    assert got.dtype == torch.bfloat16
    jargs = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in (tq, tk, tv)]
    want = j_paged_ref(*jargs, jnp.asarray(tables), jnp.asarray(lengths))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)


# ------------------------------------------------------------ dense decode

def _pallas_decode(q, k, v, lengths):
    """The Pallas kernel under interpret mode, as the reference's own
    kernel tests run it (bk = 32 divides every T below)."""
    return np.asarray(decode_attention_kernel(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        bk=32, interpret=True))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_sample_matches_jnp_ref_and_pallas(seed):
    """The op's registered sample (the reference's ``_sample`` shapes: q
    (2, 4, 64), k/v (2, 128, 2, 64), lengths 1..128): plain version ==
    jnp ref == Pallas kernel under interpret."""
    s = registry.get("decode_attention").sample(np.random.default_rng(seed))
    assert [a.shape for a in s.args] == [(2, 4, 64), (2, 128, 2, 64), (2, 128, 2, 64), (2,)]
    got = decode_ops.decode_op(*map(_t, s.args)).numpy()
    jargs = tuple(jnp.asarray(a) for a in s.args)
    np.testing.assert_allclose(got, np.asarray(j_decode_ref(*jargs)), **DECODE_TOL)
    np.testing.assert_allclose(got, _pallas_decode(*s.args), **DECODE_TOL)


@pytest.mark.parametrize("t", [32, 128])
def test_decode_ragged_lengths_match_jnp_ref_and_pallas(t):
    """Lengths 1 and T and ragged values between, GQA 8:2; length-0 rows
    are zeros, compared with Pallas only (the jnp ref returns mean(V))."""
    rng = np.random.default_rng(t)
    b = 5
    q = rng.standard_normal((b, 8, 32), dtype=np.float32)
    k = rng.standard_normal((b, t, 2, 32), dtype=np.float32)
    v = rng.standard_normal((b, t, 2, 32), dtype=np.float32)
    lengths = np.array([0, 1, t, 7, t - 3], np.int32)
    got = decode_ops.decode_op(_t(q), _t(k), _t(v), _t(lengths)).numpy()
    assert np.isfinite(got).all() and not got[0].any()
    pallas = _pallas_decode(q, k, v, lengths)
    assert not pallas[0].any()
    np.testing.assert_allclose(got, pallas, **DECODE_TOL)
    want = np.asarray(j_decode_ref(*(jnp.asarray(a) for a in (q, k, v, lengths))))
    np.testing.assert_allclose(got[1:], want[1:], **DECODE_TOL)


def test_decode_split_sizes_fill_the_card():
    """Cluster size and keys per block of the CUDA kernel: the dense
    engine's 8 lanes get 256 blocks of 128 keys, the batch-1 chunk side the
    cluster limit (8 blocks of 64 keys per kv head); a wide batch needs no
    split, a short cache is not cut below 32 keys a block, and the blocks
    of a cluster always cover the cache."""
    assert decode_ops._cluster(8, 8, 512) == (4, 128)    # 256 blocks
    assert decode_ops._cluster(1, 8, 512) == (8, 64)     # 64 blocks
    assert decode_ops._cluster(1, 8, 8192) == (8, 1024)  # 16 tiles of 64 a block
    assert decode_ops._cluster(64, 8, 4096) == (1, 4096)
    assert decode_ops._cluster(1, 1, 7) == (1, 7)
    assert decode_ops._cluster(2, 2, 130) == (4, 33)
    for b, hkv, t in [(1, 1, 1), (3, 2, 77), (2, 1, 130), (1, 8, 4096), (8, 8, 8192)]:
        c, kpb = decode_ops._cluster(b, hkv, t)
        assert c in (1, 2, 4, 8) and c * kpb >= t > (c - 1) * kpb


def test_paged_split_sizes_fill_the_card():
    """Cluster size and keys per block of the paged kernel: the dense
    kernel's rule in whole pages.  The serving shape (8 lanes, 8 kv heads,
    32 pages of 16) gets 256 blocks of 128 keys, as the dense kernel at T
    512; one lane the cluster limit; a wide batch no split; a block never
    gets fewer than 32 keys or no page at all; the blocks' page-aligned
    ranges always cover the table."""
    split = paged_ops._cluster
    assert split(8, 8, 32, 16) == (4, 128) == decode_ops._cluster(8, 8, 512)
    assert split(1, 8, 32, 16) == (8, 64)
    assert split(64, 8, 32, 16) == (1, 512)
    assert split(3, 2, 5, 16) == (2, 48)   # a third block would be empty
    assert split(2, 1, 3, 8) == (1, 24)    # 12 keys a block would be too few
    assert split(8, 2, 8, 32) == (8, 32)
    for b, hkv, np_, ps in [(1, 1, 1, 1), (3, 2, 5, 16), (2, 1, 3, 8), (1, 8, 256, 16),
                            (8, 8, 32, 16), (4, 4, 6, 16), (8, 2, 16, 8), (1, 1, 7, 5)]:
        c, kpb = split(b, hkv, np_, ps)
        assert c in (1, 2, 4, 8) and kpb % ps == 0
        assert c * kpb >= np_ * ps > (c - 1) * kpb


_PAGED_SHAPES = [(8, 32, 8, 128, 16, 32), (3, 4, 2, 64, 16, 5), (2, 8, 1, 32, 8, 3),
                 (4, 64, 4, 256, 16, 6), (8, 8, 2, 128, 32, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", _PAGED_SHAPES)
def test_paged_supports_takes_integer_tables_and_lengths(dtype, shape):
    """The paged kernel takes the serving shape and two small ones, a
    group of 16 at D 256 and pages of 32, in float32 and bf16, with int32
    or int64 tables and lengths; not float tables or lengths, a group of
    32 or D 512."""
    b, hq, hkv, d, ps, np_ = shape
    q = torch.zeros(b, hq, d, dtype=dtype)
    kp = torch.zeros(b * np_ + 1, ps, hkv, d, dtype=dtype)
    tabs = torch.zeros(b, np_, dtype=torch.int32)
    lens = torch.zeros(b, dtype=torch.int32)
    ok = paged_ops._supports
    assert ok(q, kp, kp, tabs, lens) and ok(q, kp, kp, tabs.long(), lens.long())
    assert not ok(q, kp, kp, tabs, lens.float())
    assert not ok(q, kp, kp, tabs.to(dtype), lens)
    wide_g = torch.zeros(b, 32 * hkv, d, dtype=dtype)
    assert not ok(wide_g, kp, kp, tabs, lens)
    wide_d = torch.zeros(b * np_ + 1, ps, hkv, 512, dtype=dtype)
    assert not ok(torch.zeros(b, hq, 512, dtype=dtype), wide_d, wide_d, tabs, lens)


def test_flash_instance_choice():
    """bf16 at D 64 or 128 with 16-byte aligned rows runs on the tensor
    cores; float32 (TF32 would round its operands), bf16 at D 16 or 32 and
    misaligned bf16 rows run on the CUDA cores."""
    bf, f = torch.bfloat16, torch.float32
    assert flash_ops._instance(bf, 128) == flash_ops._TENSOR_CORES
    assert flash_ops._instance(bf, 64) == flash_ops._TENSOR_CORES
    for dtype, d in [(f, 128), (f, 64), (f, 16), (bf, 32), (bf, 16)]:
        assert flash_ops._instance(dtype, d) == flash_ops._CUDA_CORES
    assert flash_ops._instance(bf, 128, aligned=False) == flash_ops._CUDA_CORES
    q = torch.zeros(2, 64, 8, 128, dtype=bf).transpose(1, 2)
    assert flash_ops._aligned(q, q)
    assert not flash_ops._aligned(torch.zeros(2, 64, 9, 132, dtype=bf)[..., :128]
                                  .transpose(1, 2))


def test_kernel_library_hash_covers_headers_and_flags(tmp_path, monkeypatch):
    """Editing a header that a source includes from csrc/, or a flag,
    changes the library's path; a header it does not include does not."""
    from repro_torch.kernels import build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    (csrc / "unused.cuh").write_text("// included by nothing\n")
    monkeypatch.setattr(build, "CSRC", csrc)
    assert [p.name for p in build._sources("flash_attention")] == [
        "flash_attention.cu", "common.cuh"]
    before = {n: build._lib_path(n) for n in build.SOURCES}
    (csrc / "unused.cuh").write_text("// still included by nothing\n")
    assert {n: build._lib_path(n) for n in build.SOURCES} == before
    with open(csrc / "common.cuh", "a") as fh:
        fh.write("// edited\n")
    after = {n: build._lib_path(n) for n in build.SOURCES}
    assert after["flash_attention"] != before["flash_attention"]
    assert after["decode_attention"] != before["decode_attention"]
    assert after["ssd_scan"] == before["ssd_scan"]  # includes no csrc header
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-lineinfo"])
    assert build._lib_path("ssd_scan") != after["ssd_scan"]


# ------------------------------------------------------------------- flash

@pytest.mark.parametrize("causal", [True, False])
def test_flash_sample_matches_jnp_ref_and_pallas(causal):
    """The reference's ``_sample`` shapes: plain == jnp ref == Pallas
    (interpret, bq = bk = 32)."""
    s = registry.get("flash_attention").sample(np.random.default_rng(7))
    got = attention_ref(*map(_t, s.args), causal=causal).numpy()
    jargs = tuple(jnp.asarray(a) for a in s.args)
    np.testing.assert_allclose(got, np.asarray(j_attention_ref(*jargs, causal=causal)), **TOL)
    pallas = jreg.get("flash_attention").kernel(*jargs, causal=causal, bq=32, bk=32,
                                                interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)


@pytest.mark.parametrize("s_len", [1, 77, 130])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ragged_matches_jnp_ref(s_len, causal):
    """Any S (no S % bq == 0 requirement in the port), GQA 8:2."""
    rng = np.random.default_rng(s_len)
    q = rng.standard_normal((2, 8, s_len, 32), dtype=np.float32)
    k = rng.standard_normal((2, 2, s_len, 32), dtype=np.float32)
    v = rng.standard_normal((2, 2, s_len, 32), dtype=np.float32)
    got = attention_ref(_t(q), _t(k), _t(v), causal=causal).numpy()
    want = j_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_flash_strided_views_match_contiguous():
    """The model passes (B, S, H, D) buffers viewed as (B, H, S, D)."""
    rng = np.random.default_rng(8)
    q = _t(rng.standard_normal((2, 40, 4, 16), dtype=np.float32))
    k = _t(rng.standard_normal((2, 40, 2, 16), dtype=np.float32))
    v = _t(rng.standard_normal((2, 40, 2, 16), dtype=np.float32))
    views = [a.transpose(1, 2) for a in (q, k, v)]
    assert not views[0].is_contiguous()
    got = flash_ops.attention_op(*views, causal=True)
    want = attention_ref(*(a.contiguous() for a in views), causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_flash_right_padding_is_invisible_to_real_rows():
    """Right-padded prefill: rows before the pad see only real keys, so
    their outputs equal those of the unpadded sequence."""
    rng = np.random.default_rng(9)
    q, k, v = (_t(rng.standard_normal((1, 4, 24, 16), dtype=np.float32)) for _ in range(3))
    k, v = k[:, :2], v[:, :2]
    short = attention_ref(q[:, :, :10], k[:, :, :10], v[:, :, :10], causal=True)
    padded = attention_ref(q, k, v, causal=True)[:, :, :10]
    torch.testing.assert_close(padded, short, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------- batched gather

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_sample_matches_jnp_ref_and_pallas(seed):
    """The reference's ``_sample`` shapes (table (128, 32), 64 ids, bn 16):
    plain version == jnp ref == Pallas kernel under interpret, bit for
    bit (``tol=None`` in the reference)."""
    s = registry.get("batched_gather").sample(np.random.default_rng(seed))
    got = gather_ref(*map(_t, s.args)).numpy()
    jargs = tuple(jnp.asarray(a) for a in s.args)
    np.testing.assert_array_equal(got, np.asarray(j_gather_ref(*jargs)))
    pallas = jreg.get("batched_gather").kernel(*jargs, bn=16, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pallas))


@pytest.mark.parametrize("shape", [(37,), (1,), (3, 5)])
def test_gather_ragged_ids_match_jnp_ref(shape):
    """A count N that no Pallas tile divides (the port's kernel takes any
    N >= 1) and ids of any shape: ids.shape + (D,), bit for bit."""
    rng = np.random.default_rng(5)
    table = rng.standard_normal((50, 24), dtype=np.float32)
    ids = rng.integers(0, 50, size=shape).astype(np.int32)
    got = gather_ops.gather_op(_t(table), _t(ids))
    assert got.shape == shape + (24,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.take(table, ids, axis=0)))


def test_gather_op_gradient_and_vmap_match_jax():
    """The op's gradient (the scatter-add) equals ``jax.grad`` of ``take``
    with repeated ids; ``vmap`` over a batch of id sets equals ``jax.vmap``."""
    rng = np.random.default_rng(6)
    table = rng.standard_normal((20, 8), dtype=np.float32)
    ids = rng.integers(0, 5, size=(3, 7)).astype(np.int32)
    up = rng.standard_normal((3, 7, 8), dtype=np.float32)
    want = jax.grad(lambda t: jnp.sum(jnp.take(t, jnp.asarray(ids), axis=0) * up))(
        jnp.asarray(table))
    t = _t(table).requires_grad_()
    (got,) = torch.autograd.grad(gather_ops.gather_op(t, _t(ids)), t, _t(up))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    jv = jax.vmap(lambda i: jnp.take(jnp.asarray(table), i, axis=0))(jnp.asarray(ids))
    tv = torch.vmap(lambda i: gather_ops.gather_op(_t(table), i))(_t(ids))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_gather_supports_gates():
    """float32 and bf16 tables, int32 and int64 ids of any shape, N >= 1;
    not float16, not a strided or 3-D table, not float or empty ids, not
    ids on another device."""
    ok = gather_ops._supports
    table, ids = torch.zeros(16, 8), torch.zeros(5, dtype=torch.int32)
    assert ok(table, ids) and ok(table.bfloat16(), ids.long().reshape(5, 1))
    assert not ok(table.half(), ids)
    assert not ok(torch.zeros(8, 16).t(), ids)
    assert not ok(torch.zeros(2, 16, 8), ids)
    assert not ok(table, ids.float())
    assert not ok(table, ids[:0])
    assert not ok(table, ids.to("meta"))


# ---------------------------------------------------------------- dispatch

OPS = ["batched_gather", "decode_attention", "flash_attention", "paged_decode_attention",
       "ssd_scan"]


def test_registry_names_and_samples():
    assert registry.names() == OPS
    for name in registry.names():
        op = registry.get(name)
        assert isinstance(op.kernel.launches, int)
    with pytest.raises(KeyError, match="registered"):
        registry.get("no_such_op")


def test_launch_counter_is_thread_safe():
    """Two threads raising one kernel's counter 10 000 times each, with
    the interpreter switching threads every microsecond, count 20 000:
    the speculation thread and the main thread launch at the same time."""
    import sys
    import threading

    kernel = decode_ops.decode_attention_cuda
    registry.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [registry.count_launch(kernel) for _ in range(10_000)])
            for _ in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert registry.launch_counts()["decode_attention"] == 20_000
    registry.reset_launches()
    assert registry.launch_counts() == {n: 0 for n in OPS}


@pytest.mark.parametrize("name", OPS)
def test_cpu_operands_take_the_plain_version(name):
    """A CPU tensor runs the plain version and never counts a launch."""
    op = registry.get(name)
    s = op.sample(np.random.default_rng(10))
    args = tuple(map(_t, s.args))
    registry.reset_launches()
    out = registry.dispatch(name, args, common=s.common)
    torch.testing.assert_close(out, op.ref(*args, **s.common), rtol=0, atol=0)
    assert registry.launch_counts() == {n: 0 for n in registry.names()}


@pytest.mark.parametrize("name", OPS)
def test_kernel_wrapper_refuses_cpu_tensors(name):
    """The CUDA wrapper never falls back: given CPU tensors it raises."""
    op = registry.get(name)
    s = op.sample(np.random.default_rng(11))
    with pytest.raises(ValueError, match="unsupported"):
        op.kernel(*map(_t, s.args), **s.common)
    assert op.kernel.launches == 0


def test_mixed_devices_raise():
    s = registry.get("paged_decode_attention").sample(np.random.default_rng(12))
    args = list(map(_t, s.args))
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError, match="devices"):
        registry.dispatch("paged_decode_attention", tuple(args))


def test_supports_gates():
    """What the CUDA kernels take: the main path's shapes in bf16 and
    float32; not a sliding window, an odd head dim, mismatched dtypes or
    operands on two devices."""
    f = torch.float32
    q = torch.zeros(8, 256, 32, 128, dtype=torch.bfloat16).transpose(1, 2)
    k = torch.zeros(8, 256, 8, 128, dtype=torch.bfloat16).transpose(1, 2)
    assert flash_ops._supports(q, k, k)
    assert not flash_ops._supports(q, k, k, window=16)
    assert not flash_ops._supports(q.float(), k, k)
    assert not flash_ops._supports(torch.zeros(1, 4, 8, 48), torch.zeros(1, 2, 8, 48),
                                   torch.zeros(1, 2, 8, 48))
    pq = torch.zeros(8, 32, 128, dtype=torch.bfloat16)
    pk = torch.zeros(257, 16, 8, 128, dtype=torch.bfloat16)
    tabs = torch.zeros(8, 32, dtype=torch.int32)
    lens = torch.zeros(8, dtype=torch.int32)
    assert paged_ops._supports(pq, pk, pk, tabs, lens)
    assert paged_ops._supports(pq.to(f), pk.to(f), pk.to(f), tabs, lens)
    assert not paged_ops._supports(pq, pk.to(f), pk, tabs, lens)
    assert not paged_ops._supports(pq[:, :30], pk[..., :7, :], pk[..., :7, :], tabs, lens)
    assert not paged_ops._supports(pq, pk, pk, tabs[:4], lens)
    # Operands on another device than q: the kernel would read host memory.
    assert not paged_ops._supports(pq, pk, pk, tabs.to("meta"), lens)
    assert not flash_ops._supports(q, k.to("meta"), k)
    # Dense decode: both main-path shapes, any T; not a strided cache, a
    # group above 16, a head dim above 256 or float lengths.
    dk = torch.zeros(8, 512, 8, 128, dtype=torch.bfloat16)
    assert decode_ops._supports(pq, dk, dk, lens)
    assert decode_ops._supports(pq[:1], dk[:1], dk[:1], lens[:1])
    assert decode_ops._supports(pq.to(f), dk[:, :77].to(f), dk[:, :77].to(f), lens)
    strided = dk.transpose(1, 2).contiguous().transpose(1, 2)
    assert not decode_ops._supports(pq, strided, strided, lens)
    assert not decode_ops._supports(torch.zeros(8, 32, 128), torch.zeros(8, 9, 1, 128),
                                    torch.zeros(8, 9, 1, 128), lens)
    assert not decode_ops._supports(torch.zeros(8, 8, 512), torch.zeros(8, 9, 2, 512),
                                    torch.zeros(8, 9, 2, 512), lens)
    assert not decode_ops._supports(pq, dk, dk, lens.float())
    assert not decode_ops._supports(pq, dk, dk, lens.to("meta"))
