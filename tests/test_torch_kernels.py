"""The port's kernel ops on the CPU: plain PyTorch versions against the JAX
package's jnp references and Pallas kernels (interpret mode), plus the
device-keyed dispatch policy.

Inputs are drawn with numpy and handed to both packages.  Tolerances:
float32 plain versions against float32 jnp/Pallas, 2e-5 absolute and
relative, because the two sides sum the softmax and the PV product in
another order (observed differences are about 1e-6).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import registry as jreg
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.kernels.paged_attention.ref import paged_decode_ref as j_paged_ref
from repro_torch.kernels import registry
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ref import paged_decode_ref

TOL = dict(rtol=2e-5, atol=2e-5)


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


# ---------------------------------------------------------------- dispatch

def test_registry_names_and_samples():
    assert registry.names() == ["flash_attention", "paged_decode_attention"]
    for name in registry.names():
        op = registry.get(name)
        assert isinstance(op.kernel.launches, int)
    with pytest.raises(KeyError, match="registered"):
        registry.get("decode_attention")


@pytest.mark.parametrize("name", ["flash_attention", "paged_decode_attention"])
def test_cpu_operands_take_the_plain_version(name):
    """A CPU tensor runs the plain version and never counts a launch."""
    op = registry.get(name)
    s = op.sample(np.random.default_rng(10))
    args = tuple(map(_t, s.args))
    registry.reset_launches()
    out = registry.dispatch(name, args, common=s.common)
    torch.testing.assert_close(out, op.ref(*args, **s.common), rtol=0, atol=0)
    assert registry.launch_counts() == {n: 0 for n in registry.names()}


@pytest.mark.parametrize("name", ["flash_attention", "paged_decode_attention"])
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
