"""The port's Mamba-2 path on the CPU against the JAX package.

The ``ssd_scan`` op's plain version, the SSD core (``ssd_chunked``,
``ssd_reference``), the mixer (``ssm_forward``, ``ssm_decode_step``),
reduced mamba2-1.3b (2 layers, d_model 64, 4 heads x 8, state 8, chunk 8,
vocab 256, float32) through ``prefill`` and ``decode_step``, the tied
head, and the weight converter.  Inputs are drawn with numpy from a seed
and handed to both packages; the model's weights are drawn once by the
JAX package and carried across with ``params_from_numpy``.

Tolerances:
* the scan in float32, 1e-6 relative and absolute: both sides do the same
  multiply and add in float32 per chunk (observed differences are 0 or one
  ulp);
* the scan with bf16 states, ``prev`` rounded to bf16 against the Pallas
  kernel's bf16 ``prev``: 2^-7 relative, one bf16 ulp (the two float32
  carries may differ in their last bit, and a value next to a rounding
  boundary then rounds the other way); the port's plain version keeps
  ``prev`` in float32, as the jnp reference does;
* the SSD core, the mixer and the model's logits and caches, 1e-4
  absolute and relative: the einsums and the chunked exponentials sum in
  another order in the two frameworks (observed about 1e-6 on O(1)
  values), and ``F.softplus`` returns x above 20 where ``jax.nn.softplus``
  is ``logaddexp(x, 0)``, a difference below 2e-9.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import registry as jreg
from repro.kernels.ssd_scan.kernel import ssd_scan as j_ssd_scan_kernel
from repro.kernels.ssd_scan.ref import ssd_scan_ref as j_ssd_scan_ref
from repro.models import ssm as j_ssm
from repro.models import transformer as j_tf
from repro.models.registry import get_arch as j_get_arch
from repro_torch.kernels import registry
from repro_torch.kernels.ssd_scan.ops import ssd_scan_op
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as t_tf
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import get_arch

TOL = dict(rtol=1e-4, atol=1e-4)
SCAN_TOL = dict(rtol=1e-6, atol=1e-6)
BF16_ULP = 2.0 ** -7


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return np.asarray(x, dtype=np.float32)


@pytest.fixture(scope="module")
def setup():
    jarch = j_get_arch("mamba2-1.3b")
    jarch = dataclasses.replace(jarch, cfg=jarch.cfg.reduced())
    jparams = jarch.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    arch = get_arch("mamba2-1.3b")
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    return jarch, jparams, arch, params_from_numpy(tree, arch.cfg, device="cpu")


def _layer(tree, i):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


# ------------------------------------------------------------------ config

@pytest.mark.parametrize("reduce", [False, True])
def test_mamba2_config_matches_reference(reduce):
    ref = j_get_arch("mamba2-1.3b").cfg
    port = get_arch("mamba2-1.3b").cfg
    if reduce:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_init_params_keys_shapes_and_dtypes_match_reference():
    """A bf16 config's SSM block holds ``ln1`` and ``ssm`` only, no
    ``lm_head`` (tied), and keeps ``A_log``/``D``/``dt_bias`` in float32,
    as the reference's ``init_params``."""
    jcfg = dataclasses.replace(j_get_arch("mamba2-1.3b").cfg.reduced(),
                               param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = dataclasses.replace(get_arch("mamba2-1.3b").cfg.reduced(),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    want = jax.tree_util.tree_map(lambda a: (tuple(a.shape), np.dtype(a.dtype).name),
                                  j_tf.init_params(jcfg, jax.random.PRNGKey(0)))
    mine = t_tf.init_params(cfg, seed=0, device="cpu")
    got = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                                 mine, is_leaf=torch.is_tensor)
    assert got == want
    assert "lm_head" not in mine and set(mine["layers"]) == {"ln1", "ssm"}


# ---------------------------------------------------------------- ssd_scan

SWEEP = [(2, 8, 4, 16, 32), (1, 16, 2, 8, 8), (3, 4, 5, 32, 16), (1, 32, 1, 64, 64)]


def _scan_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    b, c, h, _p, _n = shape
    states = rng.standard_normal(shape, dtype=np.float32)
    decay = (1.0 / (1.0 + np.exp(-rng.standard_normal((b, c, h))))).astype(np.float32)
    return states, decay


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SWEEP)
def test_ssd_scan_plain_matches_jnp_ref_and_pallas(shape, dtype):
    """The reference's sweep shapes (``tests/test_kernels.py``): the plain
    version equals the jnp ref (float32 ``prev`` and ``final``) and the
    Pallas kernel under interpret (``prev`` in the states' dtype)."""
    states, decay = _scan_inputs(shape, SWEEP.index(shape))
    tstates = _t(states).to(getattr(torch, dtype))
    prev, final = ssd_scan_ref(tstates, _t(decay))
    assert prev.dtype == torch.float32 and final.dtype == torch.float32
    assert tuple(final.shape) == shape[:1] + shape[2:]
    jstates = jnp.asarray(tstates.float().numpy()).astype(getattr(jnp, dtype))
    rprev, rfin = j_ssd_scan_ref(jstates, jnp.asarray(decay))
    np.testing.assert_allclose(prev.numpy(), _np(rprev), **SCAN_TOL)
    np.testing.assert_allclose(final.numpy(), _np(rfin), **SCAN_TOL)
    kprev, kfin = j_ssd_scan_kernel(jstates, jnp.asarray(decay), interpret=True)
    np.testing.assert_allclose(final.numpy(), _np(kfin), **SCAN_TOL)
    if dtype == "float32":
        np.testing.assert_allclose(prev.numpy(), _np(kprev), **SCAN_TOL)
    else:
        np.testing.assert_allclose(prev.to(torch.bfloat16).float().numpy(), _np(kprev),
                                   rtol=BF16_ULP, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_ssd_scan_sample_through_the_op(seed):
    """The op's registered sample (the reference's ``_sample`` shapes)
    through ``ssd_scan_op`` on CPU tensors: the plain version, equal to
    the jnp ref and the Pallas kernel; no kernel launch."""
    s = registry.get("ssd_scan").sample(np.random.default_rng(seed))
    assert s.args[0].shape == (2, 8, 4, 16, 32) and s.args[1].shape == (2, 8, 4)
    registry.reset_launches()
    prev, final = ssd_scan_op(*map(_t, s.args))
    assert registry.launch_counts()["ssd_scan"] == 0
    jargs = tuple(jnp.asarray(a) for a in s.args)
    rprev, rfin = j_ssd_scan_ref(*jargs)
    kprev, kfin = jreg.get("ssd_scan").kernel(*jargs, interpret=True)
    for got, want in ((prev, rprev), (final, rfin), (prev, kprev), (final, kfin)):
        np.testing.assert_allclose(got.numpy(), _np(want), **SCAN_TOL)


def test_ssd_scan_supports_gates():
    """What the CUDA kernel takes: 5-D float32 or bf16 states, (B, C, H)
    float32 decay on the same device, both contiguous, and no initial
    state (the Pallas kernel starts every scan from zero)."""
    from repro_torch.kernels.ssd_scan.ops import _supports

    states = torch.zeros(8, 8, 64, 64, 128)
    decay = torch.zeros(8, 8, 64)
    assert _supports(states, decay)
    assert _supports(states.bfloat16(), decay)
    assert _supports(states[:, :1].contiguous(), decay[:, :1].contiguous())
    assert not _supports(states, decay, torch.zeros(8, 64, 64, 128))
    assert not _supports(states.half(), decay)
    assert not _supports(states, decay.bfloat16())
    assert not _supports(states, decay[:, :4])
    assert not _supports(states[..., 0], decay)
    assert not _supports(states.transpose(3, 4), decay)
    assert not _supports(states, decay.to("meta"))


def test_ssd_scan_initial_state_on_the_cpu():
    """The plain version takes an ``initial_state`` as the jnp ref does."""
    states, decay = _scan_inputs((2, 5, 3, 4, 8), 7)
    init = np.random.default_rng(8).standard_normal((2, 3, 4, 8), dtype=np.float32)
    prev, final = ssd_scan_op(_t(states), _t(decay), _t(init))
    rprev, rfin = j_ssd_scan_ref(jnp.asarray(states), jnp.asarray(decay), jnp.asarray(init))
    np.testing.assert_allclose(prev.numpy(), _np(rprev), **SCAN_TOL)
    np.testing.assert_allclose(final.numpy(), _np(rfin), **SCAN_TOL)
    np.testing.assert_array_equal(prev[:, 0].numpy(), init)


# ------------------------------------------------------------- SSD core

def _ssd_inputs(b, l, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p), dtype=np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = -np.linspace(1.0, 16.0, h).astype(np.float32)
    B = rng.standard_normal((b, l, n), dtype=np.float32)
    C = rng.standard_normal((b, l, n), dtype=np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("l", [5, 16, 21, 1])
def test_ssd_chunked_matches_reference(l):
    """chunk 8: l < chunk (one chunk of l), a multiple of chunk (two), a
    ragged l (three, the tail padded with dt = 0), and l = 1.  The port's
    ``ssd_chunked`` against the reference's and against both packages'
    sequential oracle ``ssd_reference``."""
    args = _ssd_inputs(2, l, 4, 8, 8, seed=l)
    y, final = t_ssm.ssd_chunked(*map(_t, args), chunk=8)
    jy, jfinal = j_ssm.ssd_chunked(*map(jnp.asarray, args), chunk=8)
    ry, rfinal = j_ssm.ssd_reference(*map(jnp.asarray, args))
    oy, ofinal = t_ssm.ssd_reference(*map(_t, args))
    assert tuple(y.shape) == (2, l, 4, 8) and y.dtype == torch.float32
    for got, want in ((y, jy), (final, jfinal), (y, ry), (final, rfinal),
                      (oy, ry), (ofinal, rfinal)):
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_ssd_chunked_reaches_the_scan_op_once_per_call(monkeypatch):
    """Every call reaches the ``ssd_scan`` op once, one chunk included (on
    the CPU it runs the plain version, counted here by a wrapper)."""
    calls = []
    real = t_ssm.ssd_scan_op

    def counted(*a):
        calls.append(a[0].shape[1])
        return real(*a)

    monkeypatch.setattr(t_ssm, "ssd_scan_op", counted)
    for l in (3, 8, 17):
        t_ssm.ssd_chunked(*map(_t, _ssd_inputs(1, l, 2, 4, 4, seed=l)), chunk=8)
    assert calls == [1, 1, 3]


# ----------------------------------------------------------------- mixer

@pytest.mark.parametrize("S", [2, 3, 13, 16])
def test_ssm_forward_with_state_matches_reference(setup, S):
    """Output, final state and conv tail of one layer's mixer, S below K-1
    (the tail left-padded with zeros), at K-1, ragged and a multiple of
    the chunk."""
    jarch, jparams, arch, tparams = setup
    x = np.random.default_rng(S).standard_normal((2, S, 64), dtype=np.float32)
    out, st = t_ssm.ssm_forward(_layer(tparams["layers"], 1)["ssm"], arch.cfg, _t(x),
                                return_state=True)
    jout, jst = j_ssm.ssm_forward(_layer(jparams["layers"], 1)["ssm"], jarch.cfg,
                                  jnp.asarray(x), return_state=True)
    np.testing.assert_allclose(out.numpy(), _np(jout), **TOL)
    for k in ("ssm", "conv"):
        assert tuple(st[k].shape) == jst[k].shape
        np.testing.assert_allclose(st[k].numpy(), _np(jst[k]), **TOL)
    if S < 3:
        assert not st["conv"][:, : 3 - S].any()
    plain = t_ssm.ssm_forward(_layer(tparams["layers"], 1)["ssm"], arch.cfg, _t(x))
    torch.testing.assert_close(plain, out, rtol=0, atol=0)


def test_ssm_decode_step_matches_reference(setup):
    """One-token recurrent update from a random state and conv window."""
    jarch, jparams, arch, tparams = setup
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 1, 64), dtype=np.float32)
    state = rng.standard_normal((3, 4, 8, 8), dtype=np.float32)
    conv = rng.standard_normal((3, 3, 48), dtype=np.float32)
    y, s, c = t_ssm.ssm_decode_step(_layer(tparams["layers"], 0)["ssm"], arch.cfg, _t(x),
                                    _t(state), _t(conv))
    jy, js, jc = j_ssm.ssm_decode_step(_layer(jparams["layers"], 0)["ssm"], jarch.cfg,
                                       jnp.asarray(x), jnp.asarray(state), jnp.asarray(conv))
    for got, want in ((y, jy), (s, js), (c, jc)):
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_decode_continues_prefill_exactly(setup):
    """Prefill of S tokens then one decode step gives the logits of a
    prefill of S + 1 tokens (state and conv tail carry the recurrence)."""
    _jarch, _jp, arch, tparams = setup
    toks = np.random.default_rng(12).integers(0, 256, size=(2, 11)).astype(np.int32)
    _lg, cache = t_tf.prefill(arch.cfg, tparams, _t(toks[:, :10]))
    step, _ = t_tf.decode_step(arch.cfg, tparams, _t(toks[:, 10]), cache,
                               torch.full((2,), 10, dtype=torch.int32))
    whole, _ = t_tf.prefill(arch.cfg, tparams, _t(toks))
    torch.testing.assert_close(step, whole, **TOL)


# ----------------------------------------------------------------- model

def test_reduced_mamba2_prefill_matches_reference(setup):
    """All-position logits and the ``{ssm, conv}`` cache, with ``max_len``
    (an SSM cache is not padded to it)."""
    jarch, jparams, arch, tparams = setup
    toks = np.random.default_rng(13).integers(0, 256, size=(3, 19)).astype(np.int32)
    logits, cache = t_tf.prefill(arch.cfg, tparams, _t(toks), max_len=48,
                                 return_all_logits=True)
    jlogits, jcache = j_tf.prefill(jarch.cfg, jparams, jnp.asarray(toks), max_len=48,
                                   return_all_logits=True)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (3, 19, 256)
    np.testing.assert_allclose(logits.numpy(), _np(jlogits), **TOL)
    assert set(cache["layers"]) == set(jcache["layers"]) == {"ssm", "conv"}
    for k, a in cache["layers"].items():
        assert tuple(a.shape) == jcache["layers"][k].shape
        np.testing.assert_allclose(a.numpy(), _np(jcache["layers"][k]), **TOL)
    last, _ = t_tf.prefill(arch.cfg, tparams, _t(toks))  # the head over one position
    torch.testing.assert_close(last, logits[:, -1], **TOL)


def test_reduced_mamba2_decode_step_matches_reference(setup):
    """Three decode steps over a random stacked state: logits and the
    cache, written in place."""
    jarch, jparams, arch, tparams = setup
    rng = np.random.default_rng(14)
    cache = {"layers": {"ssm": rng.standard_normal((2, 4, 4, 8, 8), dtype=np.float32),
                        "conv": rng.standard_normal((2, 4, 3, 48), dtype=np.float32)}}
    lengths = np.array([0, 3, 9, 47], np.int32)
    tcache = {"layers": {k: _t(a.copy()) for k, a in cache["layers"].items()}}
    jcache = jax.tree_util.tree_map(jnp.asarray, cache)
    for step in range(3):
        token = rng.integers(0, 256, size=4).astype(np.int32)
        logits, out = arch.decode_step(tparams, _t(token), tcache, _t(lengths + step))
        assert out is tcache
        jlogits, jcache = jarch.decode_step(jparams, jnp.asarray(token), jcache,
                                            jnp.asarray(lengths + step))
        np.testing.assert_allclose(logits.numpy(), _np(jlogits), **TOL)
    for k, a in tcache["layers"].items():
        np.testing.assert_allclose(a.numpy(), _np(jcache["layers"][k]), **TOL)


def test_init_cache_matches_reference(setup):
    jarch, _jp, arch, _tp = setup
    mine = arch.init_cache(3, 40, device="cpu")
    ref = jarch.init_cache(3, 40)
    assert {k: (tuple(a.shape), str(a.dtype)) for k, a in mine["layers"].items()} == {
        k: (a.shape, "torch." + str(a.dtype)) for k, a in ref["layers"].items()}
    assert not any(a.any() for a in mine["layers"].values())


def test_right_padded_prefill_state_matches_reference_padding_fault(setup):
    """Pins a fault of the reference that the port reproduces on purpose.

    ``repro.models.ssm.ssm_forward`` (``src/repro/models/ssm.py:199-241``)
    has no notion of prompt lengths: the final state runs over the pad
    tokens and the conv tail is taken from the last K-1 padded positions
    (``:221-226``), and ``InferenceEngine.prefill_dispatch`` right-pads
    every prompt to its bucket (``src/repro/serving/engine.py:540-545``).
    On a right-padded batch the port's final SSM state and conv tail equal
    the JAX package's, and both differ from the unpadded prompt's, while
    the logits at ``plen - 1`` agree with it."""
    jarch, jparams, arch, tparams = setup
    prompt = np.array([5, 7, 9, 11, 13], np.int32)
    padded = np.zeros((1, 8), np.int32)
    padded[0, :5] = prompt
    lg, cache = t_tf.prefill(arch.cfg, tparams, _t(padded), return_all_logits=True)
    jlg, jcache = j_tf.prefill(jarch.cfg, jparams, jnp.asarray(padded),
                               return_all_logits=True)
    for k in ("ssm", "conv"):
        np.testing.assert_allclose(cache["layers"][k].numpy(), _np(jcache["layers"][k]),
                                   **TOL)
    alone_lg, alone = t_tf.prefill(arch.cfg, tparams, _t(prompt[None]))
    torch.testing.assert_close(lg[:, 4], alone_lg, **TOL)
    for k in ("ssm", "conv"):
        assert float((cache["layers"][k] - alone["layers"][k]).abs().max()) > 1e-2


# ------------------------------------------------------------------ head

def test_tied_head_bf16_keeps_float32_accumulators():
    """A tied bf16 head is the float32 product of the bf16 activations and
    the bf16 embedding table, transposed, as the reference's ``_head``."""
    jcfg = dataclasses.replace(j_get_arch("mamba2-1.3b").cfg.reduced(),
                               param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = dataclasses.replace(get_arch("mamba2-1.3b").cfg.reduced(),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    rng = np.random.default_rng(15)
    x = _t(rng.standard_normal((2, 3, 64), dtype=np.float32)).bfloat16()
    table = _t(rng.standard_normal((256, 64), dtype=np.float32)).bfloat16()
    got = t_tf._head(cfg, {"embed": {"table": table}}, x)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 3, 256)
    jx, jt = (jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in (x, table))
    want = j_tf._head(jcfg, {"embed": {"table": jt}}, jx)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- converter

def test_converter_keeps_float32_ssm_leaves_at_bf16():
    """A bf16 reduced mamba2 drawn by the JAX package and carried across
    keeps ``A_log``, ``D`` and ``dt_bias`` in float32, bit-equal to the
    reference's; every other leaf is bf16 and equal to the reference's
    bf16 value."""
    jcfg = dataclasses.replace(j_get_arch("mamba2-1.3b").cfg.reduced(),
                               param_dtype="bfloat16", compute_dtype="bfloat16")
    cfg = dataclasses.replace(get_arch("mamba2-1.3b").cfg.reduced(),
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    jparams = j_tf.init_params(jcfg, jax.random.PRNGKey(3))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    mine = params_from_numpy(tree, cfg, device="cpu")
    ssm = mine["layers"]["ssm"]
    for k in ("A_log", "D", "dt_bias"):
        ref = tree["layers"]["ssm"][k]
        assert ref.dtype == np.float32 and ssm[k].dtype == torch.float32
        np.testing.assert_array_equal(ssm[k].numpy(), ref)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    for path, ref in leaves:
        node = mine
        for key in path:
            node = node[key.key]
        if ref.dtype != np.float32:
            assert node.dtype == torch.bfloat16
            np.testing.assert_array_equal(node.float().numpy(), ref.astype(np.float32))
