"""The port's checkpoint manager and training launcher on the CPU.

Twins of the first five tests of ``tests/test_checkpoint.py`` (round
trip, async save/restore, retention and ``LATEST``, no partial checkpoint
visible, an exact restart of reduced olmo-1b at rtol 1e-6); the on-disk
layout across the packages (a tree written by the JAX
``CheckpointManager`` restores in the port, and one the port writes loads
through JAX's ``load_pytree``, bf16 parameters and int8 moments
included); the snapshot (an in-place step right after ``save()`` leaves
what is written unchanged); and the launcher (``--reduced --device cpu``):
4 steps with a checkpoint at 2, a resume to 6, bit for bit an
uninterrupted 6-step run.
"""
from __future__ import annotations

import dataclasses
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.checkpoint.manager import load_pytree as j_load_pytree
from repro.models.registry import get_arch as j_get_arch
from repro.train import optimizer as jopt
from repro.train.step import TrainStepConfig as JTSConfig
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.checkpoint.manager import CheckpointManager, load_pytree, save_pytree
from repro_torch.data.pipeline import SyntheticLMStream
from repro_torch.launch import train as train_launcher
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import get_arch
from repro_torch.train.optimizer import AdamWConfig, QuantizedTensor
from repro_torch.train.step import TrainStepConfig, make_train_step


def tree():
    return {
        "layers": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)},
        "step_scalar": torch.tensor(3.5, dtype=torch.float32),
        "embed": {"table": torch.ones((16, 8), dtype=torch.bfloat16)},
    }


def _leaves(t):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _leaves(t[k])
    elif isinstance(t, QuantizedTensor):
        yield t.q
        yield t.scale
    else:
        yield t


def _assert_trees_equal(a, b):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_pytree_roundtrip(tmp_path):
    t = tree()
    save_pytree(t, tmp_path / "x")
    r = load_pytree(tmp_path / "x", tree())
    _assert_trees_equal(r, t)
    assert r["embed"]["table"].dtype == torch.bfloat16


def test_save_restore_async(tmp_path):
    with CheckpointManager(tmp_path, keep_last=2) as mgr:
        params = tree()
        state = {"opt": torch.zeros((4,))}
        mgr.save(3, params, state)
        mgr.wait()
        assert mgr.latest_step() == 3
        p2, s2 = mgr.restore(3, params, state)
        assert torch.equal(p2["layers"]["w"], params["layers"]["w"])
        assert torch.equal(s2["opt"], state["opt"])
        assert [w["step"] for w in mgr.writes] == [3] and mgr.writes[0]["bytes"] > 0


def test_retention_and_latest(tmp_path):
    with CheckpointManager(tmp_path, keep_last=2) as mgr:
        for s in (1, 2, 3, 4):
            mgr.save(s, {"w": torch.full((2,), float(s))}, blocking=True)
        assert mgr.latest_step() == 4
        kept = sorted(p.name for p in Path(tmp_path).glob("step_*"))
        assert len(kept) == 2 and kept[-1].endswith("0004")


def test_no_partial_checkpoint_visible(tmp_path):
    """Atomicity: while a write is in flight, LATEST still points at the
    previous complete checkpoint."""
    mgr = CheckpointManager(tmp_path, keep_last=3)
    mgr.save(1, {"w": torch.zeros((2,))}, blocking=True)
    mgr.save(2, {"w": torch.zeros((512, 512))})  # async
    assert mgr.latest_step() in (1, 2)  # never a corrupt intermediate
    mgr.wait()
    assert mgr.latest_step() == 2
    mgr.close()


def _olmo():
    arch = get_arch("olmo-1b")
    return dataclasses.replace(arch, cfg=arch.cfg.reduced())


def test_restart_resumes_training(tmp_path):
    """Train → checkpoint → 'crash' → restore → identical continuation."""
    arch = _olmo()
    stream = SyntheticLMStream(arch.cfg.vocab_size, 16, 4)
    init_state, step = make_train_step(arch, AdamWConfig(lr=1e-3), TrainStepConfig(donate=False))
    params = arch.init(seed=0, device="cpu")
    state = init_state(params)
    mgr = CheckpointManager(tmp_path)
    for i in range(5):
        params, state, _ = step(params, state, stream.batch_at(i))
        if i == 2:
            mgr.save(3, params, state, blocking=True)
    final_direct = params
    p2, s2 = mgr.restore(3, params, state)
    for i in range(3, 5):
        p2, s2, _ = step(p2, s2, stream.batch_at(i))
    for a, b in zip(_leaves(final_direct), _leaves(p2)):
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-6, atol=1e-6)
    mgr.close()


# --------------------------------------------------------- across packages

def _bf16_pair():
    """Reduced olmo-1b with bf16 parameters in both packages: the JAX
    parameters and int8 AdamW state, and the port's from the same numbers."""
    ja = j_get_arch("olmo-1b")
    ja = dataclasses.replace(ja, cfg=dataclasses.replace(ja.cfg.reduced(),
                                                         param_dtype="bfloat16"))
    ta = get_arch("olmo-1b")
    ta = dataclasses.replace(ta, cfg=dataclasses.replace(ta.cfg.reduced(),
                                                         param_dtype="bfloat16"))
    jp = ja.init(jax.random.PRNGKey(0))
    jinit, jstep = j_make_train_step(ja, jopt.AdamWConfig(lr=1e-3, moments_dtype="int8"),
                                     JTSConfig(donate=False))
    tinit, _ = make_train_step(ta, AdamWConfig(lr=1e-3, moments_dtype="int8"))
    batch = {k: jnp.asarray(v) for k, v in
             SyntheticLMStream(ja.cfg.vocab_size, 16, 4).batch_at(0).items()}
    jp, js, _ = jstep(jp, jinit(jp), batch)  # nonzero moments
    return ja, ta, jp, js, tinit


def _np32(x):
    return np.asarray(x, dtype=np.float32)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    """Parameters (bf16) and int8 AdamW state written by the JAX manager
    restore in the port equal to ``params_from_numpy`` of the same tree,
    the moments' blocks and scales bit for bit."""
    ja, ta, jp, js, tinit = _bf16_pair()
    with JManager(tmp_path) as jm:
        jm.save(1, jp, js, blocking=True)
    like_p = ta.init(seed=1, device="cpu")
    with CheckpointManager(tmp_path) as mgr:
        step, p, s = mgr.restore_latest(like_p, tinit(like_p))
    assert step == 1
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), ta.cfg, device="cpu")
    _assert_trees_equal(p, want)
    assert p["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert int(s["opt"]["step"]) == int(js["opt"]["step"]) == 1
    got = dict(manager_mod._flatten_with_paths(s))
    want_s = _jax_flat(js)
    assert got.keys() == want_s.keys()
    for key, leaf in got.items():
        assert np.array_equal(leaf.numpy(), want_s[key]), key
    assert any(leaf.dtype == torch.int8 for leaf in got.values())


def _jax_flat(tree) -> dict:
    """{"a/b/c": numpy leaf} of a JAX tree, keyed as the reference's
    checkpoint keys its files."""
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(leaf) for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_port_checkpoint_loads_through_jax(tmp_path):
    """What the port writes, JAX's ``load_pytree`` reads in the reference's
    structure: bf16 parameters and the int8 state, value for value."""
    ja, ta, jp, js, tinit = _bf16_pair()
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), ta.cfg, device="cpu")
    ts = tinit(tp)
    with CheckpointManager(tmp_path) as mgr:
        mgr.save(2, tp, ts)
    d = Path(tmp_path) / "step_0000000002"
    got_p = j_load_pytree(d / "params", jp)
    got_s = j_load_pytree(d / "state", js)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got_p)[0],
                            jax.tree_util.tree_leaves(jp)):
        assert a.dtype == b.dtype and np.array_equal(_np32(a), _np32(b)), path
    flat_t, want_t = _jax_flat(got_s), dict(manager_mod._flatten_with_paths(ts))
    assert flat_t.keys() == want_t.keys()
    for key, leaf in flat_t.items():
        assert np.array_equal(leaf, want_t[key].numpy()), key


# --------------------------------------------------------------- snapshot

def test_in_place_step_after_save_leaves_the_checkpoint_unchanged(tmp_path, monkeypatch):
    """``save()`` copies: a donating train step (parameters and moments
    written in place) run right after it, while the write waits, changes
    nothing of what the runtime's thread then writes."""
    arch = _olmo()
    init_state, step = make_train_step(arch, AdamWConfig(lr=1e-3), TrainStepConfig(donate=True))
    stream = SyntheticLMStream(arch.cfg.vocab_size, 16, 4)
    params = arch.init(seed=0, device="cpu")
    state = init_state(params)
    params, state, _ = step(params, state, stream.batch_at(0))
    before_p = [t.clone() for t in _leaves(params)]
    before_s = [t.clone() for t in _leaves(state)]
    stepped, real = threading.Event(), manager_mod.save_pytree

    def held(tree_, directory):
        assert stepped.wait(timeout=60)
        return real(tree_, directory)

    monkeypatch.setattr(manager_mod, "save_pytree", held)
    with CheckpointManager(tmp_path) as mgr:
        mgr.save(1, params, state)
        new_p, new_s, _ = step(params, state, stream.batch_at(1))
        assert new_p is params  # written in place
        assert not all(torch.equal(a, b) for a, b in zip(_leaves(params), before_p))
        stepped.set()
        mgr.wait()
        like = arch.init(seed=1, device="cpu")
        p, s = mgr.restore(1, like, init_state(like))
    for a, b in zip(_leaves(p), before_p):
        assert torch.equal(a, b)
    for a, b in zip(_leaves(s), before_s):
        assert torch.equal(a, b)


# --------------------------------------------------------------- launcher

@pytest.mark.parametrize("name, moments", [("olmo-1b", "float32"), ("mamba2-1.3b", "int8")])
def test_launcher_resume_equals_uninterrupted_run(tmp_path, capsys, name, moments):
    """``--steps 4 --ckpt-every 2``, then ``--steps 6`` from the same
    directory (restores step 4 and takes 2 steps): losses and parameters
    equal, bit for bit, one run of 6 steps without checkpoints."""
    common = ["--arch", name, "--reduced", "--device", "cpu", "--batch", "4", "--seq", "16",
              "--moments", moments, "--log-every", "1"]
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = train_launcher.main(common + ckpt + ["--steps", "4"])
    second = train_launcher.main(common + ckpt + ["--steps", "6"])
    whole = train_launcher.main(common + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "restored checkpoint at step 4" in out and "save() blocked the loop" in out
    assert "on the runtime's thread" in out
    assert (first["start"], second["start"], whole["start"]) == (0, 4, 0)
    assert [s for s, _ in first["saves"]] == [2, 4] and [w["step"] for w in first["writes"]] == [2, 4]
    assert first["losses"] + second["losses"] == whole["losses"]
    _assert_trees_equal(second["params"], whole["params"])
    _assert_trees_equal(second["state"], whole["state"])
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_0000000002", "step_0000000004", "step_0000000006"]
