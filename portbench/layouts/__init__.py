"""A configuration's own served tree and FLOP count, found by its name.

``layouts/<config>.py`` (the configuration's name with ``-`` and ``.`` as
``_``, as ``reference/<config>.py`` is named) may define either or both:

* ``make_params(model, seed, device, qk_scale)``: the served tree of the
  configuration file's ``model``, drawn on ``device`` from ``seed``;
  ``qk_scale`` is the file's ``init.qk_scale`` (1 where it has none);
* ``ModelFlops(cfg)``: the FLOPs of useful work of the configuration file
  ``cfg``, with ``prefill(prompt_len)`` and ``decode(positions)`` as
  :class:`portbench.flops.ModelFlops` has them.

What a layout file leaves out, :func:`portbench.weights.make_params` and
:class:`portbench.flops.ModelFlops` serve: standard attention (``wq``,
``wk``, ``wv``, ``wo``; QKV biases where the model has them) and a SwiGLU
FFN or DeepSeekMoE layer per block.  deepseek-moe-16b and chatglm3-6b have
no layout file.

The tree a layout draws is read three times:

* the program reads it: it is handed as it is to the port's engine
  (``repro_torch``), so it holds every leaf, in the keys, stacking (one
  leading layer axis per stack) and dtypes that the port's decoder reads
  for this configuration;
* the reference reads it, once the window has closed:
  ``reference/<config>.py`` takes the same tree through
  :class:`portbench.reference.common.Weights` (``leaf`` for norms, biases
  and float32 leaves, ``mat`` for every matrix, ``embed`` for the table)
  and works out whatever the program derives from it again;
* the control (``correctness.py`` with ``common.fp8_round``) rounds what
  the reference reads through ``mat`` and ``embed``: so that it sees every
  bf16 matrix of the tree, a reference reads each one through ``mat``.

Draw the tree in few large calls on the device, in the dtype it is served
in, from one ``torch.Generator`` seeded with ``seed``; every leaf that the
equations read has to carry weight in the comparison.
"""
from __future__ import annotations

__all__ = ["layout", "make_params", "model_flops"]


def layout(run):
    """The module ``layouts/<config>.py`` under the run's root, or
    ``None`` where the configuration has none."""
    from portbench.harness import load_module
    stem = run.cell["config"].replace("-", "_").replace(".", "_")
    path = run.root / "layouts" / f"{stem}.py"
    return load_module(path, f"portbench_layout_{stem}") if path.exists() else None


def make_params(run) -> dict:
    """The run's served tree: its configuration's own ``make_params``,
    else :func:`portbench.weights.make_params`."""
    from portbench import weights
    draw = getattr(layout(run), "make_params", weights.make_params)
    return draw(run.model, run.seed, run.device, run.config.get("init", {}).get("qk_scale", 1.0))


def model_flops(run):
    """The run's FLOP counts: its configuration's own ``ModelFlops``,
    else :class:`portbench.flops.ModelFlops`."""
    from portbench import flops
    return getattr(layout(run), "ModelFlops", flops.ModelFlops)(run.config)
