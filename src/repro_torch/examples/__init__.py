"""The JAX package's four examples (``examples/*.py``) as the port's entry
points, each under the reference file's name:

* ``serve_continuous_batching`` — the admission strategies, mixed-template
  lanes, speculative prefill with ``kv_shares``, and the depth-k pipeline
  with chunked prefill and a host KV spill pool;
* ``train_checkpoint_restart`` — asynchronous checkpoints, a preemption
  and an exact restart;
* ``device_fission`` — Rule A on a scanned loop: equivalence, the loop's
  structure before and after, and the gradient through it;
* ``quickstart`` — the HIR transformation and the asynchronous runtime.

Run one as ``python -m repro_torch.examples.<name>``; it runs on the card
unless given ``--device cpu``.  Importing a module runs nothing.
"""
from __future__ import annotations

import argparse

__all__ = ["device_from_argv"]


def device_from_argv(doc: str, argv=None) -> str:
    """The ``--device`` of an example's command line (default ``cuda``)."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv).device
