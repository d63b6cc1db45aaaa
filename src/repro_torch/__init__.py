"""PyTorch/CUDA port of :mod:`repro`, laid out module for module like it.

The port runs the serving main path on an NVIDIA Hopper card:
``serving.scheduler.ContinuousBatchingScheduler`` drives
``serving.paged_kv.PagedInferenceEngine``, whose prefill attention runs the
hand-written ``flash_attention`` CUDA kernel and whose decode tick runs the
hand-written ``paged_decode_attention`` CUDA kernel (``csrc/``).

It imports ``torch`` and ``numpy`` only — never ``jax`` and nothing from
``repro``; the pure-Python modules it shares with ``repro`` (scheduler,
strategies, lane policy, ...) are copies.  Entry points take a ``device``
that defaults to ``"cuda"`` and raise :class:`RuntimeError` when CUDA is
absent, unless the caller passes ``device="cpu"`` explicitly (the tests
do).  On a CPU tensor every kernel op runs its plain PyTorch version; on a
CUDA tensor it launches its kernel or raises.
"""
