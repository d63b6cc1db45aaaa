#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each ending in ``torch.cuda.synchronize()``:

1. card — ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build — compile the five CUDA sources from ``src/repro_torch/csrc``
   (``ssd_scan.cu`` holds the scan and its adjoint, ``ssd_scan_bwd``)
   with ``nvcc`` (one process per source, in parallel) and time it; log
   ``ptxas``' registers and spills of the three attention kernels and the
   gather, and the SASS instruction mix of their main-path instances and
   of both paged bodies at G 16 (CUDA cores and tensor cores);
3. kernels — each kernel against its plain PyTorch version on the card, at
   the main path's shapes in bf16 and at a small ragged float32 shape (the
   ``ssd_scan`` kernel: mamba2-1.3b's prefill shape in float32 and the
   reference's sweep shapes in float32 and bf16; ``batched_gather``: the
   llama3-8b table and one training step's 4096 ids, N = 1, 16 steps'
   65536 ids and ragged shapes, bit for bit, timed against
   ``index_select`` at 4096 and 65536; ``flash_attention`` at the serving
   shape and the trainer's, both instances at ragged shapes, bf16 at D 16
   to 128; ``decode_attention`` at the dense engine's 8 lanes and the
   chunk side's 1; ``paged_decode_attention`` beside ``decode_attention``
   on the same keys gathered dense, and the host time of one call of each;
   the three attention kernels again at the head layouts of phases 4l-4o,
   Hq/Hkv 16/16, 20/20 and 32/2 at D 128, as logged sub-rows (both decode
   kernels at 8 lanes and at 1), the paged kernel's two instances side by
   side at G 16 (8 lanes, 1, and the long-document cell's 32 lanes over
   512-page tables) and at G 8; and at the layouts of phases 4p-4r, as
   sub-rows that the JSON line carries: the banded flash of hymba's
   prefill, B 8, S 2048, 25/5, D 64, W 1024, against SDPA with a boolean
   band mask, the band's edges W = S (the causal bits) and W = 1 (each
   query's own value row) and ragged bands on both instances, unmasked
   flash at seamless's encoder (S = T = 512) and cross attention (S 64, T
   512), decode at groups 5 (T 1024), 6 (D 128) and 1 (self and cross),
   paged decode at 12/2 and ``ssd_scan`` at hymba's H 25, N 16); the
   ``ssd_scan_bwd`` kernel (the scan's adjoint, a training step's
   backward) at mamba2's and hymba's training shapes and ragged ones in
   float32 and bf16, against its plain version and autograd of the plain
   scan, three calls bit for bit; each with the tolerance stated; a
   repeated call of any attention kernel must give the same bits; its
   time, the plain version's, one library call's as a yardstick where one
   exists (never called by the port) and the least time the card could
   take (``bound_ms``); rows 1 and 3b again inside one captured CUDA graph
   of 100 back-to-back launches, operands cold and in L2 (sub-rows 1j, 3j;
   3j's library time is row 3b's SDPA call in the same kind of graph);
4. serving paths — llama3-8b at full width (32 layers, bf16, weights
   drawn from seed 0 on the card) served through
   ``ContinuousBatchingScheduler``, 32 new tokens a request, three paths,
   each with every kernel launch count zeroed just before it and read
   just after, and held to exact counts (one launch per layer per
   dispatch or per token).  Every engine dispatch is a compiled step
   (``serving/graphs.py``): the tick, the chunk steps and a prefill step
   per (batch, prompt) bucket, each of which runs its first call for real
   and records a CUDA graph that every later call replays.  Each path
   also checks that every decode tick was one call of the tick step,
   every prefill dispatch one call of its bucket's prefill step and,
   where it feeds tokens through ``_extend``, every such token one call
   of a chunk step, and that each step ran once for real and replayed
   every call after (the first call's launches and the replays' count
   alike; the reduced runs of phase 7 and the app traces check the
   prefill calls too).  Paths a, b and d drive their engine twice (a new
   scheduler and the same prompts): fresh, then warmed:
   a. main — the synchronous path, ``PagedInferenceEngine``, 16 requests:
      ``paged_decode_attention`` = decode steps x 32, ``flash_attention``
      = prefill dispatches x 32;
   b. async — the paper's asynchronous path: ``overlap=True`` (prefills on
      the speculation thread and the engine's own stream),
      ``chunk_tokens=256`` and fused chunk ticks, 16 requests of which 3
      are longer than ``max_prompt_len``: ``decode_attention`` = tokens
      fed through the decode path x 32, and no speculation crash;
   c. dense — ``InferenceEngine`` with the main path's requests:
      ``decode_attention`` = decode steps x 32;
   d. prefix — ``prefix_share=True``, 16 prompts of one 192-token prefix
      and a tail of 8-40 tokens: later requests alias the 12 resident
      prefix pages and feed their tails through ``_shared_tail``
      (``decode_attention`` = tail tokens x 32); then the same traffic
      unshared, which must move more KV bytes;
   e. spill — 128 pages (half of full provisioning), a host spill pool,
      phase a's prompts with 160 new tokens each: lanes evicted under
      page pressure and restored, streams equal token for token to the
      same traffic at full provisioning;
   f. app-traces — the paper's transformation on the real engine: the
      three app traces of ``core/app_traces.py`` (49 queries) through
      the HIR → scheduler bridge, synchronous (one scheduler drive per
      query) against ``transform_program``'s output on
      ``AsyncQueryRuntime`` (one drive per cohort), each over a fresh
      ``PagedInferenceEngine(n_lanes=8, page_size=16)``: 49 synchronous
      drives, fewer transformed ones, exact attention launches;
   g. model-service — the ML instantiation: ``ModelService`` whose query
      gathers a row of the llama3-8b embedding table through
      ``batched_gather`` and scores it, 4096 ids, synchronous and
      transformed (with and without ``pad_batches``): equal totals,
      ``batched_gather`` = single queries + batches, each forward one
      replay of the service's compiled step for its shape; the three
      runs again under ``graphs.eager()``, totals equal within 1e-5;
   h. chaos — phase a's traffic on a paged engine with a spill pool, one
      request a prefill, fault-free and inside ``ChaosEngine`` (seeded
      decode and prefill faults) with ``Resilience``: faults of both
      kinds, quarantined lanes, spills = restores, streams equal 16/16;
   s. graphs — a, b and d on llama3-8b at full width cut to 2 of 32
      layers, two drives each, with graphs and under ``graphs.eager()``
      (every compiled step, the prefill steps included, run as plain ops
      on its static buffers, the counterpart of ``jax.disable_jit``):
      each drive's greedy tokens and exact launch counts equal to its
      twin's, walls and tokens/s printed, fresh and warmed apart; and a
      once eagerly at full depth beside a's first drive;
   then mamba2-1.3b at full width (48 layers, bf16, weights drawn from
   seed 0 on the card) through ``InferenceEngine(n_lanes=8,
   max_prompt_len=2048, max_len=2080)``:
   i. ssm — the synchronous path, 16 requests of 300-2000 tokens:
      ``ssd_scan`` = prefill dispatches x 48, no other kernel;
   j. ssm-async — ``overlap=True, chunk_tokens=1024``, 14 prompts of
      300-1000 tokens and 2 of 1056-1152 (their tails fed through the
      recurrent decode): ``ssd_scan`` = prefill dispatches x 48, no
      speculation crash;
   k. ssm-paged — the ``ssm`` traffic on ``PagedInferenceEngine``'s
      dense-compute mode with a spill pool and ``lane_timeout``: every
      lane spilled and restored whole, streams equal to phase i's;
   then, the llama3-8b and mamba2 weights freed, deepseek-moe-16b at full
   width (28 layers: one dense block, then 27 MoE blocks of 64 routed
   experts top-6 and 2 shared; bf16, router float32; weights from seed 0
   on the card; two KV stacks):
   l. moe — phase a's path and traffic on ``PagedInferenceEngine(n_lanes=
      8)``: ``paged_decode_attention`` = decode steps x 28,
      ``flash_attention`` = prefill dispatches x 28;
   m. moe-async — phase b's path and traffic: ``decode_attention`` =
      tokens fed x 28, no speculation crash;
   n. moe-dense — phase c's, on ``InferenceEngine``;
   o. configs — olmo-1b, qwen1.5-4b and chatglm3-6b at full width, one
      at a time, on phase a's path with 8 requests of 16 new tokens
      (exact launches by layer count); then the port's serving launcher,
      ``repro_torch.launch.serve.main(["--arch", "deepseek-moe-16b"])``;
   then the last three families at full width, bf16, weights from seed 0:
   p. hymba — hymba-1.5b (32 hybrid layers, window 1024) on
      ``InferenceEngine(n_lanes=8, max_prompt_len=2048, max_len=2112)``:
      8 prompts of 2048 tokens and 8 of 40-256, 32 new tokens each:
      ``flash_attention`` (banded) = ``ssd_scan`` = prefill dispatches x
      32, ``decode_attention`` (over the rings) = ticks x 32; the same
      traffic on the paged engine's dense-compute mode, streams equal
      token for token; one 600-token prompt under ``overlap=True,
      chunk_tokens=512`` (88 tokens through ``_extend``);
   q. vlm — qwen2-vl-2b (28 layers, M-RoPE) on phase a's path and
      traffic; then ``Arch.prefill`` of 8 stub sequences of 256 patch
      embeddings on a 16 x 16 grid and 32 text tokens (the flash kernel
      masking on the grid's positions) and 32 greedy decode steps on a
      dense cache: flash 28, ``decode_attention`` 28 a token;
   r. encdec — seamless-m4t-medium (12 + 12 layers) through
      ``Arch.prefill`` of 8 sources of 512 stub frames and 8-token
      targets, then 32 greedy tokens: flash 12 + 2 x 12, decode 2 x 12 a
      token;
5. checks — first prefill and first decode tick of the full-width
   llama3-8b, a prefix hit's ``_shared_tail`` logits against a flash
   prefill of the whole prompt, and the first full-width mamba2
   prefill, kernel path against the plain path on the same weights and
   batch; the same first prefill and tick for deepseek-moe-16b (with the
   share of (token, k) routes the two paths agree on) and each config of
   phase o; hymba's prefill of 8 x 2048 (band, rings, ``ssd_scan``) and
   a decode step from it, qwen2-vl's stub prefill and a step and its
   text path's prefill and paged tick, seamless-m4t's prefill and a
   step;
6. profile — ``torch.profiler`` over one full-width llama3-8b prefill
   dispatch (a replay of the 8 x 256 bucket's step, whose first dispatch
   with its parts, replayed and ``eager()`` walls and copy-out of the
   staging cache are also timed), the tick's first call, a few decode
   ticks (graph replays), one
   fused tick (a
   64-token prompt chunk folded into the decode: 64 chunk-step replays
   and a tick replay) and one ``_shared_tail`` beside a flash prefill of
   the same prompt, then one mamba2 prefill dispatch and a few of its
   decode ticks: host wall time, device busy time, the kernels that take
   the most of it, ``paged_decode_attention``'s device time in a decode
   tick, ``decode_attention``'s in the tail and ``ssd_scan``'s share of
   the prefill; each tick's, the fused tick's and the tail's wall also
   without the profiler, replayed and under ``graphs.eager()``; then
   deepseek-moe-16b's decode tick the same way, and one eager tick:
   wall, busy time, kernels, the MoE layers' device time and the routed
   expert weights' byte bound; and the device memory a llama3-8b paged
   engine takes while it is built, with a page pool of 0.6 of the free
   memory: the peak above what was allocated before, against the pool's
   own bytes (fails at 1.1 x the pool), then 4 ticks on it; then (6p) a
   llama3-8b paged engine that prefills one batch of every bucket it can
   pin (20, the largest first; each bucket's first dispatch with its
   parts — the real run, the recording, the instantiation — a replay and
   an ``eager()`` dispatch timed): the build's bytes, each graph
   pool's bytes (the tick's, the side chunk step's and the prefill
   steps') after the largest bucket and after all, gated on the prefill
   pool (at most 1.1 x), the memory allocated and the peak (64 MiB) not
   growing with the buckets, and one staging cache;
7. reduced check — the reduced llama3-8b in float32 served on the card
   with the kernels against the same model served on the CPU with the
   plain versions, on the synchronous paged path, the dense engine, the
   overlap + chunk paged path, prefix sharing and an oversubscribed pool
   with spill, and ``ChaosEngine`` over a paged engine with spill; the
   three app traces through the bridge (vocabulary raised to 65536) and
   the ``model-service`` program; the reduced mamba2 the same way on the
   dense engine, synchronous and overlap + chunk, and on the paged
   engine's dense-compute mode with spills; reduced deepseek-moe-16b,
   kimi-k2-1t-a32b, olmo-1b, qwen1.5-4b, chatglm3-6b and qwen2-vl-2b (QKV
   biases drawn nonzero) on the synchronous paged path, the dense engine,
   overlap + chunk, prefix sharing and an oversubscribed pool with spill,
   reduced hymba on the dense engine (synchronous and overlap + chunk)
   and the paged engine's dense-compute mode with spills, and the three
   new families' prefill and 24 greedy steps (logits within 1e-4, tokens
   equal)
   (per-request greedy streams and the engine's counters must be equal;
   synchronous = transformed);
8. train — the trainer at full width, after the serving phases: llama3-8b
   (bf16, depth cut to 4 of 32 layers, ``query_embedding=True``,
   ``remat=False``) through ``make_train_step(..., TrainStepConfig(
   microbatches=4, fission=True))``, 3 steps of 8 x 512 tokens from
   ``SyntheticLMStream`` through ``PrefetchLoader``, compiled (the first
   step runs, traces the fission plan and records the whole step as one
   CUDA graph; each later step replays it) and one more under the
   profiler, then the same under ``graphs.eager()`` with the fission
   plan traced again every step; then the same pair with
   ``fission=False`` from the same weights: ``batched_gather`` = 1
   launch per fissioned step and 4 per unfissioned step,
   ``flash_attention`` = 4 microbatches x 4 layers per step, one
   ``trace_body`` call in the compiled fissioned run and one a step in
   its twin, each compiled run against its twin (``_against_eager``: one
   replay a step from the second, equal launches, the first loss bit for
   bit, later losses, grad norms and every parameter leaf bit for bit
   where two ``eager()`` runs repeat each other and within 1e-4 where
   they do not), the first loss
   equal with and without fission; trace time, wall, tokens/s, loss,
   grad norm, replays and launches per step, peak allocated and reserved
   memory and the graph pool printed;
   b. train-ssm — the training launcher, ``repro_torch.launch.train``, at
      full width on mamba2-1.3b (48 layers, bf16, remat, int8 moments, 8 x
      2048 tokens): 4 steps with an asynchronous checkpoint every 2, then
      a second run to step 6 that restores step 4, its step compiled
      without donation (one graph over the step's own set, a copy in and
      out each step), and both runs' ``eager()`` twins; per-step launches
      exact (``ssd_scan`` 96, ``ssd_scan_bwd`` 48), ``_against_eager``, the
      checkpoint read back bit for bit; step walls beside the writes they
      overlapped, how long ``save()`` blocked against the write's time on
      the runtime's thread, bytes written, memory and the graph pool;
   c. train-hybrid — hymba-1.5b at full width cut to 16 of 32 layers
      (bf16, remat), 3 compiled steps of 8 x 2048 and one profiled, and
      their ``eager()`` twins: ``flash_attention`` (banded) 32,
      ``ssd_scan`` 32, ``ssd_scan_bwd`` 16 a step, ``_against_eager``,
      walls and memory;
9. train check — reduced llama3-8b in float32 trained 3 compiled steps on
   the card and on the CPU, fissioned and not: losses, parameters, launch
   counts and a replay a step; reduced mamba2, hymba, deepseek-moe-16b,
   qwen2-vl-2b and seamless-m4t the same way and against their
   ``eager()`` twins on the card (3 steps and a profiled one, exact
   launches); the restart on the card (reduced mamba2, int8 moments, an
   asynchronous checkpoint after step 2, restored into fresh tensors,
   which the same compiled step copies in: the first resumed loss bit
   for bit);
10. fission — the twin of ``benchmarks/bench_fission.py::device_fission``:
    2048 single-row queries on a 10000 x 256 float32 table, plain ``scan``
    (2048 launches) against ``fission_scan`` (1), both walls printed;
11. sharded — the distribution layer on four ranks that share the card
    (``torch.multiprocessing`` processes on ``cuda:0``, gloo, mesh (data,
    model) = (2, 2); each rank first runs once every collective the phase
    uses; the functional all-gather's CUDA kernel is c10d's, since gloo's
    functional all-gather of CUDA tensors never completes):
    a. sharded-train — llama3-8b at full width cut to 2 layers, parameters
       placed by ``param_shardings``, ``make_train_step(..., mesh=)`` on
       phase 8's 8 x 512 batch in one microbatch (microbatches multiply
       the FSDP gathers, fissioned or not), 2 steps, held to the same
       steps unsharded on the card
       (same seed and batches): both losses within 1e-3 relative, layer 0
       of ``wq`` after them within 0.25 of the distance the unsharded
       steps moved it; ``wq``'s local shard (2, 2048, 16, 128), per
       rank and step ``flash_attention`` = 2 and ``batched_gather`` = 1
       (the masked vocabulary-parallel gather); step
       walls, peak memory, and the second step's collectives by kind,
       count, bytes and mesh axis (``OpCost``) printed per rank;
    b. moe-ep — deepseek-moe-16b at full width cut to a dense and 3 MoE
       blocks, 32 of 64 experts a rank: the prefill of 8 x 256 tokens on
       the routes a single-device run of the same weights took, logits
       against that run's (phase 5's gate), one all-reduce over ``model``
       around each ``moe`` call, the MoE stacks' local ``w_gate``/``w_in``
       (3, 32, 1024, 1408); then one train step; ``flash_attention`` = 4
       for each;
    c. dryrun — ``launch.dryrun.run_cell`` of a's and e's configurations
       and mesh on a fake process group and fake card tensors, on the
       host: per-device flops within 1 % of the counted step and its
       collectives of each kind and mesh axis as many; then
       ``llama3-8b|train_4k|single`` on the production mesh, timed, its
       row printed;
    d. sharded-reduced — reduced llama3-8b (``query_embedding``) and
       deepseek-moe-16b in float32, 2 steps on the ranks against the
       unsharded CPU step: losses and parameters within 1e-4; the same
       llama3-8b at 4 microbatches, fissioned; reduced llama3-8b's decode
       (4 lanes, 16 rows, 6 steps) in both cache layouts of e's decode:
       logits and caches within 1e-4 of the CPU decode;
    e. sharded-fission — a's cut and batch in 2 microbatches, the loop
       fissioned (Rule A on each rank's traced program, the plan kept
       across steps), 2 steps, held to an unsharded fissioned twin at 2
       microbatches on the card as a is; per rank and step
       ``batched_gather`` = 1 and ``flash_attention`` = 4; ``trace_body``
       in the first step only, as much as a one-step run that traces
       afresh does, whose loss it equals bit for bit; its
       counted step equal to c's dry run in flops and collectives;
    f. sharded-decode — a's model at 2 of 32 layers (full width) decoding
       on the mesh: an unsharded twin on the card prefills 8 random
       256-token prompts into caches of 512
       rows and takes 8 greedy steps; each rank places the twin's caches
       as the dry run places a decode cell's, in the default layout
       (lanes over ``data``, replicated over ``model``) and under
       ``kv_seq_shard`` (rows over ``model``: the split-KV decode), and
       takes 8 steps on the twin's tokens: every step's logits within
       0.05 x max |logit| of the twin's, the new cache rows of layer 0
       within 1e-2 of their largest entry and of every layer within 0.05,
       ``decode_attention`` = 2 a step and ``batched_gather`` = 1, and
       the ``kv_seq_shard`` step 3 all-reduces over ``model`` a layer
       more than the default layout's and no more all-gathers over
       ``model`` (no cache gathered); step walls printed, never
       compared.

12. examples (run after phase 10, before phase 11) — the JAX package's
    examples through the port's twins (``repro_torch.examples``), at
    full width, weights from seed 0:
    a. depth — llama3-8b (32 layers, bf16) on ``PagedInferenceEngine``
       at ``spec_depth`` 1, 2 and 4 and on ``InferenceEngine`` at 2
       (``overlap=True``, ``chunk_tokens`` 256, ``PureAsync``), 48
       single-request bets over 6 templates, prompts of 128-256 tokens and
       three of 320-512 (chunked), 16-48 new tokens; each engine driven
       fresh and warmed, then depth 2 under ``graphs.eager()``: every
       stream equal to depth 1's request by request, no speculation
       crash, the ledger balanced, exact launches against the engine's
       counters, every dispatch a call of its compiled step and every
       call but a step's first a replay; tokens/s, TTFT, aborts and
       settle order printed, never compared;
    b. serving example — ``serve_continuous_batching``'s strategies,
       mixed-template lanes (each template's own bucket), overlap demo
       (``kv_shares`` from ``lane_weights``) and depth-2 demo (the
       oversized prompt chunked, every spilled lane restored) on
       llama3-8b at the example's lane sizes, exact launches;
    c. training example — ``train_checkpoint_restart.run`` on olmo-1b
       (16 layers, bf16, float32 moments): 6 steps, an asynchronous
       checkpoint every 2, ``on_preempt`` at 6, a restore into fresh
       tensors and 2 resumed steps, against the preempted state continued
       in memory: the first resumed loss bit for bit, the second within
       1e-5 relative; one compiled step copied into and replayed every
       call; ``save()``'s blocked seconds and each write's seconds and
       bytes printed;
    d. device fission — ``device_fission`` at the example's sizes and on
       the llama3-8b embedding table (128256 x 4096 bf16, 256 ids):
       ``batched_gather`` launched 256 times by the plain loop and once
       by the fissioned one, the same bits, the gradient's nonzero rows
       the ids.

Phase 3 also times the flash kernel at a rank's shard in phase 11a (B 1,
16 / 4 heads, S 512; the JSON line's sub-row 2g), the decode kernel with
its log-sum-exp at a rank's shard of 11f's ``kv_seq_shard`` cache (B 8,
32 / 8 heads, 256 of 512 rows; sub-row 3i) and the host time of one call
of ``decode_op``, the custom op the model calls, beside the launch it
wraps.

Any failure exits non-zero.  The last lines are the card's name and power
limit, the kernels' JSON line, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet: HBM3 rate, dense bf16 tensor-core peak and
# the float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12

# The configurations this script serves reduced in phase 7 beside llama3-8b
# and mamba2-1.3b.
NEW_CONFIGS = ("deepseek-moe-16b", "kimi-k2-1t-a32b", "olmo-1b", "qwen1.5-4b", "chatglm3-6b")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


# ----------------------------------------------------------------- phase 1
def phase_card():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[card] nvidia-smi: {smi}")
    log(f"[card] torch: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    # Float32 products in full float32 on the card (the plain versions'
    # einsums), so float32 comparisons are not TF32-limited.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi, name


# ----------------------------------------------------------------- phase 2
def phase_build():
    import torch
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    libs = build.build_all()
    dt = time.perf_counter() - t0
    for name, path in libs.items():
        log(f"[build] {name}: {path.relative_to(ROOT)}")
    log(f"[build] {len(libs)} kernels built in {dt:.3f} s (nvcc in parallel)")
    for name in _SASS_OF:
        _compiler_report(build, name, libs[name])
    torch.cuda.synchronize()


# The instances whose SASS phase 2 summarises: the main path's ones (bf16;
# the gather's slices copy of int32 ids, as the trainer's tokens come), and
# for the paged kernel at G 16 both bodies: the CUDA cores' (MAXG 16) and
# the tensor cores' (D up to 128).
_SASS_OF = {"flash_attention": ("flash_wgmma_kernelILi128ELb0EE",),
            "decode_attention": ("decode_cluster_kernelI13__nv_bfloat16Li4ELi8E",),
            "paged_decode_attention": ("paged_cluster_kernelI13__nv_bfloat16Li4ELi8E",
                                       "paged_cluster_kernelI13__nv_bfloat16Li16ELi8E",
                                       "paged_cluster_kernel_mmaILi128E"),
            "batched_gather": ("gather_slicesIiE",)}


def _compiler_report(build, name, lib):
    """Log ``ptxas``' registers and spills for every kernel in ``name``'s
    library, and the SASS instruction mix of the instances ``_SASS_OF``
    names."""
    import re
    kernel = None
    for line in build.ptxas_log(name).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(flash_wgmma_kernel|flash_kernel|decode_cluster_kernel|"
                          r"paged_cluster_kernel_mma|paged_cluster_kernel|gather_rows|"
                          r"gather_slices)(I\w*?)EEv",
                          m.group(1))
            kernel = k.group(1) + k.group(2) if k else m.group(1)
        elif "spill" in line or "registers" in line:
            log(f"[build] ptxas {name}: {kernel}: {line.split(':', 1)[-1].strip()}")
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    if not cuobjdump.exists():
        log(f"[build] SASS {name}: cuobjdump not found")
        return
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    for func in sass.split("Function : ")[1:]:
        head = func.split("\n", 1)[0]
        for inst in _SASS_OF[name]:
            if inst not in head:
                continue
            ops = re.findall(r"^\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                             func, flags=re.M)
            counts = sorted(((ops.count(o), o) for o in set(ops)), reverse=True)
            log(f"[build] SASS {name} {inst}: {len(ops)} instructions; HGMMA "
                f"{ops.count('HGMMA')}, HMMA {ops.count('HMMA')}, UTMALDG "
                f"{ops.count('UTMALDG')}; " + ", ".join(f"{o} {c}" for c, o in counts[:16]))


# ----------------------------------------------------------------- phase 3
class Timer:
    """Median device time of one call, from CUDA events around each call,
    with the 50 MB L2 flushed before each so the call finds its operands
    in device memory, as it does on the serving path.  A spin kernel of
    about 1 ms (``torch.cuda._sleep``) runs before each start event, so
    the device is still busy while the host issues the call: the events
    time the device work, not the host's enqueue latency."""

    SPIN_CYCLES = 2_000_000  # about 1 ms at the H100's 1.98 GHz boost clock

    def __init__(self):
        import torch
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 25) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        events = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in events]))


def _bound(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _repeat(name, fn, first) -> None:
    """A second call gives the same bits as the first (no atomics, fixed
    summation order)."""
    import torch
    again = fn()
    torch.cuda.synchronize()
    same = torch.equal(again, first)
    log(f"[kernels] {name}: a repeated call is bit-identical: {same}")
    if not same:
        fail(f"{name}: two calls on the same inputs differ")


def _compare(label, got, want, rtol, atol):
    import torch
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want.float(), rtol=rtol, atol=atol)
    log(f"[kernels] {label}: max_abs_err {err!r} (tolerance rtol {rtol}, atol {atol}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{label}: kernel disagrees with its plain version")
    return err


def _paged_case(gen, rng, b, hq, hkv, d, ps, np_, dtype):
    import torch
    n_pages = b * np_ + 1  # page 0 stays out of the tables
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((n_pages, ps, hkv, d), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((n_pages, ps, hkv, d), generator=gen, device="cuda").to(dtype)
    tables = rng.permutation(np.arange(1, n_pages)).reshape(b, np_).astype(np.int32)
    lengths = rng.integers(1, np_ * ps + 1, size=(b,)).astype(np.int32)
    if b > 1:
        lengths[0] = 0  # a lane with nothing to attend: zeros, never NaN
    return (q, kp, vp, torch.as_tensor(tables, device="cuda"),
            torch.as_tensor(lengths, device="cuda"))


def _flash_case(gen, b, hq, hkv, s, d, dtype):
    import torch
    # The model's layout: (B, S, H, D) buffers viewed as (B, H, S, D).
    q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, s, hkv, d), generator=gen, device="cuda").to(dtype)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _decode_case(gen, rng, b, hq, hkv, t, d, dtype):
    import torch
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b, t, hkv, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b, t, hkv, d), generator=gen, device="cuda").to(dtype)
    lengths = rng.integers(1, t + 1, size=(b,)).astype(np.int32)
    if b > 2:
        lengths[:3] = (0, 1, t)  # nothing to attend, one key, the whole cache
    return q, k, v, torch.as_tensor(lengths, device="cuda")


def phase_kernels(timer):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import decode_ref
    from repro_torch.kernels.flash_attention.ops import attention_op, flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention_cuda
    from repro_torch.kernels.paged_attention.ref import paged_decode_ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rng = np.random.default_rng(0)
    rows = {}

    # -- paged decode attention.  bf16 tolerance: both sides accumulate in
    # float32 and round the output to bf16 once (2^-8 relative), so they may
    # differ by one bf16 ulp of an O(1) value.  float32: sums and exp in
    # another order, about 1e-6; 1e-4 leaves room.
    args = _paged_case(gen, rng, 8, 32, 8, 128, 16, 32, torch.bfloat16)
    out = paged_decode_attention_cuda(*args)
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(out[0]).all()) and float(out[0].abs().max()) == 0.0):
        fail("paged_decode_attention: the length-0 lane is not finite zeros")
    err = _compare("paged_decode_attention bf16 B=8 Hq=32 Hkv=8 D=128 ps=16 NP=32 "
                   f"lengths={args[4].tolist()}", out, paged_decode_ref(*args), 1e-2, 1e-2)
    small = _paged_case(gen, rng, 3, 4, 2, 64, 16, 5, torch.float32)
    small_out = paged_decode_attention_cuda(*small)
    if float(small_out[0].abs().max()) != 0.0:
        fail("paged_decode_attention float32: the length-0 lane is not zeros")
    _compare(f"paged_decode_attention f32 B=3 Hq=4 Hkv=2 D=64 lengths={small[4].tolist()}",
             small_out, paged_decode_ref(*small), 1e-4, 1e-4)
    _repeat("paged_decode_attention", lambda: paged_decode_attention_cuda(*args), out)
    q, kp, vp, tabs, lens = args
    kv_tokens = int(lens.sum())
    nbytes = (q.numel() * 2 * 2                       # q in, out
              + 2 * kv_tokens * 8 * 128 * 2           # valid K and V rows
              + tabs.numel() * 4 + lens.numel() * 4)
    flops = 4 * 32 * 128 * kv_tokens                  # QK and PV per (head, key)
    bound, by = _bound(nbytes, flops)
    rows["paged_decode_attention"] = dict(
        route="cuda", source="src/repro_torch/csrc/paged_decode_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:78",
        max_abs_err=err,
        ms=timer.ms(lambda: paged_decode_attention_cuda(*args)),
        plain_ms=timer.ms(lambda: paged_decode_ref(*args)),
        bound_ms=bound, bound_by=by, library_ms=None)
    log(f"[kernels] paged_decode_attention: {rows['paged_decode_attention']}")
    # Yardstick, not a gate: the dense kernel on the same keys gathered
    # into a (B, NP * ps, Hkv, D) cache, the same lengths.
    kd, vd = (x[tabs.long()].reshape(8, 32 * 16, 8, 128) for x in (kp, vp))
    _compare("decode_attention on the paged case's keys, gathered dense, vs paged plain",
             decode_attention_cuda(q, kd, vd, lens), paged_decode_ref(*args), 1e-2, 1e-2)
    log(f"[kernels] paged_decode_attention yardstick: decode_attention_cuda on the same "
        f"keys and lengths {timer.ms(lambda: decode_attention_cuda(q, kd, vd, lens))!r} ms")
    # Host time of one call (the wrapper, the tensor maps' encoding and the
    # launch), the device left busy so no call waits for it.
    from repro_torch.kernels.decode_attention.ops import _decode_op, decode_op
    if not (torch.equal(decode_op(q, kd, vd, lens), decode_attention_cuda(q, kd, vd, lens))
            and torch.equal(_decode_op(q, kd, vd, lens, None, None, None),
                            decode_attention_cuda(q, kd, vd, lens))):
        fail("decode_attention: the op differs from the launch it wraps")
    for name, fn in (("paged_decode_attention_cuda", lambda: paged_decode_attention_cuda(*args)),
                     ("decode_attention_cuda", lambda: decode_attention_cuda(q, kd, vd, lens)),
                     ("decode_op (what the model calls on plain tensors)",
                      lambda: decode_op(q, kd, vd, lens)),
                     ("repro_torch::decode_attention (the custom op: DTensors, fakes)",
                      lambda: _decode_op(q, kd, vd, lens, None, None, None))):
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(Timer.SPIN_CYCLES * 20)
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        host_us = (time.perf_counter() - t0) / 100 * 1e6
        torch.cuda.synchronize()
        log(f"[kernels] {name}: host time per call {host_us!r} us (mean of 100, enqueue only)")
    del kd, vd
    torch.cuda.synchronize()

    # -- flash attention (causal prefill), same tolerances and reasons.  Two
    # hand-written instances (``ops._instance``): bf16 at D 64 and 128 on the
    # tensor cores, float32 and bf16 at D 16 and 32 on the CUDA cores.
    from repro_torch.kernels.flash_attention.ops import _TENSOR_CORES, _aligned, _instance
    hq, hkv, d = 32, 8, 128
    timed = {}
    for label, b, s in (("serving", 8, 256), ("trainer", 2, 512)):
        fq, fk, fv = _flash_case(gen, b, hq, hkv, s, d, torch.bfloat16)
        if _instance(fq.dtype, d, _aligned(fq, fk, fv, fq)) != _TENSOR_CORES:
            fail("flash_attention: the main path's bf16 shape is not on the tensor cores")
        out = flash_attention_cuda(fq, fk, fv, causal=True)
        ref = attention_ref(fq, fk, fv, causal=True)
        err = _compare(f"flash_attention bf16 ({label}) B={b} Hq={hq} Hkv={hkv} S={s} D={d} "
                       "causal", out, ref, 1e-2, 1e-2)
        _repeat("flash_attention", lambda: flash_attention_cuda(fq, fk, fv, causal=True), out)
        nbytes = 2 * (fq.numel() * 2 + fk.numel() + fv.numel())  # q, k, v in; out
        flops = 4 * b * hq * d * (s * (s + 1) // 2)                # causal QK and PV
        bound, by = _bound(nbytes, flops)

        def library(fq=fq, fk=fk, fv=fv):
            return F.scaled_dot_product_attention(fq, fk, fv, is_causal=True,
                                                  enable_gqa=True)

        _compare(f"scaled_dot_product_attention (yardstick, {label}) vs plain", library(),
                 ref, 1e-2, 1e-2)
        timed[label] = dict(
            route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:86",
            max_abs_err=err,
            ms=timer.ms(lambda: flash_attention_cuda(fq, fk, fv, causal=True)),
            plain_ms=timer.ms(lambda: attention_ref(fq, fk, fv, causal=True)),
            bound_ms=bound, bound_by=by, library_ms=timer.ms(library))
        log(f"[kernels] flash_attention ({label}): {timed[label]}")
        if label == "serving":
            # The op the model calls (the custom op around the kernel): its
            # first call pays torch.library's one-time set-up, which would
            # otherwise land in the first serving path's first prefill.
            t0 = time.perf_counter()
            op_out = attention_op(fq, fk, fv, causal=True)
            torch.cuda.synchronize()
            log(f"[kernels] flash_attention custom op, first call: "
                f"{time.perf_counter() - t0!r} s (one-time torch.library set-up)")
            if not torch.equal(op_out, out):
                fail("flash_attention: the custom op differs from the kernel it wraps")
        else:
            _compare(f"flash_attention bf16 (trainer) B={b} S={s} custom op",
                     attention_op(fq, fk, fv, causal=True), ref, 1e-2, 1e-2)
        del fq, fk, fv, out, ref
    # Both instances at ragged shapes: bf16 on the tensor cores (D 64, 128)
    # and on the CUDA cores (D 16, 32), float32 on the CUDA cores.
    for dtype, tol, shapes in (
            (torch.bfloat16, 1e-2, ((2, 4, 2, 77, 64), (1, 8, 2, 130, 128), (3, 4, 1, 65, 16),
                                    (2, 4, 2, 63, 32))),
            (torch.float32, 1e-4, ((2, 4, 2, 77, 64), (1, 8, 2, 130, 128)))):
        for (sb, shq, shkv, ss, sd) in shapes:
            sq, sk, sv = _flash_case(gen, sb, shq, shkv, ss, sd, dtype)
            for causal in (True, False):
                _compare(f"flash_attention {str(dtype)[6:]} ragged B={sb} Hq={shq} Hkv={shkv} "
                         f"S={ss} D={sd} causal={causal} (instance "
                         f"{_instance(dtype, sd)})",
                         flash_attention_cuda(sq, sk, sv, causal=causal),
                         attention_ref(sq, sk, sv, causal=causal), tol, tol)
    rows["flash_attention"] = timed["serving"]  # the trainer's row is logged above
    torch.cuda.synchronize()

    # -- dense-cache decode attention, same tolerances and reasons, at the
    # dense engine's shape (8 lanes) and the chunk side's (batch 1).
    timed = {}
    for label, b in (("dense engine", 8), ("chunk side", 1)):
        dq, dk, dv, dlen = _decode_case(gen, rng, b, 32, 8, 512, 128, torch.bfloat16)
        out = decode_attention_cuda(dq, dk, dv, dlen)
        torch.cuda.synchronize()
        if b > 1 and not (bool(torch.isfinite(out[0]).all()) and float(out[0].abs().max()) == 0.0):
            fail("decode_attention: the length-0 lane is not finite zeros")
        err = _compare(f"decode_attention bf16 ({label}) B={b} Hq=32 Hkv=8 T=512 D=128 "
                       f"lengths={dlen.tolist()}", out, decode_ref(dq, dk, dv, dlen),
                       1e-2, 1e-2)
        _repeat("decode_attention", lambda: decode_attention_cuda(dq, dk, dv, dlen), out)
        kv_tokens = int(dlen.sum())
        nbytes = (dq.numel() * 2 * 2                    # q in, out
                  + 2 * kv_tokens * 8 * 128 * 2         # valid K and V rows
                  + dlen.numel() * 4)
        bound, by = _bound(nbytes, 4 * 32 * 128 * kv_tokens)
        valid = (torch.arange(512, device="cuda")[None, :] < dlen[:, None].long())

        def library(dq=dq, dk=dk, dv=dv, valid=valid):
            return F.scaled_dot_product_attention(
                dq[:, :, None], dk.transpose(1, 2), dv.transpose(1, 2),
                attn_mask=valid[:, None, None, :], enable_gqa=True)[:, :, 0]

        live = dlen > 0  # SDPA gives NaN on a fully masked row
        _compare(f"scaled_dot_product_attention (yardstick, {label}) vs plain",
                 library()[live], decode_ref(dq, dk, dv, dlen)[live], 1e-2, 1e-2)
        timed[label] = dict(
            route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
            replaces="src/repro/kernels/decode_attention/kernel.py:74",
            max_abs_err=err,
            ms=timer.ms(lambda: decode_attention_cuda(dq, dk, dv, dlen)),
            plain_ms=timer.ms(lambda: decode_ref(dq, dk, dv, dlen)),
            bound_ms=bound, bound_by=by, library_ms=timer.ms(library))
        log(f"[kernels] decode_attention ({label}): {timed[label]}")
    for (sb, shq, shkv, st, sd) in ((3, 4, 2, 77, 64), (2, 8, 2, 130, 16)):
        small = _decode_case(gen, rng, sb, shq, shkv, st, sd, torch.float32)
        _compare(f"decode_attention f32 ragged B={sb} Hq={shq} Hkv={shkv} T={st} D={sd} "
                 f"lengths={small[3].tolist()}", decode_attention_cuda(*small),
                 decode_ref(*small), 1e-4, 1e-4)
    rows["decode_attention"] = timed["dense engine"]  # the chunk side's is logged above
    torch.cuda.synchronize()
    rows["ssd_scan"] = _ssd_scan_kernel(timer, gen)
    rows["ssd_scan_bwd"] = _ssd_scan_bwd_kernel(timer, gen)
    rows["batched_gather"] = _batched_gather_kernel(timer, gen)
    _config_shapes(timer, gen, rng)
    for name, sub in _new_layouts(timer, gen, rng).items():
        rows[name]["sub_rows"] = sub
    rows["flash_attention"]["sub_rows"].append(_sharded_flash_row(timer, gen))
    rows["decode_attention"]["sub_rows"].append(_split_kv_row(timer, gen, rng))
    for name, sub in _in_graph_rows(timer, gen, rng).items():
        rows[name]["sub_rows"].append(sub)
    return rows


def _graph_ms(fns, n: int) -> float:
    """Device time of one of ``n`` back-to-back calls captured in one CUDA
    graph, call i being ``fns[i % len(fns)]`` (median of 5 replays, CUDA
    events around each).  The capture's launches are tallied apart:
    timing is no path's."""
    import torch
    from repro_torch.kernels import registry

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), registry.capture_tally():
        fns[0]()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with registry.capture_tally(), torch.cuda.graph(graph):
        for i in range(n):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    ms = float(np.median([a.elapsed_time(b) for a, b in times])) / n
    del graph
    return ms


def _in_graph_rows(timer, gen, rng) -> dict:
    """Sub-rows 1j and 3j: rows 1 (paged decode, the tick's shape) and 3b
    (decode at B 1, the chunk step's) timed inside one captured CUDA graph
    of 100 back-to-back launches, where no host launch sits between two
    kernels.  ``ms``: each launch on its own copy of q, K and V, the
    copies cycled so that they exceed twice the 50 MB L2 and every launch
    finds its operands in device memory, as rows 1 and 3b do after their
    flush; ``warm_ms``: every launch on the same operands, left in L2;
    ``eager_ms``: rows 1 and 3b's event-timed lone launch.  ``eager_ms``
    less ``ms`` is the device-side cost of a lone launch; the plain
    version and the bound as for the rows.  3j's ``library_ms`` is row
    3b's yardstick, SDPA with the boolean mask, in the same kind of graph
    on the same cycled copies (row 1 has no library call)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import decode_ref
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention_cuda
    from repro_torch.kernels.paged_attention.ref import paged_decode_ref

    n, out = 100, {}
    q, kp, vp, tabs, lens = _paged_case(gen, rng, 8, 32, 8, 128, 16, 32, torch.bfloat16)
    dq, dk, dv, dlen = _decode_case(gen, rng, 1, 32, 8, 512, 128, torch.bfloat16)
    valid = (torch.arange(512, device="cuda")[None, :] < dlen[:, None].long())

    def sdpa(c):  # row 3b's library call
        return F.scaled_dot_product_attention(
            c[0][:, :, None], c[1].transpose(1, 2), c[2].transpose(1, 2),
            attn_mask=valid[:, None, None, :], enable_gqa=True)[:, :, 0]

    cases = (  # (row, label, kernel on a copy, plain, library on a copy, copies,
        #         valid keys, other bytes)
        ("paged_decode_attention", "1j paged, 100 launches in one graph B 8 32/8 ps 16 NP 32",
         lambda c: paged_decode_attention_cuda(c[0], c[1], c[2], tabs, lens),
         lambda: paged_decode_ref(q, kp, vp, tabs, lens), None, (q, kp, vp), 8,
         int(lens.sum()), q.numel() * 2 * 2 + tabs.numel() * 4 + lens.numel() * 4),
        ("decode_attention", "3j decode B 1, 100 launches in one graph 32/8 T 512",
         lambda c: decode_attention_cuda(c[0], c[1], c[2], dlen),
         lambda: decode_ref(dq, dk, dv, dlen), sdpa, (dq, dk, dv), 64,
         int(dlen.sum()), dq.numel() * 2 * 2 + 4))
    for name, label, kern, plain, lib, ops, n_copies, kv_tokens, small_bytes in cases:
        copies = [ops] + [tuple(t.clone() for t in ops) for _ in range(n_copies - 1)]
        err = _compare(f"{name} bf16 ({label[:2]})", kern(copies[-1]), plain(), 1e-2, 1e-2)
        bound = _bound(small_bytes + 2 * kv_tokens * 8 * 128 * 2, 4 * 32 * 128 * kv_tokens)
        library_ms = None
        if lib is not None:
            _compare(f"scaled_dot_product_attention (yardstick, {label[:2]}) vs plain",
                     lib(copies[-1]), plain(), 1e-2, 1e-2)
            library_ms = _graph_ms([lambda c=c: lib(c) for c in copies], n)
        row = _sub_row(label, err, _graph_ms([lambda c=c: kern(c) for c in copies], n),
                       timer.ms(plain), bound, library_ms)
        row["warm_ms"] = _graph_ms([lambda: kern(ops)], n)
        row["eager_ms"] = timer.ms(lambda: kern(ops))
        log(f"[kernels] {label}: in a graph {row['ms']!r} ms a launch (operands from device "
            f"memory), {row['warm_ms']!r} ms (operands in L2), against {row['eager_ms']!r} "
            f"ms for one event-timed launch after a flush")
        del copies
        out[name] = row
    return out


def _split_kv_row(timer, gen, rng):
    """Sub-row 3i: the decode kernel with its log-sum-exp (``return_lse``)
    at a rank's shard of a ``kv_seq_shard`` cache, phase 11f's layout at
    full width: bf16, B 8, Hq 32, Hkv 8, D 128, the rank's 256 of 512 rows,
    local lengths ragged in [0, 256] (0: the lane's rows lie on the other
    rank).  ``out`` against the plain version at bf16's 1e-2, ``lse`` at
    float32's 1e-4 (both sum float32 exponentials of the same scores) and
    ``-inf`` on the length-0 lane; the output the same bits as the launch
    without ``lse``; a repeated call bit for bit; timed beside the plain
    version, the bound (q, out, lse and the valid K/V rows) and SDPA (which
    gives no log-sum-exp)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import decode_ref

    b, hq, hkv, t, d = 8, 32, 8, 256, 128
    dq, dk, dv, dlen = _decode_case(gen, rng, b, hq, hkv, t, d, torch.bfloat16)
    kern = lambda: decode_attention_cuda(dq, dk, dv, dlen, return_lse=True)  # noqa: E731
    out, lse = kern()
    want_out, want_lse = decode_ref(dq, dk, dv, dlen, return_lse=True)
    label = f"decode_attention bf16 + lse (3i, a rank's 256 of 512 rows) B={b} Hq={hq} " \
            f"Hkv={hkv} D={d} lengths={dlen.tolist()}"
    err = _compare(f"{label}: out", out, want_out, 1e-2, 1e-2)
    live = dlen > 0
    _compare(f"{label}: lse", lse[live], want_lse[live], 1e-4, 1e-4)
    if not bool(torch.isneginf(lse[~live]).all()):
        fail("decode_attention: the length-0 lane's log-sum-exp is not -inf")
    if not torch.equal(out, decode_attention_cuda(dq, dk, dv, dlen)):
        fail("decode_attention: return_lse changes the output")
    _repeat("decode_attention + lse (3i)", lambda: torch.cat(
        [x.float().flatten() for x in kern()]), torch.cat([out.float().flatten(), lse.flatten()]))
    kv_tokens = int(dlen.sum())
    bound = _bound(dq.numel() * 2 * 2 + b * hq * 4 + 2 * kv_tokens * hkv * d * 2 + b * 4,
                   4 * hq * d * kv_tokens)
    valid = torch.arange(t, device="cuda")[None, :] < dlen[:, None].long()
    return _sub_row(
        "3i decode + lse, a rank's 256 of 512 rows B 8 32/8 D 128", err,
        timer.ms(kern), timer.ms(lambda: decode_ref(dq, dk, dv, dlen, return_lse=True)), bound,
        timer.ms(lambda: F.scaled_dot_product_attention(
            dq[:, :, None], dk.transpose(1, 2), dv.transpose(1, 2),
            attn_mask=valid[:, None, None, :], enable_gqa=True)))


def _sharded_flash_row(timer, gen):
    """Flash at a rank's shard in phase 11a: one microbatch of one
    sequence, llama3-8b's heads halved over ``model`` (16 q / 4 kv), S 512,
    D 128, bf16; its bound, plain version and SDPA as for the main row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref

    b, hq, hkv, s, d = 1, 16, 4, 512, 128
    # laid out (B, H, S, D): the model hands the op contiguous shards on a mesh
    fq, fk, fv = (t.contiguous() for t in _flash_case(gen, b, hq, hkv, s, d, torch.bfloat16))
    out = flash_attention_cuda(fq, fk, fv, causal=True)
    err = _compare(f"flash_attention bf16 (11a's shard) B={b} Hq={hq} Hkv={hkv} S={s} D={d}",
                   out, attention_ref(fq, fk, fv, causal=True), 1e-2, 1e-2)
    bound = _bound(2 * (fq.numel() * 2 + fk.numel() + fv.numel()),
                   4 * b * hq * d * (s * (s + 1) // 2))
    return _sub_row(
        "2g flash, 11a's shard B 1 S 512 16/4 D 128", err,
        timer.ms(lambda: flash_attention_cuda(fq, fk, fv, causal=True)),
        timer.ms(lambda: attention_ref(fq, fk, fv, causal=True)), bound,
        timer.ms(lambda: F.scaled_dot_product_attention(fq, fk, fv, is_causal=True,
                                                         enable_gqa=True)))


# Head layouts (Hq, Hkv) of the configurations served in phases 4l-4o, all
# at D 128: deepseek-moe-16b and olmo-1b, qwen1.5-4b, chatglm3-6b.
CONFIG_HEADS = (("deepseek-moe-16b/olmo-1b", 16, 16), ("qwen1.5-4b", 20, 20),
                ("chatglm3-6b", 32, 2))


def _config_shapes(timer, gen, rng) -> None:
    """The three attention kernels of the serving paths at the new
    configurations' head layouts, bf16, D 128 (both decode kernels at 8
    lanes and at 1), against their plain
    versions at the tolerances above (1e-2), a repeated call bit for bit,
    and timed beside the plain version, the bound and the library call
    (SDPA; the paged kernel has none): a group of 1 (Hq = Hkv) and
    chatglm's 16 over 2 KV heads (B x 2 = 16 (lane, kv head) items, the
    decode kernels' largest group).  Logged as sub-rows of the kernels'
    rows; the JSON line keeps one row per kernel."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import decode_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention_cuda
    from repro_torch.kernels.paged_attention.ref import paged_decode_ref

    d, bf = 128, torch.bfloat16
    for label, hq, hkv in CONFIG_HEADS:
        for lanes in (8, 1):
            args = _paged_case(gen, rng, lanes, hq, hkv, d, 16, 32, bf)
            out = paged_decode_attention_cuda(*args)
            err = _compare(f"paged_decode_attention bf16 {label} B={lanes} Hq={hq} Hkv={hkv} "
                           f"D={d} ps=16 NP=32", out, paged_decode_ref(*args), 1e-2, 1e-2)
            _repeat(f"paged_decode_attention ({label}, B {lanes})",
                    lambda: paged_decode_attention_cuda(*args), out)
            kv_tokens = int(args[4].sum())
            bound, by = _bound(args[0].numel() * 2 * 2 + 2 * kv_tokens * hkv * d * 2
                               + args[3].numel() * 4 + lanes * 4, 4 * hq * d * kv_tokens)
            log(f"[kernels] paged_decode_attention ({label}, Hq {hq} Hkv {hkv}, B {lanes}): "
                + repr(dict(max_abs_err=err,
                            ms=timer.ms(lambda: paged_decode_attention_cuda(*args)),
                            plain_ms=timer.ms(lambda: paged_decode_ref(*args)),
                            bound_ms=bound, bound_by=by, library_ms=None)))
            del args, out

        b, sq = 8, 256
        fq, fk, fv = _flash_case(gen, b, hq, hkv, sq, d, bf)
        out = flash_attention_cuda(fq, fk, fv, causal=True)
        err = _compare(f"flash_attention bf16 {label} B={b} Hq={hq} Hkv={hkv} S={sq} D={d} "
                       "causal", out, attention_ref(fq, fk, fv, causal=True), 1e-2, 1e-2)
        _repeat(f"flash_attention ({label})",
                lambda: flash_attention_cuda(fq, fk, fv, causal=True), out)
        bound, by = _bound(2 * (fq.numel() * 2 + fk.numel() + fv.numel()),
                           4 * b * hq * d * (sq * (sq + 1) // 2))
        log(f"[kernels] flash_attention ({label}, Hq {hq} Hkv {hkv}, 8 x 256): " + repr(dict(
            max_abs_err=err, ms=timer.ms(lambda: flash_attention_cuda(fq, fk, fv, causal=True)),
            plain_ms=timer.ms(lambda: attention_ref(fq, fk, fv, causal=True)),
            bound_ms=bound, bound_by=by,
            library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
                fq, fk, fv, is_causal=True, enable_gqa=True)))))
        del fq, fk, fv, out

        for side, lanes in (("dense engine", 8), ("chunk side", 1)):
            dq, dk, dv, dlen = _decode_case(gen, rng, lanes, hq, hkv, 512, d, bf)
            out = decode_attention_cuda(dq, dk, dv, dlen)
            err = _compare(f"decode_attention bf16 {label} ({side}) B={lanes} Hq={hq} "
                           f"Hkv={hkv} T=512 D={d} lengths={dlen.tolist()}", out,
                           decode_ref(dq, dk, dv, dlen), 1e-2, 1e-2)
            _repeat(f"decode_attention ({label}, {side})",
                    lambda: decode_attention_cuda(dq, dk, dv, dlen), out)
            kv_tokens = int(dlen.sum())
            bound, by = _bound(dq.numel() * 2 * 2 + 2 * kv_tokens * hkv * d * 2 + lanes * 4,
                               4 * hq * d * kv_tokens)
            valid = (torch.arange(512, device="cuda")[None, :] < dlen[:, None].long())

            def library(dq=dq, dk=dk, dv=dv, valid=valid):
                return F.scaled_dot_product_attention(
                    dq[:, :, None], dk.transpose(1, 2), dv.transpose(1, 2),
                    attn_mask=valid[:, None, None, :], enable_gqa=True)[:, :, 0]

            log(f"[kernels] decode_attention ({label}, Hq {hq} Hkv {hkv}, {side}): "
                + repr(dict(max_abs_err=err,
                            ms=timer.ms(lambda: decode_attention_cuda(dq, dk, dv, dlen)),
                            plain_ms=timer.ms(lambda: decode_ref(dq, dk, dv, dlen)),
                            bound_ms=bound, bound_by=by, library_ms=timer.ms(library))))
            del dq, dk, dv, out
    _group_rows(timer, gen, rng)
    torch.cuda.synchronize()


def _group_rows(timer, gen, rng) -> None:
    """The paged kernel at the groups where the tensor cores take it, both
    instances on the same operands: chatglm3-6b's 32/2 (G 16) at 8 lanes
    and 1 (32 pages of 16 keys) and at the long-document cell's tick (32
    lanes, 512-page tables, lengths 3072 to 8192), and 16/2 (G 8) at 8
    and 32 lanes, the threshold's other side.  Each against the plain
    version (1e-2), a repeated call bit for bit, and timed (``ms``, the
    wrapper's instance) beside the CUDA-core instance (``cores_ms``), the
    bound and the yardstick ``decode_attention_cuda`` on the same keys
    gathered dense (``dense_ms``)."""
    import torch
    from repro_torch.kernels.decode_attention.ops import decode_attention_cuda
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention_cuda
    from repro_torch.kernels.paged_attention.ref import paged_decode_ref

    d, ps, bf = 128, 16, torch.bfloat16
    for hq, hkv, lanes, np_, lo in ((32, 2, 8, 32, 0), (32, 2, 1, 32, 0), (32, 2, 32, 512, 3072),
                                    (16, 2, 8, 32, 0), (16, 2, 32, 512, 3072)):
        q, kp, vp, tabs, lens = _paged_case(gen, rng, lanes, hq, hkv, d, ps, np_, bf)
        if lo:  # the long-document cell's lengths: uniform in [lo, NP * ps]
            lens = torch.as_tensor(rng.integers(lo, np_ * ps + 1, size=(lanes,)).astype(np.int32),
                                   device="cuda")
        args = (q, kp, vp, tabs, lens)
        label = f"paged G {hq // hkv} ({hq}/{hkv}) B {lanes} ps {ps} NP {np_}"
        if paged_ops._instance(bf, hq // hkv, d, ps) != paged_ops._TENSOR_CORES:
            fail(f"{label}: bf16 at G {hq // hkv} is not on the tensor cores")
        want = paged_decode_ref(*args)
        out = paged_decode_attention_cuda(*args)
        err = _compare(f"{label} (tensor cores)", out, want, 1e-2, 1e-2)
        _repeat(f"paged_decode_attention ({label})", lambda: paged_decode_attention_cuda(*args),
                out)

        def cores(args=args):
            return paged_ops._launch(*args, paged_ops._CUDA_CORES)

        _compare(f"{label} (CUDA cores)", cores(), want, 1e-2, 1e-2)
        kv_tokens = int(lens.sum())
        bound = _bound(q.numel() * 2 * 2 + 2 * kv_tokens * hkv * d * 2 + tabs.numel() * 4
                       + lanes * 4, 4 * hq * d * kv_tokens)
        kd, vd = (x[tabs.long()].reshape(lanes, np_ * ps, hkv, d) for x in (kp, vp))
        row = _sub_row(label, err, timer.ms(lambda: paged_decode_attention_cuda(*args)),
                       timer.ms(lambda: paged_decode_ref(*args)), bound)
        row["cores_ms"] = timer.ms(cores)
        row["dense_ms"] = timer.ms(lambda: decode_attention_cuda(q, kd, vd, lens))
        log(f"[kernels] {label}: tensor cores {row['ms']!r} ms, CUDA cores "
            f"{row['cores_ms']!r} ms, dense yardstick {row['dense_ms']!r} ms, bound "
            f"{row['bound_ms']!r} ms ({100 * row['bound_ms'] / row['ms']:.2f} % of it)")
        del q, kp, vp, kd, vd, args, out, want


def _sub_row(label, err, ms, plain_ms, bound, library_ms=None):
    """One logged sub-row of a kernel's row: a layout of the new families."""
    row = dict(label=label, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
               bound_by=bound[1], library_ms=library_ms)
    log(f"[kernels] sub-row {row}")
    return row


def _band_pairs(s: int, window: int) -> int:
    """(query, key) pairs a causal band of ``window`` keeps over S tokens:
    sum over i of min(i + 1, W)."""
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def _new_layouts(timer, gen, rng) -> dict:
    """The kernels at the layouts of hymba-1.5b, qwen2-vl-2b and
    seamless-m4t-medium (phases 4p-4r), each against its plain version at
    the tolerances above, a repeated call bit for bit, and timed beside
    the plain version, the bound and SDPA where it computes the same
    function: the banded flash (B 8, S 2048, 25/5, D 64, W 1024; its bound
    and SDPA's boolean band mask count the band's pairs, 0.75 of the causal
    ones), the window's edges (W >= S is the causal kernel's bits, W = 1
    each query's own value row) and a ragged float32 window on the CUDA
    cores; flash without a mask at the encoder's S = T = 512 and the cross
    attention's S 64 over T 512 (16/16, D 64); decode at group 5 over the
    1024-row ring, group 6 at D 128, group 1 (self and cross, T 512); paged
    decode at 12/2, D 128; ``ssd_scan`` at hymba's prefill (H 25, P 64, N
    16).  Returns ``{kernel: [sub-row, ...]}`` for the JSON line."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention.ops import decode_attention_cuda
    from repro_torch.kernels.decode_attention.ref import decode_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.paged_attention.ops import paged_decode_attention_cuda
    from repro_torch.kernels.paged_attention.ref import paged_decode_ref
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    bf = torch.bfloat16
    out = {"flash_attention": [], "decode_attention": [], "paged_decode_attention": [],
           "ssd_scan": []}

    # -- the band: hymba's prefill of 8 prompts of 2048 tokens.
    b, s, hq, hkv, d, w = 8, 2048, 25, 5, 64, 1024
    fq, fk, fv = _flash_case(gen, b, hq, hkv, s, d, bf)
    kern = lambda: flash_attention_cuda(fq, fk, fv, causal=True, window=w)  # noqa: E731
    plain = lambda: attention_ref(fq, fk, fv, causal=True, window=w)  # noqa: E731
    got = kern()
    err = _compare(f"flash_attention bf16 hymba band B={b} Hq={hq} Hkv={hkv} S={s} D={d} "
                   f"W={w}", got, plain(), 1e-2, 1e-2)
    _repeat("flash_attention (band)", kern, got)
    idx = torch.arange(s, device="cuda")
    band = (idx[None, :] <= idx[:, None]) & (idx[:, None] - idx[None, :] < w)

    def library():
        return F.scaled_dot_product_attention(fq, fk, fv, attn_mask=band, enable_gqa=True)

    _compare("scaled_dot_product_attention (yardstick, band) vs plain", library(), plain(),
             1e-2, 1e-2)
    pairs = _band_pairs(s, w)
    log(f"[kernels] flash_attention band: {pairs} of {s * (s + 1) // 2} causal (query, key) "
        f"pairs ({pairs / (s * (s + 1) // 2)!r})")
    causal_ms = timer.ms(lambda: flash_attention_cuda(fq, fk, fv, causal=True))
    out["flash_attention"].append(_sub_row(
        f"hymba band B {b} S {s} {hq}/{hkv} D {d} W {w}", err, timer.ms(kern),
        timer.ms(plain), _bound(2 * (fq.numel() * 2 + fk.numel() + fv.numel()),
                                4 * b * hq * d * pairs), timer.ms(library)))
    log(f"[kernels] flash_attention at the same shape, causal (no window): {causal_ms!r} ms")
    if not torch.equal(flash_attention_cuda(fq, fk, fv, causal=True, window=s),
                       flash_attention_cuda(fq, fk, fv, causal=True)):
        fail("flash_attention: a window of S is not the causal kernel's bits")
    one = flash_attention_cuda(fq, fk, fv, causal=True, window=1)
    if not torch.equal(one, fv.repeat_interleave(hq // hkv, dim=1)):
        fail("flash_attention: a window of 1 is not each query's own value row")
    log("[kernels] flash_attention band edges: W = S gives the causal bits, W = 1 the "
        "diagonal's value rows exactly: ok")
    del fq, fk, fv, got, band
    for dtype, tol, shape, win in ((torch.float32, 1e-4, (3, 10, 2, 77, 64), 7),
                                   (bf, 1e-2, (2, 10, 2, 130, 32), 7),
                                   (bf, 1e-2, (2, 10, 2, 200, 128), 64)):
        sb, shq, shkv, ss, sd = shape
        sq, sk, sv = _flash_case(gen, sb, shq, shkv, ss, sd, dtype)
        _compare(f"flash_attention {str(dtype)[6:]} ragged band B={sb} Hq={shq} Hkv={shkv} "
                 f"S={ss} D={sd} W={win}", flash_attention_cuda(sq, sk, sv, window=win),
                 attention_ref(sq, sk, sv, window=win), tol, tol)

    # -- no mask: seamless's encoder and its cross attention.
    for label, sq_len, t in (("seamless encoder", 512, 512), ("seamless cross", 64, 512)):
        q = _flash_case(gen, 8, 16, 16, sq_len, 64, bf)[0]
        k, v = _flash_case(gen, 8, 16, 16, t, 64, bf)[1:]
        kern = lambda q=q, k=k, v=v: flash_attention_cuda(q, k, v, causal=False)  # noqa: E731
        plain = lambda q=q, k=k, v=v: attention_ref(q, k, v, causal=False)  # noqa: E731
        got = kern()
        err = _compare(f"flash_attention bf16 {label} B=8 16/16 S={sq_len} T={t} D=64 no mask",
                       got, plain(), 1e-2, 1e-2)
        _repeat(f"flash_attention ({label})", kern, got)
        out["flash_attention"].append(_sub_row(
            f"{label} B 8 S {sq_len} T {t} 16/16 D 64", err, timer.ms(kern), timer.ms(plain),
            _bound(2 * (q.numel() * 2 + k.numel() + v.numel()), 4 * 8 * 16 * 64 * sq_len * t),
            timer.ms(lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v,
                                                                          enable_gqa=True))))

    # -- decode: hymba's ring (G 5), qwen2-vl (G 6, D 128), seamless (G 1).
    for label, hq, hkv, t, d, full in (("hymba ring G 5", 25, 5, 1024, 64, False),
                                       ("qwen2-vl G 6", 12, 2, 320, 128, False),
                                       ("seamless self G 1", 16, 16, 512, 64, False),
                                       ("seamless cross G 1", 16, 16, 512, 64, True)):
        dq, dk, dv, dlen = _decode_case(gen, rng, 8, hq, hkv, t, d, bf)
        if full:
            dlen = torch.full((8,), t, dtype=torch.int32, device="cuda")
        kern = lambda a=(dq, dk, dv, dlen): decode_attention_cuda(*a)  # noqa: E731
        plain = lambda a=(dq, dk, dv, dlen): decode_ref(*a)  # noqa: E731
        got = kern()
        err = _compare(f"decode_attention bf16 {label} B=8 Hq={hq} Hkv={hkv} T={t} D={d} "
                       f"lengths={dlen.tolist()}", got, plain(), 1e-2, 1e-2)
        _repeat(f"decode_attention ({label})", kern, got)
        kv_tokens = int(dlen.sum())
        valid = (torch.arange(t, device="cuda")[None, :] < dlen[:, None].long())

        def library(dq=dq, dk=dk, dv=dv, valid=valid):
            return F.scaled_dot_product_attention(
                dq[:, :, None], dk.transpose(1, 2), dv.transpose(1, 2),
                attn_mask=valid[:, None, None, :], enable_gqa=True)[:, :, 0]

        out["decode_attention"].append(_sub_row(
            f"{label} B 8 T {t} {hq}/{hkv} D {d}", err, timer.ms(kern), timer.ms(plain),
            _bound(dq.numel() * 2 * 2 + 2 * kv_tokens * hkv * d * 2 + 8 * 4,
                   4 * hq * d * kv_tokens), timer.ms(library)))

    args = _paged_case(gen, rng, 8, 12, 2, 128, 16, 32, bf)
    got = paged_decode_attention_cuda(*args)
    err = _compare("paged_decode_attention bf16 qwen2-vl B=8 Hq=12 Hkv=2 D=128 ps=16 NP=32",
                   got, paged_decode_ref(*args), 1e-2, 1e-2)
    _repeat("paged_decode_attention (qwen2-vl)", lambda: paged_decode_attention_cuda(*args), got)
    kv_tokens = int(args[4].sum())
    out["paged_decode_attention"].append(_sub_row(
        "qwen2-vl B 8 12/2 D 128 ps 16 NP 32", err,
        timer.ms(lambda: paged_decode_attention_cuda(*args)),
        timer.ms(lambda: paged_decode_ref(*args)),
        _bound(args[0].numel() * 2 * 2 + 2 * kv_tokens * 2 * 128 * 2 + args[3].numel() * 4
               + 8 * 4, 4 * 12 * 128 * kv_tokens)))

    shape = (8, 8, 25, 64, 16)  # 8 prompts of 2048 tokens, chunks of 256
    states, decay = _scan_case(gen, shape, torch.float32)
    prev, final = ssd_scan_cuda(states, decay)
    rprev, rfinal = ssd_scan_ref(states, decay)
    err = max(_compare(f"ssd_scan f32 hymba prefill B,C,H,P,N={shape} prev", prev, rprev,
                       1e-6, 1e-6),
              _compare(f"ssd_scan f32 hymba prefill B,C,H,P,N={shape} final", final, rfinal,
                       1e-6, 1e-6))
    out["ssd_scan"].append(_sub_row(
        f"hymba prefill B,C,H,P,N {shape}", err, timer.ms(lambda: ssd_scan_cuda(states, decay)),
        timer.ms(lambda: ssd_scan_ref(states, decay)),
        _bound(4 * (2 * states.numel() + decay.numel() + states.numel() // shape[1]),
               2 * states.numel(), F32_FLOPS_PER_S)))
    torch.cuda.synchronize()
    return out


def _scan_case(gen, shape, dtype):
    import torch
    b, c, h = shape[:3]
    states = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    decay = torch.sigmoid(torch.randn((b, c, h), generator=gen, device="cuda"))
    return states, decay


def _ssd_scan_kernel(timer, gen):
    """The ``ssd_scan`` kernel against its plain version.  Tolerances:
    float32 1e-6 (a few ulps: both sides do the same multiply and add in
    float32 per chunk, the kernel without FMA contraction, so it should
    read 0); bf16 ``prev`` 2^-7 relative (one bf16 ulp of its rounding:
    the kernel rounds the float32 carry to bf16, the plain version keeps
    it in float32) and ``final`` as float32."""
    import torch
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    def check(label, states, decay, prev_tol):
        prev, final = ssd_scan_cuda(states, decay)
        torch.cuda.synchronize()
        rprev, rfinal = ssd_scan_ref(states, decay)
        if prev.dtype != states.dtype or final.dtype != torch.float32:
            fail(f"ssd_scan {label}: output dtypes {prev.dtype}, {final.dtype}")
        err = _compare(f"ssd_scan {label} prev", prev, rprev, *prev_tol)
        return max(err, _compare(f"ssd_scan {label} final", final, rfinal, 1e-6, 1e-6))

    # mamba2-1.3b's prefill: 8 prompts of 2048 tokens, chunks of 256.
    shape = (8, 8, 64, 64, 128)
    states, decay = _scan_case(gen, shape, torch.float32)
    err = check(f"f32 mamba2 prefill B,C,H,P,N={shape}", states, decay, (1e-6, 1e-6))
    for small in ((2, 8, 4, 16, 32), (1, 16, 2, 8, 8), (3, 4, 5, 32, 16), (1, 32, 1, 64, 64)):
        for dtype, tol in ((torch.float32, (1e-6, 1e-6)), (torch.bfloat16, (2.0 ** -7, 1e-6))):
            check(f"{str(dtype)[6:]} sweep B,C,H,P,N={small}",
                  *_scan_case(gen, small, dtype), tol)
    check("f32 one chunk B,C,H,P,N=(8, 1, 64, 64, 128)",
          *_scan_case(gen, (8, 1, 64, 64, 128), torch.float32), (1e-6, 1e-6))
    # States read once, prev and final written once (decay is 16 KB); two
    # float32 flops per element per chunk.
    nbytes = 4 * (2 * states.numel() + decay.numel() + states.numel() // shape[1])
    bound, by = _bound(nbytes, 2 * states.numel(), F32_FLOPS_PER_S)
    row = dict(route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
               replaces="src/repro/kernels/ssd_scan/kernel.py:51", max_abs_err=err,
               ms=timer.ms(lambda: ssd_scan_cuda(states, decay)),
               plain_ms=timer.ms(lambda: ssd_scan_ref(states, decay)),
               bound_ms=bound, bound_by=by, library_ms=None)
    log(f"[kernels] ssd_scan (no single PyTorch call computes it: library_ms null): {row}")
    torch.cuda.synchronize()
    return row


def _scan_autograd(scan_ref, states, decay, g_prev, g_final):
    """(d_states, d_decay) by autograd of the plain scan, float32 states;
    a missing ``g_final`` is zeros.  With one chunk ``prev`` is the zero
    initial state, which no input reaches: only ``final`` is
    differentiated then."""
    import torch
    leaves = [states.float().requires_grad_(), decay.clone().requires_grad_()]
    prev, final = scan_ref(*leaves)
    pairs = [(prev, g_prev.float()),
             (final, torch.zeros_like(final) if g_final is None else g_final)]
    pairs = [(o, g) for o, g in pairs if o.requires_grad]
    return torch.autograd.grad([o for o, _g in pairs], leaves, [g for _o, g in pairs])


def _ssd_scan_bwd_kernel(timer, gen):
    """The ``ssd_scan_bwd`` kernel (the scan's adjoint, no TPU counterpart)
    against its plain version on the card and against autograd of
    ``ssd_scan_ref``, at mamba2-1.3b's training shape (the prefill's, B 8,
    C 8, H 64, P 64, N 128, float32) without ``g_final`` (the model's
    case: no loss reads the final state) and with it, at hymba-1.5b's (H
    25, N 16) and at small ragged shapes in float32 and bf16; three calls
    give the same bits.  Tolerances: ``d_states`` and ``d_initial`` 1e-6
    (the plain version's float32 multiply and add, unfused: they should
    read 0; bf16 ``d_states`` the same rounding of the same float32 carry),
    ``d_decay`` 1e-5 of its largest entry (a float32 sum over P x N
    products in another order; against autograd with bf16 states 2^-7,
    since autograd differentiates at the float32 ``prev``, the kernel at
    its bf16 rounding).  Timed without ``g_final``; the row's
    bound is bytes (``g_prev`` and ``prev`` read, ``d_states`` and
    ``d_initial`` written).  No single PyTorch call computes it."""
    import torch
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_bwd_cuda, ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref, ssd_scan_ref

    def case(shape, dtype, with_final):
        states, decay = _scan_case(gen, shape, dtype)
        prev, _final = ssd_scan_cuda(states, decay)
        g_prev = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        g_final = (torch.randn(shape[:1] + shape[2:], generator=gen, device="cuda")
                   if with_final else None)
        return states, decay, (g_prev, g_final, prev, decay)

    def check(label, shape, dtype, with_final):
        states, decay, args = case(shape, dtype, with_final)
        out = ssd_scan_bwd_cuda(*args)
        torch.cuda.synchronize()
        want = ssd_scan_bwd_ref(*args)
        auto = _scan_autograd(ssd_scan_ref, states, decay, args[0], args[1])
        label = f"ssd_scan_bwd {label} B,C,H,P,N={shape} {str(dtype)[6:]}" + (
            " with g_final" if with_final else "")
        err = 0.0
        for name, got, ref in (("d_states", out[0], want[0]), ("d_initial", out[2], want[2]),
                               ("d_states vs autograd", out[0], auto[0].to(dtype))):
            err = max(err, _compare(f"{label} {name}", got, ref, 1e-6, 1e-6))
        # Autograd's d_decay takes the float32 prev, the kernel a bf16 prev's.
        for name, ref, tol in (("d_decay", want[1], 1e-5),
                               ("d_decay vs autograd", auto[1],
                                1e-5 if dtype == torch.float32 else 2.0 ** -7)):
            err = max(err, _compare(f"{label} {name}", out[1], ref, 0,
                                    tol * float(ref.abs().max())))
        for _ in range(2):
            again = ssd_scan_bwd_cuda(*args)
            if not all(torch.equal(a, b) for a, b in zip(again, out)):
                fail(f"{label}: two calls on the same inputs differ")
        log(f"[kernels] {label}: three calls bit-identical")
        return err, args

    def bound(args):
        g_prev, g_final, prev, decay = args
        nbytes = (g_prev.numel() * g_prev.element_size() + prev.numel() * prev.element_size()
                  + prev.numel() * prev.element_size()              # d_states out
                  + 4 * (prev.numel() // prev.shape[1])             # d_initial out
                  + 2 * 4 * decay.numel()                           # decay in, d_decay out
                  + (0 if g_final is None else 4 * g_final.numel()))
        return _bound(nbytes, 4 * prev.numel(), F32_FLOPS_PER_S)

    def timed(args):
        return (timer.ms(lambda: ssd_scan_bwd_cuda(*args)),
                timer.ms(lambda: ssd_scan_bwd_ref(*args)))

    err, args = check("mamba2 training", (8, 8, 64, 64, 128), torch.float32, False)
    ms, plain_ms = timed(args)
    b, by = bound(args)
    row = dict(route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
               replaces="src/repro/kernels/ssd_scan/kernel.py:51",  # its gradient
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
               library_ms=None, sub_rows=[])
    log(f"[kernels] ssd_scan_bwd (no single PyTorch call computes it: library_ms null): "
        f"{row}")
    del args
    for label, shape, with_final in (("mamba2 training", (8, 8, 64, 64, 128), True),
                                     ("hymba training", (8, 8, 25, 64, 16), False)):
        err, args = check(label, shape, torch.float32, with_final)
        row["sub_rows"].append(_sub_row(f"{label} B,C,H,P,N {shape}"
                                        + (" with g_final" if with_final else ""),
                                        err, *timed(args), bound(args)))
        del args
    for shape in ((2, 3, 5, 5, 7), (1, 1, 2, 3, 5), (2, 8, 4, 16, 32)):
        for dtype in (torch.float32, torch.bfloat16):
            for with_final in (False, True):
                check("ragged", shape, dtype, with_final)
    torch.cuda.synchronize()
    return row


def _batched_gather_kernel(timer, gen):
    """The ``batched_gather`` kernel against its plain version, bit for bit
    (tolerance 0: both copy the rows' bytes), at the training shape (the
    llama3-8b table, 128256 x 4096 bf16, and the 4096 ids of one
    ``SyntheticLMStream`` step, 8 x 512 tokens), at N = 1 (the
    unfissioned per-microbatch form is N = 1024; N = 1 is the fission
    phase's per-iteration query), at 16 steps' ids (N = 65536, an output
    the L2 cannot hold) and at ragged shapes that take the scalar path.
    The plain version is one library call (``index_select``) and a
    reshape, so plain_ms and library_ms time the same function."""
    import torch
    from repro_torch.data.pipeline import SyntheticLMStream
    from repro_torch.kernels.batched_gather.ops import batched_gather_cuda
    from repro_torch.kernels.batched_gather.ref import gather_ref

    def check(label, table, ids):
        got = batched_gather_cuda(table, ids)
        torch.cuda.synchronize()
        want = gather_ref(table, ids)
        same = (got.shape == want.shape and got.dtype == want.dtype
                and torch.equal(got, want))
        err = float((got.float() - want.float()).abs().max()) if same else float("nan")
        log(f"[kernels] batched_gather {label}: max_abs_err {err!r} (tolerance 0: "
            f"bit-exact) {'ok' if same else 'MISMATCH'}")
        if not same:
            fail(f"batched_gather {label}: kernel differs from its plain version")
        return err

    V, D = 128256, 4096
    table = torch.randn((V, D), generator=gen, device="cuda").to(torch.bfloat16)
    toks = SyntheticLMStream(V, seq_len=512, batch=8, seed=0).batch_at(0)["tokens"]
    ids = torch.as_tensor(toks.reshape(-1), device="cuda")
    err = check(f"bf16 V={V} D={D} N={ids.numel()} (training step)", table, ids)
    check("bf16 N=1", table, ids[:1])
    check("bf16 int64 ids (8, 512)", table, ids.long().reshape(8, 512))
    for (v, d, n, dtype) in ((1000, 8, 7, torch.float32), (1000, 64, 4095, torch.float32),
                             (977, 7, 33, torch.bfloat16), (64, 3, 1, torch.float32)):
        small = torch.randn((v, d), generator=gen, device="cuda").to(dtype)
        sid = torch.randint(0, v, (n,), generator=gen, device="cuda", dtype=torch.int32)
        check(f"{str(dtype)[6:]} ragged V={v} D={d} N={n}", small, sid)

    def timed(idx):
        # The stream's ids are Zipf-distributed (348 distinct among one
        # step's 4096): a row is read from device memory once and from L2
        # after, so the bound counts each distinct row read once, every
        # output row written once, and the ids.
        n, distinct = idx.numel(), int(torch.unique(idx).numel())
        bound, by = _bound((distinct + n) * D * 2 + 4 * n, 0)
        return dict(ms=timer.ms(lambda: batched_gather_cuda(table, idx)),
                    plain_ms=timer.ms(lambda: gather_ref(table, idx)),
                    bound_ms=bound, bound_by=by,
                    library_ms=timer.ms(lambda: torch.index_select(table, 0, idx)))

    one = timed(ids[:1])
    log(f"[kernels] batched_gather N=1 (one query per iteration): {one}")
    row = dict(route="cuda", source="src/repro_torch/csrc/batched_gather.cu",
               replaces="src/repro/kernels/batched_gather/kernel.py:72", max_abs_err=err,
               **timed(ids))
    log(f"[kernels] batched_gather N={ids.numel()} (library_ms: index_select, which is "
        f"also the plain version): {row}")
    log(f"[kernels] batched_gather N={ids.numel()}: {int(torch.unique(ids).numel())} "
        f"distinct rows; ms / bound {row['ms'] / row['bound_ms']!r}; bound / ms "
        f"{row['bound_ms'] / row['ms']!r}")
    # The step's 33.6 MB output fits in the 50 MB L2, whose write-back may
    # outlast the end event; 16 steps' ids write 537 MB, which it cannot hold.
    many = torch.as_tensor(np.concatenate([
        SyntheticLMStream(V, seq_len=512, batch=8, seed=0).batch_at(k)["tokens"].reshape(-1)
        for k in range(16)]), device="cuda")
    check(f"bf16 N={many.numel()} (16 steps' ids)", table, many)
    big = timed(many)
    log(f"[kernels] batched_gather N={many.numel()} (output beyond L2, "
        f"{int(torch.unique(many).numel())} distinct rows): {big}; "
        f"ms / bound {big['ms'] / big['bound_ms']!r}")
    del many
    del table
    torch.cuda.synchronize()
    return row


# ----------------------------------------------------------------- phase 4
def _requests(Request, vocab: int, n: int = 16, max_new: int = 32):
    rng = np.random.default_rng(0)
    lens = rng.integers(32, 201, size=n)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=int(m)).astype(np.int32),
                    max_new_tokens=max_new) for i, m in enumerate(lens)]


def _async_requests(Request, vocab: int, max_new: int = 32):
    """13 prompts of 32-200 tokens (template "chat") and 3 of 320-448
    (template "long", longer than max_prompt_len 256: only chunked prefill
    serves them whole), interleaved, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    lens = [int(n) for n in rng.integers(32, 201, size=13)]
    for at, n in zip((2, 7, 11), rng.integers(320, 449, size=3)):
        lens.insert(at, -int(n))
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=abs(m)).astype(np.int32),
                    max_new_tokens=max_new, template="long" if m < 0 else "chat")
            for i, m in enumerate(lens)]


# Each serving run's streams, launches, wall and tokens by label, for
# phase 4s's comparison of the graphed runs with their eager() twins.
RUNS: dict = {}


def _calls(eng) -> tuple[int, int, int]:
    """(tick calls, chunk-step calls, prefill-step calls) of an engine's
    compiled dispatches on the card outside ``graphs.eager()`` so far
    (``serving/graphs.py``)."""
    return (eng._tick_step.calls, sum(s.calls for s in eng._chunk_steps.values()),
            eng._prefill_steps.calls)


def _replays(eng) -> tuple[int, int, int]:
    """The same calls' replays: a step's calls but its first."""
    return (eng._tick_step.replays, sum(s.replays for s in eng._chunk_steps.values()),
            eng._prefill_steps.replays)


def _expect_first_call_runs(label, steps, device) -> None:
    """On the card outside ``graphs.eager()``: each compiled step called so
    far ran its first call for real, once, and replayed every later call
    (``serving/graphs.py``: the first call is the dispatch itself)."""
    from repro_torch.serving import graphs
    if device != "cuda" or graphs.is_eager():
        return
    bad = [(s.calls, s.replays) for s in steps if s.calls - s.replays != min(s.calls, 1)]
    if bad:
        fail(f"{label}: compiled steps with (calls, replays) {bad}: not one real run each "
             "and replays after it")


def _steps_of(eng) -> list:
    """An engine's compiled steps: its tick, chunk steps and prefill steps."""
    return [eng._tick_step, *eng._chunk_steps.values(), *eng._prefill_steps.steps.values()]


def _prefill_counter(eng):
    """Count ``eng``'s prefill dispatches from now on (``_prefill_step``
    calls) beside its prefill-step calls so far, for
    ``_expect_prefill_calls``."""
    return _count_calls(eng, "_prefill_step"), eng._prefill_steps.calls


def _expect_prefill_calls(label, eng, counter, device) -> int:
    """On the card outside ``graphs.eager()``: every prefill dispatch since
    ``counter`` was one call of a compiled prefill step, each step's first
    a real run and the others replays.  Returns the calls."""
    from repro_torch.serving import graphs
    box, calls0 = counter
    got = eng._prefill_steps.calls - calls0
    if device == "cuda" and not graphs.is_eager() and got != box[0]:
        fail(f"{label}: {got} prefill-step calls for {box[0]} prefill dispatches")
    _expect_first_call_runs(label, eng._prefill_steps.steps.values(), device)
    return got


def _drive(label, eng, sched, reqs, device):
    """Submit ``reqs`` at once and drain them, with every launch count set
    to 0 just before and read just after.  Checks that each request got
    its tokens, all in the vocabulary, and, on the card outside
    ``graphs.eager()``, that every decode tick was one replay of the
    engine's tick step (its first call a real run, the others replays);
    logs tokens/s, TTFT, the counters and the graph replays.  Returns
    (launch counts, wall seconds)."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.serving import graphs

    vocab = eng.arch.cfg.vocab_size
    graphed = device == "cuda" and not graphs.is_eager()
    prefills = _prefill_counter(eng)
    calls0, replays0, steps0 = _calls(eng), _replays(eng), eng.decode_steps
    called0 = {id(s) for s in _steps_of(eng) if s.calls}
    _sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        r.metrics.arrival = t0
        sched.submit(r)
    sched.producer_done()
    sched.run_until_drained()
    _sync(device)
    wall = time.perf_counter() - t0
    launches = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    calls = tuple(b - a for a, b in zip(calls0, _calls(eng)))
    replays = tuple(b - a for a, b in zip(replays0, _replays(eng)))
    for r in reqs:
        if (len(r.generated) != r.max_new_tokens
                or not all(0 <= t < vocab for t in r.generated)):
            fail(f"{label}: request {r.rid}: {len(r.generated)} tokens, not "
                 f"{r.max_new_tokens} in-vocab tokens")
    ttft = sorted(r.metrics.ttft for r in reqs)
    n_tok = sum(len(r.generated) for r in reqs)
    log(f"[{label}] prompt lengths {[len(r.prompt) for r in reqs]}")
    log(f"[{label}] launches {launches}; decode_steps {eng.decode_steps}, "
        f"dispatches {eng.dispatches}, prefill_calls {eng.prefill_calls}, "
        f"scheduler ticks {sched.stats.decode_ticks}; compiled-step calls (replays): tick "
        f"{calls[0]} ({replays[0]}), chunk step {calls[1]} ({replays[1]}), prefill step "
        f"{calls[2]} ({replays[2]}) for {prefills[0][0]} prefill dispatches over "
        f"{len(eng._prefill_steps.steps)} buckets ({'graphs' if graphed else 'eager'})")
    log(f"[{label}] {len(reqs)} requests, {n_tok} tokens in {wall!r} s: "
        f"{n_tok / wall!r} tokens/s; TTFT p50 {float(np.median(ttft)) * 1e3!r} ms, "
        f"max {ttft[-1] * 1e3!r} ms; decode ticks {eng.decode_steps}; "
        f"dispatches {eng.dispatches}; peak memory {peak / 2**30!r} GiB")
    log(f"[{label}] admission trace {sched.stats.admission_trace}")
    firsts = [(name, {k: round(v * 1e3, 3) for k, v in s.parts.items()})
              for name, s in [("tick", eng._tick_step)]
              + [(f"chunk {i}", c) for i, c in enumerate(eng._chunk_steps.values())]
              + [(f"prefill {k}", c) for k, c in eng._prefill_steps.steps.items()]
              if s.calls and id(s) not in called0]
    if firsts:
        log(f"[{label}] first calls in this drive, host ms (the real run's issue, the "
            f"recording, the instantiation): {firsts}")
    if graphed and calls[0] != eng.decode_steps - steps0:
        fail(f"{label}: {calls[0]} tick-step calls for {eng.decode_steps - steps0} decode "
             "ticks")
    _expect_prefill_calls(label, eng, prefills, device)
    _expect_first_call_runs(label, _steps_of(eng), device)
    RUNS[label] = dict(streams=[list(r.generated) for r in reqs], launches=launches,
                       wall=wall, tokens=n_tok, chunk_calls=calls[1],
                       first=sum(c - r for c, r in zip(calls, replays)))
    return launches, wall


def _expect_chunk_calls(label, fed: int, device) -> None:
    """On the card outside ``graphs.eager()``: each token fed through
    ``_extend`` was one call of a compiled chunk step."""
    from repro_torch.serving import graphs
    got = RUNS[label]["chunk_calls"]
    if device == "cuda" and not graphs.is_eager() and got != fed:
        fail(f"{label}: {got} chunk-step calls for {fed} tokens fed through _extend")


def _expect(label, launches, want: dict) -> None:
    """Exact launch counts: ``want`` maps op name → expected count; each
    listed op of the path must have launched at least once."""
    for name, n in want.items():
        if launches[name] != n:
            fail(f"{label}: {name} launched {launches[name]} times, expected {n}")
    if not all(launches[name] > 0 for name, n in want.items() if n):
        fail(f"{label}: a kernel of the path never launched")


def phase_main_path(arch, params, device="cuda", label="main", n: int = 16,
                    max_new: int = 32, drives: int = 1):
    """The synchronous path: ``overlap=False``, paged engine, ``n``
    requests of ``max_new`` tokens, driven ``drives`` times on one engine
    (a new scheduler and the same prompts each time: the first drive on a
    fresh engine, the later ones, labelled ``-warm1``, ..., on a warmed
    one).  Returns the first drive's launch counts."""
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    L = arch.cfg.n_layers
    t0 = time.perf_counter()
    eng = PagedInferenceEngine(arch, params, n_lanes=8, max_prompt_len=256,
                               max_len=512, page_size=16, device=device)
    _sync(device)
    log(f"[{label}] the engine built in {time.perf_counter() - t0!r} s")
    first = None
    for i in range(drives):
        lab = label if i == 0 else f"{label}-warm{i}"
        sched = ContinuousBatchingScheduler(
            eng, strategy=GrowingUpperThreshold(initial_upper=2))
        d0, s0 = eng.dispatches, eng.decode_steps
        launches, _wall = _drive(lab, eng, sched,
                                 _requests(Request, arch.cfg.vocab_size, n, max_new), device)
        ticks = eng.decode_steps - s0
        prefills = eng.dispatches - d0 - ticks
        if ticks == 0 or prefills == 0:
            fail(f"{lab}: the path ran no decode step or no prefill")
        # One launch per layer per dispatch: decode ticks run the paged kernel,
        # prefill dispatches the flash kernel; nothing runs the dense decode.
        _expect(lab, launches, {"paged_decode_attention": ticks * L,
                                "flash_attention": prefills * L,
                                "decode_attention": 0, "ssd_scan": 0})
        first = launches if first is None else first
    _sync(device)
    return first


def _count_calls(eng, name: str, weight=lambda *a: 1):
    """Wrap ``eng.<name>`` to count its calls (thread-safe); the count is
    in the returned list.  Instrumentation of this script only."""
    import threading
    inner, lock, box = getattr(eng, name), threading.Lock(), [0]

    def counted(*args):
        with lock:
            box[0] += weight(*args)
        return inner(*args)

    setattr(eng, name, counted)
    return box


def phase_async(arch, params, device="cuda", chunk: int = 256, label="async",
                drives: int = 1):
    """The paper's asynchronous path: ``overlap=True`` (prefills
    dispatched on the speculation thread, on the engine's own stream,
    while the main thread decodes), ``chunk_tokens`` (prompts longer than
    a chunk prefill their first chunk and feed the rest through the
    dense decode path, ``decode_attention``), and the paged engine's
    fused ticks (a chunk folded into the decode dispatch).  No fault
    domain: a speculation-thread exception re-raises.  ``drives`` as in
    ``phase_main_path``; returns the first drive's launch counts and
    wall."""
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    L = arch.cfg.n_layers
    t0 = time.perf_counter()
    eng = PagedInferenceEngine(arch, params, n_lanes=8, max_prompt_len=256,
                               max_len=512, page_size=16, device=device)
    _sync(device)
    log(f"[{label}] the engine built in {time.perf_counter() - t0!r} s")
    n_prefill = _count_calls(eng, "_prefill_step")
    n_extend = _count_calls(eng, "_extend")
    # Tokens fed through the decode path: each is one decode_step, one
    # decode_attention launch per layer (chunks are batch 1).
    fed = _count_calls(eng, "_extend", lambda _c, toks, _l: int(toks.shape[1]))
    first = None
    for i in range(drives):
        lab = label if i == 0 else f"{label}-warm{i}"
        sched = ContinuousBatchingScheduler(
            eng, strategy=GrowingUpperThreshold(initial_upper=2), overlap=True,
            chunk_tokens=chunk)
        c0 = (n_prefill[0], n_extend[0], fed[0], eng.dispatches, eng.decode_steps,
              eng.fused_folds)
        reqs = _async_requests(Request, arch.cfg.vocab_size)
        launches, wall = _drive(lab, eng, sched, reqs, device)
        pre, ext, tok, disp, ticks, folds = (b - a for a, b in zip(c0, (
            n_prefill[0], n_extend[0], fed[0], eng.dispatches, eng.decode_steps,
            eng.fused_folds)))
        st = sched.stats
        whole = sum(max(0, min(len(r.prompt), eng.max_len - 1) - chunk) for r in reqs)
        log(f"[{lab}] spec_dispatched {st.spec_dispatched}, spec_committed "
            f"{st.spec_committed}, spec_aborted {st.spec_aborted}, spec_chunks "
            f"{st.spec_chunks}, spec_crashes {st.spec_crashes}, fused_folds {folds}; "
            f"prefill dispatches {pre}, chunk extends {ext}, tokens through the decode "
            f"path {tok} (the long prompts past their first chunk: {whole})")
        if st.spec_crashes != 0 or st.spec_chunks < 2 or folds < 1:
            fail(f"{lab}: need spec_crashes == 0, spec_chunks >= 2, fused_folds >= 1")
        if tok < whole:
            fail(f"{lab}: the long prompts were not fed whole through the chunks")
        if disp != pre + ext + ticks - folds:
            fail(f"{lab}: dispatches != prefills + extends + ticks - fused folds")
        _expect(lab, launches, {"paged_decode_attention": ticks * L,
                                "flash_attention": pre * L,
                                "decode_attention": tok * L, "ssd_scan": 0})
        _expect_chunk_calls(lab, tok, device)
        first = (launches, wall) if first is None else first
    _sync(device)
    return first


def phase_dense(arch, params, device="cuda", label="dense"):
    """The dense engine as a second entry point: phase 4's requests, each
    decode tick one ``decode_step`` over the stacked lane cache."""
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    L = arch.cfg.n_layers
    eng = InferenceEngine(arch, params, n_lanes=8, max_prompt_len=256, max_len=512,
                          device=device)
    sched = ContinuousBatchingScheduler(
        eng, strategy=GrowingUpperThreshold(initial_upper=2))
    launches, _wall = _drive(label, eng, sched, _requests(Request, arch.cfg.vocab_size),
                             device)
    _expect(label, launches, {"decode_attention": eng.decode_steps * L,
                                "flash_attention": (eng.dispatches - eng.decode_steps) * L,
                                "paged_decode_attention": 0, "ssd_scan": 0})
    _sync(device)
    return launches


def _prefix_requests(Request, vocab: int, n: int = 16, max_new: int = 32):
    """``n`` prompts: one common 192-token prefix (12 pages of 16, a
    shared system prompt) and a tail of 8-40 tokens each, from
    ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab, size=192)
    tails = rng.integers(8, 41, size=n)
    return [Request(rid=i, prompt=np.concatenate(
                [prefix, rng.integers(0, vocab, size=int(t))]).astype(np.int32),
                    max_new_tokens=max_new) for i, t in enumerate(tails)]


def _ttft_ms(reqs) -> str:
    if not reqs:
        return "none"
    ttft = sorted(r.metrics.ttft * 1e3 for r in reqs)
    return f"p50 {float(np.median(ttft))!r} ms, max {ttft[-1]!r} ms ({len(reqs)} requests)"


def phase_prefix(arch, params, device="cuda", suffix: str = "", drives: int = 1):
    """A chat service whose requests share one system prompt: the paged
    engine with ``prefix_share=True`` on the synchronous path.  The first
    request prefills whole (flash); every later one aliases the 12
    resident prefix pages and feeds only its tail through ``_shared_tail``
    (one ``decode_step``, so one ``decode_attention`` launch a layer, per
    tail token).  The same traffic then runs unshared.  ``drives`` as in
    ``phase_main_path`` (a warmed sharing engine may hold the prefix
    already).  Returns the two runs' first drives' launch counts."""
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    L = arch.cfg.n_layers
    out, streams, moved = {}, {}, {}
    for label, share in (("prefix" + suffix, True), ("prefix-unshared" + suffix, False)):
        eng = PagedInferenceEngine(arch, params, n_lanes=8, max_prompt_len=256, max_len=512,
                                   page_size=16, prefix_share=share, device=device)
        n_prefill = _count_calls(eng, "_prefill_step")
        hit_rids = []
        _count_calls(eng, "_admit_prefix_hit", lambda r, *_a: hit_rids.append(r.rid) or 1)
        tail = _count_calls(eng, "_shared_tail", lambda _i, toks, *_r: int(toks.shape[1]))
        for i in range(drives):
            lab = label if i == 0 else f"{label}-warm{i}"
            sched = ContinuousBatchingScheduler(
                eng, strategy=GrowingUpperThreshold(initial_upper=2))
            c0 = (n_prefill[0], tail[0], eng.prefix_hits, eng.kv_bytes_moved,
                  eng.dispatches, eng.decode_steps, eng.prefill_flops_saved,
                  eng.prefill_flops_total)
            del hit_rids[:]
            reqs = _prefix_requests(Request, arch.cfg.vocab_size)
            launches, wall = _drive(lab, eng, sched, reqs, device)
            pre, toks, hits_n, kv, disp, ticks, saved, total = (b - a for a, b in zip(c0, (
                n_prefill[0], tail[0], eng.prefix_hits, eng.kv_bytes_moved,
                eng.dispatches, eng.decode_steps, eng.prefill_flops_saved,
                eng.prefill_flops_total)))
            hits = [r for r in reqs if r.rid in hit_rids]
            misses = [r for r in reqs if r.rid not in hit_rids]
            log(f"[{lab}] prefix_hits {hits_n} (scheduler {sched.stats.prefix_hits}), "
                f"prefill_flops_saved / prefill_flops_total {saved} / {total} = "
                f"{saved / max(1, total)!r}; kv_bytes_moved {kv}; prefill dispatches {pre}, "
                f"tail tokens through _shared_tail {toks}; TTFT hits {_ttft_ms(hits)}, "
                f"misses {_ttft_ms(misses)}")
            if disp != pre + hits_n + ticks:
                fail(f"{lab}: dispatches != prefills + prefix hits + decode ticks")
            _expect(lab, launches, {"flash_attention": pre * L,
                                    "decode_attention": toks * L,
                                    "paged_decode_attention": ticks * L,
                                    "ssd_scan": 0})
            _expect_chunk_calls(lab, toks, device)
            # the scheduler mirrors the engine's running count
            if share and (hits_n < 1 or sched.stats.prefix_hits != eng.prefix_hits):
                fail("prefix: no prefix hit, or the scheduler's count differs from the "
                     "engine's")
            if i == 0:
                out[label], streams[label], moved[label] = (
                    launches, [r.generated for r in reqs], kv)
    if moved["prefix" + suffix] >= moved["prefix-unshared" + suffix]:
        fail("prefix: sharing did not move fewer KV bytes than the unshared run")
    a, b = streams["prefix" + suffix], streams["prefix-unshared" + suffix]
    log(f"[prefix] against the unshared run: first tokens equal in "
        f"{sum(x[0] == y[0] for x, y in zip(a, b))}/{len(a)} requests, whole streams in "
        f"{sum(x == y for x, y in zip(a, b))}/{len(a)} (bf16: near-ties may differ; not "
        f"gated); kv_bytes_moved {moved['prefix' + suffix]} against "
        f"{moved['prefix-unshared' + suffix]}")
    _sync(device)
    return out


WARM_DRIVES = 1  # 4a, 4b, 4d, 4s: a warmed engine's drives after its first (2 until PR 26)
TWIN_LAYERS = 2  # 4s's depth: llama3-8b at full width, 2 of its 32 layers


def _first_layers(arch, params, n: int):
    """``arch`` cut to its first ``n`` layers at full width, and views of
    those layers of ``params`` (stacked on a leading layer axis)."""
    cut = dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg, n_layers=n))
    return cut, dict(params, layers=_map_leaves(lambda a: a[:n], params["layers"]))


def phase_graph_twins(arch, params, device="cuda"):
    """4s. The compiled dispatches against their ``graphs.eager()`` twins
    (the counterpart of ``jax.disable_jit``: every step runs as plain ops
    on its static buffers), on a fresh engine and on a warmed one: main,
    async and prefix (4a, 4b, 4d) on llama3-8b at full width cut to
    ``TWIN_LAYERS`` of 32 layers (the eager twins' host time grows with
    the depth), one engine each driven ``1 + WARM_DRIVES`` times (a new
    scheduler, the same prompts), with graphs and then eagerly.  Each
    drive is held to its ``eager()`` twin: the same greedy tokens and the
    same exact launch counts (each step's first call runs and counts its
    launches, every replay counts its kernels).  Logs each drive's wall
    and tokens/s, the fresh and warmed tokens/s of both, apart, and one
    fresh main drive eagerly at full depth beside 4a's."""
    from repro_torch.serving import graphs

    cut, cut_params = _first_layers(arch, params, TWIN_LAYERS)
    kw = dict(drives=1 + WARM_DRIVES)
    tag = f"-{TWIN_LAYERS}L"
    for mode in ("", "-eager"):
        with graphs.eager() if mode else contextlib.nullcontext():
            phase_main_path(cut, cut_params, device, label="main" + tag + mode, **kw)
            phase_async(cut, cut_params, device, label="async" + tag + mode, **kw)
            phase_prefix(cut, cut_params, device, suffix=tag + mode, **kw)
    with graphs.eager():
        phase_main_path(arch, params, device, label="main-eager")
    warm = [""] + [f"-warm{i}" for i in range(1, 1 + WARM_DRIVES)]
    pairs = [(path + tag + w, path + tag + "-eager" + w)
             for path in ("main", "async", "prefix", "prefix-unshared") for w in warm]
    for label, twin in pairs + [("main", "main-eager")]:
        g, e = RUNS[label], RUNS[twin]
        same = sum(a == b for a, b in zip(g["streams"], e["streams"]))
        log(f"[graphs] {label}: graphs {g['tokens']} tokens in {g['wall']!r} s "
            f"({g['tokens'] / g['wall']!r} tokens/s; {g['first']} first calls run for "
            f"real), eager() {e['tokens']} tokens in {e['wall']!r} s "
            f"({e['tokens'] / e['wall']!r} tokens/s): wall ratio {e['wall'] / g['wall']!r}; "
            f"greedy streams equal in {same}/{len(g['streams'])}, launch counts "
            f"{'equal' if g['launches'] == e['launches'] else 'DIFFER'}")
        if same != len(g["streams"]) or g["tokens"] != e["tokens"]:
            fail(f"graphs: {label}'s greedy tokens differ from its eager() twin's")
        if g["launches"] != e["launches"]:
            fail(f"graphs: {label}'s launch counts {g['launches']} differ from its eager() "
                 f"twin's {e['launches']}")
    for path in ("main", "async", "prefix", "prefix-unshared"):
        for depth, base in ((arch.cfg.n_layers, path), (TWIN_LAYERS, path + tag)):
            tps = {m: [RUNS[base + m + w]["tokens"] / RUNS[base + m + w]["wall"]
                       for w in warm if base + m + w in RUNS] for m in ("", "-eager")}
            log(f"[graphs] {path}, {depth} layers: tokens/s, fresh engine / warmed (drives "
                f"2-{1 + WARM_DRIVES}, median): graphs {tps[''][0]!r} / "
                f"{float(np.median(tps[''][1:]))!r}"
                + (f", eager() {tps['-eager'][0]!r} / "
                   f"{float(np.median(tps['-eager'][1:]))!r}" if len(tps["-eager"]) > 1
                   else ""))
    _sync(device)


def phase_spill(arch, params, device="cuda", n_pages: int = 128):
    """Long generations that outgrow an oversubscribed pool: 128 pages,
    half of full provisioning, a host spill pool of 16 entries, and phase
    4's prompts with 160 new tokens each (a lane grows to about 23
    pages).  Growth evicts the least-recently-touched lane to the host;
    the scheduler re-queues it and its restore resumes it.  The same
    traffic then runs at full provisioning with no spill pool, and the
    greedy streams must be equal token for token (evict/restore = no
    evict).  Both runs admit one request a prefill (``PureAsync``), so
    every prompt is prefilled at the same shape in both: bf16 matrix
    products of different batch shapes may round differently, and random
    weights have near-ties.  Returns the two runs' launch counts."""
    from repro_torch.core.strategies import PureAsync
    from repro_torch.serving.engine import HostSpillPool
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    L = arch.cfg.n_layers
    out, streams = {}, {}
    for label, kw in (("spill", dict(n_pages=n_pages, kv_spill=HostSpillPool(16),
                                     prefetch_pages=2)),
                      ("spill-full", {})):
        eng = PagedInferenceEngine(arch, params, n_lanes=8, max_prompt_len=256, max_len=512,
                                   page_size=16, device=device, **kw)
        sched = ContinuousBatchingScheduler(eng, strategy=PureAsync())
        n_prefill = _count_calls(eng, "_prefill_step")
        moved = {"spilled": 0, "restored": 0}
        if eng.kv_spill is not None:
            put = eng.kv_spill.put

            def counted_put(key, template, entry):
                moved["spilled"] += sum(t.element_size() * t.numel()
                                        for t in _leaves(entry["rows"]))
                return put(key, template, entry)

            eng.kv_spill.put = counted_put
            write = eng._write_rows

            def counted_write(*args, **kwargs):
                before = eng.kv_bytes_moved
                write(*args, **kwargs)
                moved["restored"] += eng.kv_bytes_moved - before

            eng._write_rows = counted_write
        reqs = _requests(Request, arch.cfg.vocab_size, max_new=160)
        out[label], wall = _drive(label, eng, sched, reqs, device)
        streams[label] = [r.generated for r in reqs]
        st = sched.stats
        log(f"[{label}] n_pages {eng.n_pages} ({eng.n_lanes * eng.pages_per_lane} at full "
            f"provisioning); page_evictions {eng.page_evictions}, kv_spilled "
            f"{st.kv_spilled}, kv_restored {st.kv_restored}; bytes to the host "
            f"{moved['spilled']}, back to the card {moved['restored']}; kv_bytes_moved "
            f"{eng.kv_bytes_moved}; prefill dispatches {n_prefill[0]}")
        _expect(label, out[label], {"paged_decode_attention": eng.decode_steps * L,
                                    "flash_attention": n_prefill[0] * L,
                                    "decode_attention": 0, "ssd_scan": 0})
        if label == "spill" and not (eng.page_evictions >= 1
                                     and st.kv_restored == st.kv_spilled >= 1):
            fail("spill: need page_evictions >= 1 and kv_restored == kv_spilled >= 1")
    same = sum(a == b for a, b in zip(streams["spill"], streams["spill-full"]))
    log(f"[spill] greedy streams equal to the full-provisioning run in "
        f"{same}/{len(streams['spill'])} requests")
    if same != len(streams["spill"]):
        fail("spill: evict/restore changed a greedy stream")
    _sync(device)
    return out


# ------------------------------------------------- phase 4i-k: the paper's layer
class _Recorder:
    """A query-service facade logging each query's result by its identity
    (instrumentation of this script only)."""

    def __init__(self, svc):
        self.svc = svc
        self.log = {}

    def execute(self, query_name, params):
        out = self.svc.execute(query_name, params)
        self.log[(query_name, tuple(int(p) for p in params))] = out
        return out

    def execute_batch(self, query_name, params_list):
        outs = self.svc.execute_batch(query_name, params_list)
        for p, o in zip(params_list, outs):
            self.log[(query_name, tuple(int(x) for x in p))] = o
        return outs


def _trace_sides(arch, params, device, trace, engine_kw):
    """One app trace the reference's Part 10 way: the synchronous program
    on ``Interpreter`` through ``SchedulerQueryService`` (one scheduler
    drive per query), then ``transform_program``'s output on
    ``AsyncQueryRuntime(n_threads=4, PureBatch())`` (one drive per cohort),
    each over a fresh ``PagedInferenceEngine`` of the same geometry.
    Returns per side: observables, per-query token tuples, drives, tokens,
    wall seconds, prefill dispatches and decode ticks."""
    from repro_torch.core.hir import Interpreter, transform_program
    from repro_torch.core.runtime import AsyncQueryRuntime
    from repro_torch.core.strategies import PureBatch
    from repro_torch.serving.hir_bridge import SchedulerQueryService
    from repro_torch.serving.paged_kv import PagedInferenceEngine

    out = {}
    for side in ("sync", "async"):
        eng = PagedInferenceEngine(arch, params, device=device, **engine_kw)
        svc = _Recorder(SchedulerQueryService(eng))  # max_new_tokens=4, the default
        _sync(device)
        t0 = time.perf_counter()
        if side == "sync":
            env = Interpreter(svc).run(trace.program, dict(trace.inputs))
        else:
            rt = AsyncQueryRuntime(svc, n_threads=4, strategy=PureBatch())
            try:
                env = Interpreter(rt).run(transform_program(trace.program),
                                          dict(trace.inputs))
            finally:
                rt.drain()
                rt.shutdown()
        _sync(device)
        st = svc.svc.stats
        out[side] = dict(observe={k: env.get(k) for k in trace.observe}, log=svc.log,
                         drives=st.round_trips, tokens=st.tokens,
                         wall=time.perf_counter() - t0,
                         prefills=eng.dispatches - eng.decode_steps,
                         ticks=eng.decode_steps,
                         prefill_calls=eng._prefill_steps.calls,
                         first_runs=len(eng._prefill_steps.steps))
    return out


def _batch_shape_probe(arch, params, device, sizes=(2, 4, 8)):
    """Whether a prompt's prefill logits depend on the batch it is in, at
    the bridge's prompt shapes: prompts of 2 and 3 tokens (one and two
    query parameters; padded to 2 and 4 positions) prefilled in batches of
    ``sizes`` and each alone.  Returns ({(prompt tokens, batch): (largest
    |logit difference| against alone, rows whose argmax differs)}, the
    largest |logit|)."""
    import torch
    from repro_torch.models import transformer as _tf

    rng = np.random.default_rng(0)
    n, out, top = max(sizes), {}, 0.0
    for plen, width in ((2, 2), (3, 4)):
        toks = np.zeros((n, width), np.int32)
        toks[:, 0] = plen - 1
        toks[:, 1:plen] = rng.integers(0, min(arch.cfg.vocab_size, 50021), size=(n, plen - 1))
        batch = torch.as_tensor(toks, device=device)

        def last(rows):
            return _tf.prefill(arch.cfg, params, rows, return_all_logits=True)[0][:, plen - 1]

        with torch.no_grad():
            alone = torch.cat([last(batch[i:i + 1]) for i in range(n)]).float()
            top = max(top, float(alone.abs().max()))
            for b in sizes:
                together = last(batch[:b]).float()
                out[plen, b] = (float((together - alone[:b]).abs().max()),
                                int((together.argmax(-1) != alone[:b].argmax(-1)).sum()))
    return out, top


def _cohort_probe(arch, params, device, kw):
    """The bridge's two prompt shapes (2 and 3 tokens) as 8 queries of one
    template, admitted as one cohort and each alone (as the synchronous
    side does), 3 decode ticks each: how many first tokens and whole
    streams agree.  Returns {prompt tokens: (first tokens equal, streams
    equal)}."""
    from repro_torch.serving.hir_bridge import _prompt_for
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request

    out = {}
    for n_params in (1, 2):
        prompts = [_prompt_for("q", tuple(range(k, k + n_params)))
                   for k in (3, 17, 250, 4093, 777, 12, 9001, 42)]
        runs = []
        for groups in ([list(range(8))], [[i] for i in range(8)]):
            eng = PagedInferenceEngine(arch, params, device=device, **kw)
            reqs = [Request(rid=i, prompt=p, max_new_tokens=4, template="q")
                    for i, p in enumerate(prompts)]
            for g in groups:
                eng.admit([reqs[i] for i in g], template="q")
                for _ in range(3):
                    tick = eng.decode_tick()
                    for i in g:
                        reqs[i].generated.append(tick[reqs[i].lane])
                for i in g:
                    eng.retire(reqs[i].lane)
            runs.append([r.generated for r in reqs])
        out[n_params + 1] = (sum(a[0] == b[0] for a, b in zip(*runs)),
                             sum(a == b for a, b in zip(*runs)))
    return out


def phase_app_traces(arch, params, device="cuda"):
    """The paper's Part 10 on the real engine: the three app traces of
    ``core/app_traces.py`` (admin workflow 8+1 queries, user flow 5 x
    (1+4), RAG pipeline 6+8+1), synchronous against transformed, through
    the HIR → scheduler bridge on ``PagedInferenceEngine(n_lanes=8,
    page_size=16)``, 4 new tokens a query.  Gates: 49 synchronous drives
    (one per query), fewer transformed drives on every trace, 4
    in-vocabulary tokens a query, and exact launches (``flash_attention``
    = prefill dispatches x 32, ``paged_decode_attention`` = decode ticks
    x 32).  Equal observables across the sides are reported, not gated:
    the synchronous side prefills each query alone and the transformed
    side prefills cohorts, and in bf16 a prompt's logits may depend on
    the batch's shape.  Returns the launch counts."""
    import torch
    from repro_torch.core.app_traces import all_traces
    from repro_torch.kernels import registry

    L, vocab = arch.cfg.n_layers, arch.cfg.vocab_size
    kw = dict(n_lanes=8, max_prompt_len=16, max_len=32, page_size=16)
    _sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    registry.reset_launches()
    tot = {s: dict(drives=0, tokens=0, wall=0.0, prefills=0, ticks=0, prefill_calls=0,
                   first_runs=0)
           for s in ("sync", "async")}
    same_obs = same_toks = n_q = 0
    for tr in all_traces():
        res = _trace_sides(arch, params, device, tr, kw)
        s, a = res["sync"], res["async"]
        for side in ("sync", "async"):
            for k in tot[side]:
                tot[side][k] += res[side][k]
            for key, toks in res[side]["log"].items():
                if len(toks) != 4 or not all(0 <= t < vocab for t in toks):
                    fail(f"app-traces {tr.name} {side}: query {key} gave {toks}, not 4 "
                         f"in-vocabulary tokens")
        if s["drives"] != tr.n_queries:
            fail(f"app-traces {tr.name}: {s['drives']} synchronous drives, not "
                 f"{tr.n_queries}")
        if not a["drives"] < s["drives"]:
            fail(f"app-traces {tr.name}: the transformed program took {a['drives']} "
                 f"drives, not fewer than {s['drives']}")
        obs = s["observe"] == a["observe"]
        toks = sum(a["log"][k] == s["log"].get(k) for k in a["log"])
        same_obs += obs
        same_toks += toks
        n_q += len(a["log"])
        s_tps, a_tps = s["tokens"] / s["wall"], a["tokens"] / a["wall"]
        log(f"[app-traces] {tr.name}: sync {s['drives']} drives, {s['tokens']} tokens in "
            f"{s['wall']!r} s ({s_tps!r} tokens/s, {s['prefills']} prefill dispatches, "
            f"{s['ticks']} decode ticks); transformed {a['drives']} drives, {a['tokens']} "
            f"tokens in {a['wall']!r} s ({a_tps!r} tokens/s, {a['prefills']} prefill "
            f"dispatches, {a['ticks']} decode ticks); tokens/s ratio {a_tps / s_tps!r}, "
            f"drive ratio {a['drives'] / s['drives']!r}; observables "
            f"{'equal' if obs else 'DIFFER'} {s['observe']} / {a['observe']}; token "
            f"tuples equal in {toks}/{len(a['log'])} transformed queries")
    _sync(device)
    launches = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    s, a = tot["sync"], tot["async"]
    s_tps, a_tps = s["tokens"] / s["wall"], a["tokens"] / a["wall"]
    log(f"[app-traces] all three: sync {s['drives']} drives, {s['tokens']} tokens in "
        f"{s['wall']!r} s ({s_tps!r} tokens/s); transformed {a['drives']} drives, "
        f"{a['tokens']} tokens in {a['wall']!r} s ({a_tps!r} tokens/s); tokens/s ratio "
        f"{a_tps / s_tps!r}; drive ratio {a['drives'] / s['drives']!r}; observables equal "
        f"in {same_obs}/3 traces, token tuples in {same_toks}/{n_q} transformed queries "
        f"(bf16: reported, not gated); peak memory {peak / 2**30!r} GiB; launches "
        f"{launches}")
    probe, top = _batch_shape_probe(arch, params, device)
    log(f"[app-traces] batch shape: prompts of 2 and 3 tokens prefilled in batches of "
        f"2, 4 and 8 against each alone, (tokens, batch): (largest |logit difference|, "
        f"rows whose argmax differs) {probe}; largest |logit| {top!r}")
    log(f"[app-traces] cohort of 8 against each alone, 3 decode ticks, {{prompt tokens: "
        f"(first tokens equal, streams equal) of 8}}: {_cohort_probe(arch, params, device, kw)}")
    if s["drives"] != 49:
        fail(f"app-traces: {s['drives']} synchronous drives in all, not 49")
    log(f"[app-traces] prefill-step calls: sync {s['prefill_calls']} for "
        f"{s['prefills']} prefill dispatches ({s['first_runs']} of them first calls, run "
        f"for real), transformed {a['prefill_calls']} for {a['prefills']} "
        f"({a['first_runs']} first calls)")
    if device == "cuda" and any(t["prefill_calls"] != t["prefills"] for t in (s, a)):
        fail("app-traces: a prefill dispatch was not one call of a prefill step")
    _expect("app-traces", launches,
            {"paged_decode_attention": (s["ticks"] + a["ticks"]) * L,
             "flash_attention": (s["prefills"] + a["prefills"]) * L,
             "decode_attention": 0, "ssd_scan": 0})
    return launches


def _program_embed_score():
    """``tests/test_system.py``'s loop: ``s = embed.score(t)``, ``total +=
    float(s)``, ``log`` keeping each result in order."""
    from repro_torch.core.hir import Assign, Loop, Program, Query

    return Program(inputs=("items", "total", "log"), body=[
        Loop(item_var="t", iter_var="items", body=[
            Query(target="s", query_name="embed.score", params=("t",)),
            Assign(target="total", fn=lambda tot, s: tot + float(s), args=("total", "s")),
            Assign(target="log", fn=lambda lg, s: lg + (float(s),), args=("log", "s")),
        ])])


def _model_service_runs(table, w, ids, device):
    """The ML instantiation: ``ModelService`` whose query reads row ``t`` of
    an embedding table through ``batched_gather`` and scores it, ``(row.float()
    * w).sum()``, run three ways: synchronously through ``Interpreter``, then
    transformed (``overlap=True``) on ``AsyncQueryRuntime(n_threads=4,
    GrowingUpperThreshold(initial_upper=8, bt=3))``, then the same with
    ``pad_batches=True``.  The ids are 0-d int64 tensors on ``device``.
    Returns each run's total, results, service counters, lane buckets,
    ``batched_gather`` launches, compiled steps and their replays, and
    wall seconds."""
    import torch
    from repro_torch.core.hir import Interpreter, transform_program
    from repro_torch.core.runtime import AsyncQueryRuntime
    from repro_torch.core.services import ModelService
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.kernels import registry
    from repro_torch.kernels.batched_gather.ops import gather_op

    def batch_fn(t):
        return (gather_op(table, t).float() * w).sum(-1)

    def single_fn(t):
        return batch_fn(t[None])[0]

    items = list(torch.as_tensor(np.asarray(ids, np.int64), device=device).unbind(0))
    prog = _program_embed_score()
    out = {}
    for label in ("sync", "transformed", "transformed-padded"):
        svc = ModelService(single_fn, batch_fn, pad_batches=label.endswith("padded"))
        inputs = {"items": items, "total": 0.0, "log": ()}
        _sync(device)
        registry.reset_launches()
        t0 = time.perf_counter()
        if label == "sync":
            env = Interpreter(svc).run(prog, inputs)
        else:
            rt = AsyncQueryRuntime(svc, n_threads=4,
                                   strategy=GrowingUpperThreshold(initial_upper=8, bt=3))
            try:
                env = Interpreter(rt).run(transform_program(prog, overlap=True), inputs)
            finally:
                rt.drain()
                rt.shutdown()
        _sync(device)
        wall = time.perf_counter() - t0
        st = svc.stats.snapshot()
        out[label] = dict(total=env["total"], log=env["log"], wall=wall,
                          stats={k: v for k, v in st.items() if k != "busy_time"},
                          buckets=dict(svc.lane_buckets),
                          launches=registry.launch_counts()["batched_gather"],
                          steps=sum(len(c.steps) for c in svc.steps.values()),
                          calls=sum(c.calls for c in svc.steps.values()),
                          replays=sum(c.replays for c in svc.steps.values()))
        _expect_first_call_runs(f"model-service {label}",
                                [s for c in svc.steps.values() for s in c.steps.values()],
                                device)
    return out


def _model_service_gates(label, runs, n, device):
    from repro_torch.serving import graphs
    for name, r in runs.items():
        st = r["stats"]
        if device == "cuda" and not graphs.is_eager() and \
                r["calls"] != st["single_queries"] + st["batches"]:
            fail(f"{label} {name}: {r['calls']} step calls for {st['single_queries']} "
                 f"single queries and {st['batches']} batches")
        if st["single_queries"] + st["batched_items"] != n:
            fail(f"{label} {name}: {st['single_queries']} single queries + "
                 f"{st['batched_items']} batched items, not {n}")
        if name != "sync" and st["batches"] < 1:
            fail(f"{label} {name}: no batch was formed")
        want = st["single_queries"] + st["batches"] if device == "cuda" else 0
        if r["launches"] != want:
            fail(f"{label} {name}: batched_gather launched {r['launches']} times, "
                 f"expected {want}")
        tot = runs["sync"]["total"]
        if abs(r["total"] - tot) > 1e-5 * abs(tot):
            fail(f"{label} {name}: total {r['total']!r} differs from the synchronous "
                 f"{tot!r} beyond rtol 1e-5")


def phase_model_service(arch, params, device="cuda", n: int = 4096):
    """``ModelService`` on the card: the service's data is llama3-8b's
    embedding table (128256 x 4096 bf16), ``w`` a float32 (4096,) vector
    from ``torch.Generator`` seed 0, the program a loop over 4096 token ids
    from ``default_rng(0)``.  Every query reaches the card through the
    hand-written ``batched_gather``: one launch per single query and one
    per batch, exactly.  Gates: totals equal within rtol 1e-5, every id
    queried once (``single_queries + batched_items``), at least one batch
    on the transformed runs, every forward one call of a compiled step
    (each step's first a real run, the others replays);
    then the three runs again under ``graphs.eager()``, each total equal
    to its graphed twin's within rtol 1e-5.  Returns the summed launch
    counts."""
    import torch
    from repro_torch.serving import graphs

    table = params["embed"]["table"]
    V, D = table.shape
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    w = torch.randn(D, generator=gen).to(device)
    ids = np.random.default_rng(0).integers(0, V, n)
    runs = _model_service_runs(table, w, ids, device)
    with graphs.eager():
        twins = _model_service_runs(table, w, ids, device)
        _model_service_gates("model-service-eager", twins, n, device)
    scale = float(np.abs(np.asarray(runs["sync"]["log"])).sum())
    for name, r in runs.items():
        st = r["stats"]
        log(f"[model-service] {name}: {n} queries in {r['wall']!r} s; total "
            f"{r['total']!r} (sum of |s| {scale!r}); single queries "
            f"{st['single_queries']}, batches {st['batches']}, mean batch size "
            f"{st['batched_items'] / max(st['batches'], 1)!r}, lane_buckets "
            f"{r['buckets']}, padded_items {st['padded_items']}; batched_gather "
            f"launches {r['launches']}; {r['steps']} compiled steps, {r['calls']} calls, "
            f"{r['replays']} of them replays; under eager() {twins[name]['wall']!r} s, total "
            f"{twins[name]['total']!r}")
        tot = twins[name]["total"]
        if abs(r["total"] - tot) > 1e-5 * abs(tot):
            fail(f"model-service {name}: total {r['total']!r} differs from the eager() "
                 f"twin's {tot!r} beyond rtol 1e-5")
    log(f"[model-service] speed-up of the transformed program: "
        f"{runs['sync']['wall'] / runs['transformed']['wall']!r} "
        f"(padded {runs['sync']['wall'] / runs['transformed-padded']['wall']!r})")
    _model_service_gates("model-service", runs, n, device)
    zero = {"flash_attention": 0, "paged_decode_attention": 0, "decode_attention": 0,
            "ssd_scan": 0, "ssd_scan_bwd": 0}
    return dict(zero, batched_gather=sum(r["launches"] for r in runs.values()))


def _chaos_engine(arch, params, device, chaos, n_lanes, page_size, rates, max_len=512):
    """A paged engine with a host spill pool, wrapped in ``ChaosEngine``
    when ``chaos`` (``rates``: decode and prefill fault rates, seed
    ``chaos_seed(0)``); its prefill dispatches (``_prefill_step`` calls)
    are counted."""
    from repro_torch.core.faults import ChaosEngine, ChaosPlan, chaos_seed
    from repro_torch.serving.engine import HostSpillPool
    from repro_torch.serving.paged_kv import PagedInferenceEngine

    eng = PagedInferenceEngine(arch, params, n_lanes=n_lanes, max_prompt_len=max_len // 2,
                               max_len=max_len, page_size=page_size, device=device,
                               kv_spill=HostSpillPool(16))
    n_prefill = _count_calls(eng, "_prefill_step")
    if chaos:
        eng = ChaosEngine(eng, ChaosPlan(seed=chaos_seed(0), decode_fault_rate=rates[0],
                                         prefill_fault_rate=rates[1]))
    return eng, n_prefill


# Fault rates of the chaos phase.  Seed 0's prefill schedule draws its
# first fault at call 8 (hash 0.0998), so a 0.05 prefill rate would inject
# none over 16 admissions; 0.10 injects that one.
CHAOS_RATES = (0.05, 0.10)


def phase_chaos(arch, params, device="cuda"):
    """Degraded serving on the paged engine: the main path's 16 requests
    (32 new tokens) on ``PagedInferenceEngine(n_lanes=8, page_size=16,
    kv_spill=HostSpillPool(16))``, one request a prefill (``PureAsync``),
    fault-free, then with the engine inside ``ChaosEngine`` (seeded decode
    and prefill faults) and ``Resilience(quarantine_ticks=1)``: lane
    quarantine, KV salvage to the spill pool, requeue, restore and
    admission retry on real device state.  Gates: every request
    finishes, faults of both kinds injected, a lane quarantined, a prefill
    retried, every spill restored, streams equal to the fault-free run's
    16/16, exact launches (an injected fault raises before the device
    step and launches nothing).  Returns both runs' launch counts."""
    from repro_torch.core.resilience import Resilience
    from repro_torch.core.strategies import PureAsync
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    L = arch.cfg.n_layers
    out, streams, tps = {}, {}, {}
    for label, chaos in (("chaos-free", False), ("chaos", True)):
        eng, n_prefill = _chaos_engine(arch, params, device, chaos, 8, 16, CHAOS_RATES)
        sched = ContinuousBatchingScheduler(
            eng, strategy=PureAsync(),
            resilience=Resilience(quarantine_ticks=1) if chaos else None)
        reqs = _requests(Request, arch.cfg.vocab_size)
        out[label], wall = _drive(label, eng, sched, reqs, device)
        streams[label] = [r.generated for r in reqs]
        tps[label] = sum(len(g) for g in streams[label]) / wall
        st = sched.stats
        log(f"[{label}] injected decode faults {getattr(eng, 'injected_decode_faults', 0)}, "
            f"prefill faults {getattr(eng, 'injected_prefill_faults', 0)}; quarantined "
            f"{st.quarantined}, prefill_retries {st.prefill_retries}, kv_spilled "
            f"{st.kv_spilled}, kv_restored {st.kv_restored}; kv_bytes_moved "
            f"{eng.kv_bytes_moved}; decode ticks {eng.decode_steps}, prefill dispatches "
            f"{n_prefill[0]}")
        _expect(label, out[label], {"paged_decode_attention": eng.decode_steps * L,
                                    "flash_attention": n_prefill[0] * L,
                                    "decode_attention": 0, "ssd_scan": 0})
        if chaos and not (eng.injected_decode_faults >= 1 and eng.injected_prefill_faults >= 1
                          and st.quarantined >= 1 and st.prefill_retries >= 1):
            fail("chaos: need a decode fault, a prefill fault, a quarantined lane and a "
                 "prefill retry")
        if st.kv_spilled != st.kv_restored:
            fail(f"{label}: {st.kv_spilled} spills but {st.kv_restored} restores")
    same = sum(a == b for a, b in zip(streams["chaos"], streams["chaos-free"]))
    log(f"[chaos] greedy streams equal to the fault-free run in {same}/{len(streams['chaos'])}"
        f" requests; tokens/s {tps['chaos']!r} against {tps['chaos-free']!r} fault-free")
    if same != len(streams["chaos"]):
        fail("chaos: recovery changed a greedy stream")
    _sync(device)
    return out


def _ssm_requests(Request, vocab: int, max_new: int = 32):
    """16 prompts of 300-2000 tokens from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    lens = rng.integers(300, 2001, size=16)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=int(m)).astype(np.int32),
                    max_new_tokens=max_new) for i, m in enumerate(lens)]


def _ssm_async_requests(Request, vocab: int, max_new: int = 32):
    """14 prompts of 300-1000 tokens (template "chat") and 2 of 1056-1152
    (template "long", longer than the 1024-token chunk), interleaved, from
    ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    lens = [int(n) for n in rng.integers(300, 1001, size=14)]
    for at, n in zip((3, 9), rng.integers(1056, 1153, size=2)):
        lens.insert(at, -int(n))
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=abs(m)).astype(np.int32),
                    max_new_tokens=max_new, template="long" if m < 0 else "chat")
            for i, m in enumerate(lens)]


def _ssm_engine(arch, params, device="cuda"):
    from repro_torch.serving.engine import InferenceEngine
    return InferenceEngine(arch, params, n_lanes=8, max_prompt_len=2048, max_len=2080,
                           device=device)


def phase_ssm(arch, params, device="cuda"):
    """mamba2 on the synchronous path: every prefill dispatch runs the
    ``ssd_scan`` kernel once per layer, nothing else launches a kernel of
    the port (decode is the recurrent update, plain PyTorch)."""
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    L = arch.cfg.n_layers
    eng = _ssm_engine(arch, params, device)
    sched = ContinuousBatchingScheduler(
        eng, strategy=GrowingUpperThreshold(initial_upper=2))
    shapes = []  # the padded (batch, prompt) bucket of each prefill
    n_prefill = _count_calls(eng, "_prefill_step",
                             lambda toks, _p: shapes.append(tuple(toks.shape)) or 1)
    reqs = _ssm_requests(Request, arch.cfg.vocab_size)
    launches, wall = _drive("ssm", eng, sched, reqs, device)
    if eng.decode_steps == 0 or n_prefill[0] == 0:
        fail("ssm: the path ran no decode step or no prefill")
    if eng.dispatches != n_prefill[0] + eng.decode_steps:
        fail("ssm: dispatches != prefills + decode ticks")
    log(f"[ssm] prefill dispatches {n_prefill[0]}, padded buckets {shapes}")
    _expect("ssm", launches, {"ssd_scan": n_prefill[0] * L, "flash_attention": 0,
                              "decode_attention": 0, "paged_decode_attention": 0})
    _sync(device)
    return launches, wall, [r.generated for r in reqs]


def phase_ssm_async(arch, params, device="cuda", chunk: int = 1024):
    """mamba2 on the asynchronous path: ``overlap=True`` and
    ``chunk_tokens``; the long prompts prefill their first chunk (one
    ``ssd_scan`` launch a layer) and feed the rest through the recurrent
    decode, one host-issued ``decode_step`` a token."""
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    L = arch.cfg.n_layers
    eng = _ssm_engine(arch, params, device)
    sched = ContinuousBatchingScheduler(
        eng, strategy=GrowingUpperThreshold(initial_upper=2), overlap=True,
        chunk_tokens=chunk)
    n_prefill = _count_calls(eng, "_prefill_step")
    n_extend = _count_calls(eng, "_extend")
    fed = _count_calls(eng, "_extend", lambda _c, toks, _l: int(toks.shape[1]))
    reqs = _ssm_async_requests(Request, arch.cfg.vocab_size)
    launches, wall = _drive("ssm-async", eng, sched, reqs, device)
    st = sched.stats
    whole = sum(max(0, len(r.prompt) - chunk) for r in reqs)
    log(f"[ssm-async] spec_dispatched {st.spec_dispatched}, spec_committed "
        f"{st.spec_committed}, spec_aborted {st.spec_aborted}, spec_chunks "
        f"{st.spec_chunks}, spec_crashes {st.spec_crashes}; prefill dispatches "
        f"{n_prefill[0]}, chunk extends {n_extend[0]}, tokens through the decode "
        f"path {fed[0]} (the long prompts past their first chunk: {whole})")
    if st.spec_crashes != 0 or st.spec_chunks < 2 or fed[0] != whole:
        fail("ssm-async: need spec_crashes == 0, spec_chunks >= 2 and every "
             "long prompt's tail fed through the decode path")
    if eng.dispatches != n_prefill[0] + n_extend[0] + eng.decode_steps:
        fail("ssm-async: dispatches != prefills + extends + decode ticks")
    _expect("ssm-async", launches, {"ssd_scan": n_prefill[0] * L, "flash_attention": 0,
                                    "decode_attention": 0, "paged_decode_attention": 0})
    _expect_chunk_calls("ssm-async", fed[0], device)
    _sync(device)
    return launches, wall


def phase_ssm_paged(arch, params, ssm_streams, device="cuda", lane_timeout: int = 16):
    """mamba2 on the paged engine's dense-compute mode (the per-lane state
    stays, identity page frames, page-granular motion), with the ``ssm``
    phase's engine size and traffic, a host spill pool of 8 entries and a
    ``lane_timeout``: every lane is spilled once, whole, after 17 decode
    steps, and restored at the next admission.  A restore takes exactly
    the lane its spill freed, so the admissions, and so the prefill
    batches, are those of the ``ssm`` phase, and the greedy streams must
    equal that phase's (which matters: the right-padded SSM prefill makes
    a request's stream depend on its batch)."""
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.serving.engine import HostSpillPool
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    L = arch.cfg.n_layers
    eng = PagedInferenceEngine(arch, params, n_lanes=8, max_prompt_len=2048, max_len=2080,
                               page_size=16, kv_spill=HostSpillPool(8), device=device)
    if eng.paged_compute:
        fail("ssm-paged: mamba2 should run the dense-compute mode")
    sched = ContinuousBatchingScheduler(
        eng, strategy=GrowingUpperThreshold(initial_upper=2), lane_timeout=lane_timeout)
    n_prefill = _count_calls(eng, "_prefill_step")
    reqs = _ssm_requests(Request, arch.cfg.vocab_size)
    launches, wall = _drive("ssm-paged", eng, sched, reqs, device)
    st = sched.stats
    same = sum(r.generated == s for r, s in zip(reqs, ssm_streams))
    log(f"[ssm-paged] kv_spilled {st.kv_spilled}, kv_restored {st.kv_restored}, "
        f"kv_bytes_moved {eng.kv_bytes_moved}, pool {eng.pool.snapshot()}; prefill "
        f"dispatches {n_prefill[0]}; greedy streams equal to the ssm phase's in "
        f"{same}/{len(reqs)} requests")
    if not st.kv_restored == st.kv_spilled >= 1:
        fail("ssm-paged: need kv_restored == kv_spilled >= 1")
    if same != len(reqs):
        fail("ssm-paged: a greedy stream differs from the dense engine's ssm phase")
    _expect("ssm-paged", launches, {"ssd_scan": n_prefill[0] * L, "flash_attention": 0,
                                    "decode_attention": 0, "paged_decode_attention": 0})
    _sync(device)
    return launches, wall


def _init_full(name: str, smi: str):
    """A config at full width, weights drawn from seed 0 on the card; logs
    the reference's parameter counts beside the tensors' own."""
    import torch
    from repro_torch.models.registry import get_arch

    arch = get_arch(name)
    cfg = arch.cfg
    t0 = time.perf_counter()
    params = arch.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(int(a.numel()) for a in _leaves(params))
    nbytes = sum(a.numel() * a.element_size() for a in _leaves(params))
    # The reference's analytic param_count() leaves out the final norm's
    # d_model weights (none for olmo's non-parametric norm), and the leaves
    # _uncounted names.
    final_norm = sum(int(a.numel()) for a in _leaves(params["final_norm"]))
    extra = _uncounted(cfg, params)
    log(f"[{name}] on {smi}: full width, {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads} x {cfg.hd}; {n_params} parameters, "
        f"{nbytes} bytes (param_count() {cfg.param_count()} + final norm {final_norm} + "
        f"uncounted leaves {extra}, active per token {cfg.active_param_count()}), drawn "
        f"from seed 0 in {time.perf_counter() - t0!r} s")
    if n_params != cfg.param_count() + final_norm + extra:
        fail(f"{name}: {n_params} parameters drawn, param_count() says {cfg.param_count()}")
    return arch, params


def _uncounted(cfg, params) -> int:
    """Elements of the leaves ``param_count()`` leaves out besides the final
    norm: a hybrid block's conv and dt biases, gate-norm weights and two
    branch norms; an encoder-decoder's LayerNorm biases, ``ln_cross`` and
    ``enc_norm`` (it counts one weight vector per norm it counts)."""
    n = 0
    if cfg.hybrid:
        ssm = params["layers"]["ssm"]
        n += sum(ssm[k].numel() for k in ("conv_b", "dt_bias", "norm_w"))
        n += sum(params["layers"][k]["w"].numel()
                 for k in ("attn_branch_norm", "ssm_branch_norm"))
    if cfg.is_encoder_decoder:
        for stack in ("enc_layers", "layers"):
            n += sum(params[stack][k]["b"].numel() for k in ("ln1", "ln2"))
        n += sum(a.numel() for a in _leaves(params["layers"]["ln_cross"]))
        n += sum(a.numel() for a in _leaves(params["enc_norm"]))
    return int(n)


def _warm(arch, params, eng=None) -> None:
    """One prefill dispatch of 8 prompts and two decode ticks on a
    throw-away engine (a paged one unless ``eng`` is given) before a new
    model's first timed path, so that path's numbers do not carry the
    first calls' set-up (library kernels loaded, cuBLAS heuristics); its
    launches are not counted (the next path zeroes the counts)."""
    import torch
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request

    t0 = time.perf_counter()
    if eng is None:
        eng = PagedInferenceEngine(arch, params, n_lanes=8, max_prompt_len=256,
                                   max_len=512, page_size=16)
    with torch.no_grad():
        eng.commit_prefill(eng.prefill_dispatch(_requests(Request, arch.cfg.vocab_size, n=8)))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(2):
            eng.decode_tick()
    torch.cuda.synchronize()
    log(f"[{arch.cfg.name}] warm-up: the first prefill dispatch {t1 - t0!r} s, two "
        f"decode ticks {time.perf_counter() - t1!r} s")


def phase_configs(smi, names=("olmo-1b", "qwen1.5-4b", "chatglm3-6b")):
    """The dense configs at full width, one at a time, each on the
    synchronous paged path with 8 requests of 16 new tokens (exact launch
    counts by layer count), then phase 5's kernel-vs-plain check of its
    first prefill and decode tick.  Returns the summed launch counts."""
    import torch

    total = {}
    for name in names:
        arch, params = _init_full(name, smi)
        _warm(arch, params)
        launches = phase_main_path(arch, params, label=f"configs {name}", n=8, max_new=16)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        phase_logits_check(arch, params)
        del arch, params
        gc.collect()
        torch.cuda.empty_cache()
    return total


def phase_launcher(smi, name: str = "deepseek-moe-16b"):
    """The port's serving entry point, ``repro_torch.launch.serve.main``,
    once on the card at full width (its own weights, the dense engine, 32
    requests of 16 tokens).  Returns its launch counts."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.launch import serve

    registry.reset_launches()
    t0 = time.perf_counter()
    serve.main(["--arch", name])
    torch.cuda.synchronize()
    launches = registry.launch_counts()
    log(f"[launcher] {name} on {smi}: repro_torch.launch.serve.main in "
        f"{time.perf_counter() - t0!r} s, launches {launches}")
    if not (launches["flash_attention"] and launches["decode_attention"]):
        fail("launcher: the dense engine's kernels never launched")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# hymba-1.5b's dense engine: lanes of 2112 rows, so a 2048-token prompt
# and its 32 new tokens fit; the ring holds min(2112, W 1024) rows.
HYMBA_ENGINE = dict(n_lanes=8, max_prompt_len=2048, max_len=2112)


def _hymba_requests(Request, vocab: int, max_new: int = 32):
    """8 prompts of exactly 2048 tokens (template "long": the band
    engaged, the ring full at the prefill and wrapping in decode), then 8
    of 40-256 (template "short", so their batches keep their own bucket,
    below the window: a right-padded bucket that reaches W would leave
    them pad KV in their rings, the reference's fault), from
    ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    lens = [2048] * 8 + [int(n) for n in rng.integers(40, 257, size=8)]
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=n).astype(np.int32),
                    max_new_tokens=max_new, template="long" if n == 2048 else "short")
            for i, n in enumerate(lens)]


def phase_hymba(arch, params, device="cuda", paged=False, streams=None):
    """hymba on the dense engine, or (``paged``) on the paged engine's
    dense-compute mode with the same traffic, whose greedy streams must
    equal the dense engine's (``streams``) token for token.  Every prefill
    dispatch runs the banded flash kernel and ``ssd_scan`` once a layer,
    every decode tick the dense decode kernel once a layer over the rings."""
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    label = "hymba-paged" if paged else "hymba"
    L = arch.cfg.n_layers
    if paged:
        eng = PagedInferenceEngine(arch, params, page_size=16, device=device, **HYMBA_ENGINE)
        if eng.paged_compute:
            fail("hymba-paged: a windowed hybrid should run the dense-compute mode")
    else:
        eng = InferenceEngine(arch, params, device=device, **HYMBA_ENGINE)
    sched = ContinuousBatchingScheduler(eng, strategy=GrowingUpperThreshold(initial_upper=2))
    shapes = []
    n_prefill = _count_calls(eng, "_prefill_step",
                             lambda toks, _p: shapes.append(tuple(toks.shape)) or 1)
    reqs = _hymba_requests(Request, arch.cfg.vocab_size)
    launches, wall = _drive(label, eng, sched, reqs, device)
    log(f"[{label}] prefill dispatches {n_prefill[0]}, padded buckets {shapes}; "
        f"kv_bytes_moved {eng.kv_bytes_moved}")
    if eng.decode_steps == 0 or n_prefill[0] == 0:
        fail(f"{label}: the path ran no decode step or no prefill")
    if eng.dispatches != n_prefill[0] + eng.decode_steps:
        fail(f"{label}: dispatches != prefills + decode ticks")
    if not any(p >= arch.cfg.attn_window for _b, p in shapes):
        fail(f"{label}: no prefill reached the window")
    _expect(label, launches, {"flash_attention": n_prefill[0] * L, "ssd_scan": n_prefill[0] * L,
                              "decode_attention": eng.decode_steps * L,
                              "paged_decode_attention": 0})
    mine = [r.generated for r in reqs]
    if streams is not None:
        same = sum(a == b for a, b in zip(mine, streams))
        log(f"[{label}] greedy streams equal to the dense engine's in {same}/{len(reqs)} "
            "requests")
        if same != len(reqs):
            fail(f"{label}: a greedy stream differs from the dense engine's")
    _sync(device)
    return launches, wall, mine


def phase_hymba_chunked(arch, params, device="cuda", chunk: int = 512, n: int = 600):
    """One ``n``-token prompt on the dense engine under ``overlap=True,
    chunk_tokens=chunk``: the first chunk prefills (flash and ``ssd_scan``
    once a layer), the rest goes through ``_extend``, one decode step a
    token (the decode kernel once a layer)."""
    from repro_torch.core.strategies import GrowingUpperThreshold
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    L = arch.cfg.n_layers
    eng = InferenceEngine(arch, params, device=device, **HYMBA_ENGINE)
    sched = ContinuousBatchingScheduler(eng, strategy=GrowingUpperThreshold(initial_upper=2),
                                        overlap=True, chunk_tokens=chunk)
    n_prefill = _count_calls(eng, "_prefill_step")
    fed = _count_calls(eng, "_extend", lambda _c, toks, _l: int(toks.shape[1]))
    rng = np.random.default_rng(3)
    reqs = [Request(rid=0, prompt=rng.integers(0, arch.cfg.vocab_size, size=n).astype(np.int32),
                    max_new_tokens=32)]
    launches, wall = _drive("hymba-chunked", eng, sched, reqs, device)
    log(f"[hymba-chunked] spec_chunks {sched.stats.spec_chunks}, spec_crashes "
        f"{sched.stats.spec_crashes}; prefill dispatches {n_prefill[0]}, tokens through the "
        f"decode path {fed[0]} (past the first chunk: {n - chunk})")
    if sched.stats.spec_crashes or fed[0] != n - chunk or n_prefill[0] != 1:
        fail("hymba-chunked: need no speculation crash, one prefill and the prompt's tail "
             "fed through the decode path")
    _expect("hymba-chunked", launches, {"flash_attention": L, "ssd_scan": L,
                                        "decode_attention": (fed[0] + eng.decode_steps) * L,
                                        "paged_decode_attention": 0})
    _expect_chunk_calls("hymba-chunked", fed[0], device)
    _sync(device)
    return launches, wall


def _check_steps(label, cfg, prefill, step) -> None:
    """The kernel path against the plain path (``_plain_ops``) on the same
    weights and inputs at a prefill and at the first decode step after it
    (on the kernel path's cache, copied): ``prefill()`` → (logits, cache),
    ``step(cache, token)`` → logits.  Phase 5's gate."""
    import torch
    with torch.no_grad():
        kern, cache = prefill()
        with _plain_ops():
            plain = prefill()[0]
        _report_logits(f"{label} prefill", kern, plain)
        token = kern.argmax(-1).to(torch.int32)
        k_tick = step(_clone(cache), token)
        with _plain_ops():
            p_tick = step(_clone(cache), token)
        _report_logits(f"{label} first decode step", k_tick, p_tick)
    del cache
    torch.cuda.synchronize()


def phase_hymba_check(arch, params, device="cuda"):
    """The first full-width prefill of the 8 prompts of 2048 tokens (the
    band and the ring) and one decode step from its rings, banded flash,
    ``ssd_scan`` and the decode kernel against their plain versions."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.serving.request import Request

    cfg = arch.cfg
    reqs = _hymba_requests(Request, cfg.vocab_size)[:8]
    toks = torch.as_tensor(np.stack([r.prompt for r in reqs]), device=device)
    lengths = torch.full((8,), 2048, dtype=torch.int32, device=device)
    _check_steps("hymba-1.5b 8 x 2048 (band, ring, ssd_scan)", cfg,
                 lambda: tf.prefill(cfg, params, toks, max_len=HYMBA_ENGINE["max_len"]),
                 lambda cache, tok: tf.decode_step(cfg, params, tok, cache, lengths)[0])


def _vlm_batch(cfg, params, device, b: int = 8, side: int = 16, text: int = 32):
    """``b`` stub sequences: ``side`` x ``side`` patch embeddings (seeded
    normals from numpy) at temporal position 0, rows h and w over the
    grid, then ``text`` tokens embedded by the model's table at positions
    ``side``, ``side`` + 1, ... on all three rows."""
    import torch
    rng = np.random.default_rng(0)
    n = side * side
    patches = torch.as_tensor(rng.standard_normal((b, n, cfg.d_model)).astype(np.float32),
                              device=device).to(cfg.cdtype)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, text)), device=device)
    emb = torch.cat([patches, params["embed"]["table"][toks].to(cfg.cdtype)], dim=1)
    pos = np.zeros((3, b, n + text), np.int64)
    pos[1, :, :n], pos[2, :, :n] = np.arange(n) // side, np.arange(n) % side
    pos[:, :, n:] = side + np.arange(text)
    return {"embeds": emb, "positions": torch.as_tensor(pos, device=device)}


def _greedy(arch, params, batch, steps: int, max_len: int, device):
    """``Arch.prefill`` of ``batch``, then ``steps`` greedy ``decode_step``s
    on its dense cache, launches counted from 0.  Returns (launches, wall
    seconds, tokens (B, steps))."""
    import torch
    from repro_torch.kernels import registry

    _sync(device)
    registry.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = arch.prefill(params, batch, max_len=max_len)
        s = next(batch[k] for k in ("tgt_tokens", "embeds", "tokens") if k in batch).shape[1]
        lengths = torch.full((logits.shape[0],), s, dtype=torch.int32, device=device)
        out = []
        for _ in range(steps):
            tok = logits.argmax(-1).to(torch.int32)
            out.append(tok)
            logits, cache = arch.decode_step(params, tok, cache, lengths)
            lengths = lengths + 1
        toks = torch.stack(out, dim=1).cpu().numpy()
    _sync(device)
    wall = time.perf_counter() - t0
    vocab = arch.cfg.vocab_size
    if not (bool(torch.isfinite(logits).all()) and ((toks >= 0) & (toks < vocab)).all()):
        fail(f"{arch.cfg.name}: non-finite logits or tokens outside the vocabulary")
    return registry.launch_counts(), wall, toks


def phase_vlm_embeds(arch, params, device="cuda", steps: int = 32):
    """qwen2-vl on its frontend's path: ``Arch.prefill`` of 8 stub
    sequences of 256 patch embeddings and 32 text tokens (the flash kernel
    masking on the grid's positions), then ``steps`` greedy
    ``Arch.decode_step``s on a dense cache (the decode kernel at group 6);
    then the kernel path against the plain path at the prefill and one
    step."""
    import torch
    L = arch.cfg.n_layers
    batch = _vlm_batch(arch.cfg, params, device)
    s = batch["embeds"].shape[1]
    launches, wall, toks = _greedy(arch, params, batch, steps, s + steps, device)
    n_tok = toks.size
    log(f"[vlm-embeds] 8 sequences of {s} (256 patches + 32 text tokens), {steps} greedy "
        f"tokens each: {n_tok} tokens in {wall!r} s, {n_tok / wall!r} tokens/s (prefill "
        f"included); launches {launches}")
    _expect("vlm-embeds", launches, {"flash_attention": L, "decode_attention": steps * L,
                                     "paged_decode_attention": 0, "ssd_scan": 0})
    lengths = torch.full((8,), s, dtype=torch.int32, device=device)
    _check_steps("qwen2-vl-2b 8 x (256 patches + 32 text)", arch.cfg,
                 lambda: arch.prefill(params, batch, max_len=s + steps),
                 lambda cache, tok: arch.decode_step(params, tok, cache, lengths)[0])
    return launches, wall


def _encdec_batch(cfg, device, b: int = 8, src: int = 512, tgt: int = 8):
    """``b`` sources of ``src`` stub frame embeddings (seeded normals from
    numpy) and ``tgt``-token targets."""
    import torch
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((b, src, cfg.d_model)).astype(np.float32)
    return {"src_embeds": torch.as_tensor(frames, device=device).to(cfg.cdtype),
            "tgt_tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, tgt)),
                                          device=device)}


def phase_encdec(arch, params, device="cuda", steps: int = 32):
    """seamless-m4t at full width: ``Arch.prefill`` of 8 sources of 512
    frames and 8-token targets (flash: the encoder's 12 layers without a
    mask, the decoder's 12 causal and 12 cross), then ``steps`` greedy
    tokens (decode: 12 self over the padded cache and 12 cross over the
    memory's fixed KV a token); a one-source warm-up first.  Then the
    kernel path against the plain path at the prefill and one step."""
    import torch
    L = arch.cfg.n_layers
    batch = _encdec_batch(arch.cfg, device)
    t0 = time.perf_counter()
    _greedy(arch, params, {k: v[:1, :64] if k == "src_embeds" else v[:1]
                           for k, v in batch.items()}, 1, 9, device)
    log(f"[encdec] warm-up (1 source of 64 frames, 1 token) {time.perf_counter() - t0!r} s")
    launches, wall, toks = _greedy(arch, params, batch, steps, 8 + steps, device)
    log(f"[encdec] 8 sources of 512 frames, 8-token targets, {steps} greedy tokens each: "
        f"{toks.size} tokens in {wall!r} s, {toks.size / wall!r} tokens/s (prefill "
        f"included); peak memory {torch.cuda.max_memory_allocated() / 2**30!r} GiB; "
        f"launches {launches}")
    _expect("encdec", launches, {"flash_attention": arch.cfg.n_enc_layers + 2 * L,
                                 "decode_attention": 2 * L * steps,
                                 "paged_decode_attention": 0, "ssd_scan": 0})
    lengths = torch.full((8,), 8, dtype=torch.int32, device=device)
    _check_steps("seamless-m4t-medium 8 x 512 frames, 8 target tokens", arch.cfg,
                 lambda: arch.prefill(params, batch, max_len=8 + steps),
                 lambda cache, tok: arch.decode_step(params, tok, cache, lengths)[0])
    return launches, wall


# ----------------------------------------------------------------- phase 5
@contextlib.contextmanager
def _plain_ops():
    """Patch the model's kernel ops (flash, dense and paged decode, the SSD
    scan) with their plain versions (the comparison path only; the port
    itself has no such switch)."""
    import torch
    from repro_torch.kernels.decode_attention.ref import decode_ref
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.paged_attention.ref import paged_decode_ref
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import paged_decode as pd_mod
    from repro_torch.models import ssm as ssm_mod

    def plain_attention(q, k, v, *, causal=True, window=0, positions=None):
        return attention_ref(q, k, v, causal=causal, window=window, positions=positions)

    def plain_scan(states, decay, initial_state=None):
        return ssd_scan_ref(states, decay, initial_state)

    def plain_decode(q, k, v, lengths, *, k_new=None, v_new=None, slot=None):
        if k_new is not None:  # the new token's K/V first, as ``decode_op`` writes them
            rows = torch.arange(k.shape[0], device=k.device)
            k.index_put_((rows, slot), k_new.to(k.dtype))
            v.index_put_((rows, slot), v_new.to(v.dtype))
        return decode_ref(q, k, v, lengths)

    with mock.patch.object(attn_mod, "attention_op", plain_attention), \
            mock.patch.object(attn_mod, "decode_op", plain_decode), \
            mock.patch.object(pd_mod, "paged_decode_op", paged_decode_ref), \
            mock.patch.object(ssm_mod, "ssd_scan_op", plain_scan):
        yield


class _Routes:
    """Instrumentation of this script's checks (the port has no such
    switch): ``record()`` keeps the experts ``moe._route`` picks, call by
    call; ``replay(calls)`` makes ``_route`` take those experts instead of
    its own top-k, with the gates and positions computed as ``_route``
    computes them from the current input, so a second path can run on the
    first path's routes."""

    def __init__(self):
        from repro_torch.models import moe as moe_mod
        self.mod, self.inner, self.calls = moe_mod, moe_mod._route, []

    def _record(self, *args):
        out = self.inner(*args)
        self.calls.append(out[1])
        return out

    def _replay(self, router_w, cfg, x, C):
        import torch
        from torch.distributed.tensor import DTensor, distribute_tensor
        idx = self.calls.pop(0)
        if isinstance(x, DTensor):  # each rank takes its rows of the recorded routes
            idx = distribute_tensor(idx.to(x.to_local().device), x.device_mesh, x.placements,
                                    src_data_rank=None)
        probs = torch.softmax(torch.matmul(x.float(), router_w.float()), dim=-1)
        gate = probs.gather(-1, idx)
        gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
        pos = self.mod._positions(idx, cfg.n_experts)
        return probs, idx, gate * (pos < C).float(), pos

    def record(self):
        self.calls = []
        return mock.patch.object(self.mod, "_route", self._record)

    def replay(self, calls):
        self.calls = list(calls)
        return mock.patch.object(self.mod, "_route", self._replay)


def _route_agreement(label, kern_calls, plain_calls) -> None:
    """Share of (token, k) routes of the kernel path that the plain path
    also took, over every MoE layer of one dispatch: bf16 hidden states
    that differ in their last bits can flip a near-tie in the top-k."""
    if len(kern_calls) != len(plain_calls) or not kern_calls:
        fail(f"{label}: the two paths routed {len(kern_calls)} and {len(plain_calls)} layers")
    same = total = 0
    for a, b in zip(kern_calls, plain_calls):
        a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        hit = (a[:, :, None] == b[:, None, :]).any(-1)
        same += int(hit.sum())
        total += hit.numel()
    log(f"[check] {label}: {same}/{total} (token, k) routes agree between the kernel "
        f"path and the plain path ({same / total!r}) over {len(kern_calls)} MoE layers")


def _check_paths(label, cfg, run) -> None:
    """``run(plain)`` → logits (B, V) of one dispatch, through the kernels
    or, with ``plain``, their plain versions (``_plain_ops``).  A dense
    config is gated on the two directly.  For a MoE config a flipped
    near-tie in some layer's top-k sends a token through other experts,
    which moves its logits by far more than the attention paths' rounding:
    the free-routed comparison and the share of routes the paths agree on
    are logged, and the gate holds the plain path run on the kernel path's
    routes against the kernel path."""
    routes = _Routes()
    with routes.record():
        kern = run(False)
    kern_routes = routes.calls
    with _plain_ops(), routes.record():
        plain = run(True)
    if not cfg.is_moe:
        _report_logits(label, kern, plain)
        return
    _route_agreement(label, kern_routes, routes.calls)
    _report_logits(f"{label}, routed freely (logged, not gated)", kern, plain, gate=False)
    with _plain_ops(), routes.replay(kern_routes):
        pinned = run(True)
    _report_logits(f"{label}, the plain path on the kernel path's routes", kern, pinned)


def phase_logits_check(arch, params, device="cuda"):
    """First prefill and first decode tick at full width, kernel path
    against the plain path on the same weights and batch (``_check_paths``:
    for a MoE config on the same routes, with the share of routes the two
    paths agree on when each routes freely)."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.models.paged_decode import paged_decode_step
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request

    cfg = arch.cfg
    name = f"{cfg.name}: " if cfg.name != "llama3-8b" else ""
    eng = PagedInferenceEngine(arch, params, n_lanes=8, max_prompt_len=256,
                               max_len=512, page_size=16, device=device)
    reqs = _requests(Request, cfg.vocab_size, n=8)
    staged = eng.prefill_dispatch(reqs)
    toks = torch.zeros(staged.shape, dtype=torch.int32, device=device)
    for i, r in enumerate(reqs):
        toks[i, :len(r.prompt)] = torch.as_tensor(r.prompt, device=device)
    rows = torch.arange(len(reqs), device=device)
    last = torch.as_tensor(staged.plens - 1, device=device).long()
    with torch.no_grad():
        _check_paths(f"{name}first prefill (flash kernel vs plain attention)", cfg,
                     lambda _plain: tf.prefill(cfg, params, toks,
                                               return_all_logits=True)[0][rows, last])

    eng.commit_prefill(staged)
    for lane in range(eng.n_lanes):  # the first tick's write page
        eng._ensure_pages(lane, int(eng.lengths[lane]) // eng.page_size + 1)
    token = torch.as_tensor(eng.last_token, device=device)
    args = (eng._device_tables(), torch.as_tensor(eng.lengths, device=device),
            torch.as_tensor(eng.active, device=device))
    pages = {}

    def tick(plain):
        cache = {n: {k: a.clone() for k, a in st.items()} for n, st in eng.cache.items()}
        logits, pages[plain] = paged_decode_step(cfg, params, token, cache, *args)
        return logits

    with torch.no_grad():
        _check_paths(f"{name}first decode tick (paged kernel vs plain paged attention)",
                     cfg, tick)
    kc, pc = pages[False], pages[True]
    diff = max(float((kc[n][k].float() - pc[n][k].float()).abs().max())
               for n in kc for k in kc[n])
    log(f"[check] {name}first decode tick: page arrays max abs diff {diff!r}")
    del eng, kc, pc, pages
    _sync(device)


def phase_prefix_check(arch, params, device="cuda"):
    """The prefix-hit path at full width: one hit's last-position logits
    from ``_shared_tail`` (the owner's 12 aliased pages gathered into a
    dense cache, the tail fed through ``decode_step``) against a flash
    prefill of the same whole prompt, same weights (phase 5's gate, 0.05 x
    max |logit|).  Then what the tail costs: wall time of one
    ``_shared_tail`` (chunk-step replays, and under ``graphs.eager()``) and
    of one flash prefill dispatch of the whole prompt,
    and, on the card, both under the profiler with ``decode_attention``'s
    launches and device time in the tail."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.serving import graphs
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request

    cfg = arch.cfg
    eng = PagedInferenceEngine(arch, params, n_lanes=8, max_prompt_len=256, max_len=512,
                               page_size=16, prefix_share=True, device=device)
    owner, hit = _prefix_requests(Request, cfg.vocab_size)[:2]
    eng.admit([owner, hit])
    if eng.prefix_hits != 1:
        fail("prefix check: the second request was not a prefix hit")
    start = 12 * eng.page_size
    idx = torch.as_tensor(eng.pool.pages(hit.lane)[:12], device=device)
    tail = hit.prompt[None, start:]
    with torch.no_grad():
        kern = eng._shared_tail(idx, tail, start)[0]
        full = tf.prefill(cfg, params, torch.as_tensor(hit.prompt[None], device=device))[0]
    _report_logits(f"prefix hit ({tail.shape[1]}-token tail after {start} aliased rows): "
                   f"_shared_tail vs a flash prefill of the whole {len(hit.prompt)}-token "
                   "prompt", kern, full)
    walls = {}
    for label, fn in (("_shared_tail", lambda: eng._shared_tail(idx, tail, start)),
                      ("eager", lambda: eng._shared_tail(idx, tail, start)),
                      ("flash prefill dispatch", lambda: eng.prefill_dispatch([hit]))):
        with torch.no_grad(), graphs.eager() if label == "eager" else contextlib.nullcontext():
            fn()
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            _sync(device)
        walls[label] = (time.perf_counter() - t0) / 3 * 1e3
    log(f"[profile] prefix hit, {tail.shape[1]}-token tail: _shared_tail "
        f"{walls['_shared_tail']!r} ms wall (chunk-step replays; under eager() "
        f"{walls['eager']!r} ms), a flash prefill dispatch of the whole "
        f"{len(hit.prompt)}-token prompt {walls['flash prefill dispatch']!r} ms wall "
        "(no profiler, mean of 3)")
    if device != "cuda":
        return
    with torch.no_grad():
        rows = _window(f"_shared_tail, a {tail.shape[1]}-token tail",
                       lambda: eng._shared_tail(idx, tail, start), 1)
        dec = [(ms, c) for key, ms, c in rows if "decode_cluster_kernel" in key]
        log(f"[profile] _shared_tail: decode_attention {sum(ms for ms, _c in dec)!r} ms "
            f"device time in {sum(c for _ms, c in dec)} launches")
        _window(f"flash prefill dispatch of the whole {len(hit.prompt)}-token prompt",
                lambda: eng.prefill_dispatch([hit]), 1)
    torch.cuda.synchronize()


def phase_ssm_logits_check(arch, params, device="cuda"):
    """The first full-width mamba2 prefill (8 prompts right-padded to 8 x
    2048, as the engine pads them): logits at ``plens - 1`` through the
    ``ssd_scan`` kernel against the plain scan, same weights and batch.
    Both scans are the same float32 multiply and add per chunk, so the two
    paths should agree exactly; the gate allows 1e-3 x max |logit| and an
    argmax that differs only where the plain path's top two logits lie
    within twice the difference of each other (a tie)."""
    import torch
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import transformer as tf
    from repro_torch.serving.request import Request

    cfg = arch.cfg
    reqs = _ssm_requests(Request, cfg.vocab_size)[:8]
    plens = np.array([len(r.prompt) for r in reqs])
    toks = torch.zeros((8, 2048), dtype=torch.int32, device=device)
    for i, r in enumerate(reqs):
        toks[i, :len(r.prompt)] = torch.as_tensor(r.prompt, device=device)
    rows = torch.arange(8, device=device)
    last = torch.as_tensor(plens - 1, device=device).long()

    def plain_scan(states, decay, initial_state=None):
        return ssd_scan_ref(states, decay, initial_state)

    def plain_decode(q, k, v, lengths, *, k_new=None, v_new=None, slot=None):
        if k_new is not None:  # the new token's K/V first, as ``decode_op`` writes them
            rows = torch.arange(k.shape[0], device=k.device)
            k.index_put_((rows, slot), k_new.to(k.dtype))
            v.index_put_((rows, slot), v_new.to(v.dtype))
        return decode_ref(q, k, v, lengths)

    with torch.no_grad():
        kern = tf.prefill(cfg, params, toks, return_all_logits=True)[0][rows, last]
        with mock.patch.object(ssm_mod, "ssd_scan_op", plain_scan):
            plain = tf.prefill(cfg, params, toks, return_all_logits=True)[0][rows, last]
    if not bool(torch.isfinite(kern).all()):
        fail("mamba2 prefill: non-finite logits")
    diff = float((kern - plain).abs().max())
    scale = float(plain.abs().max())
    top2 = plain.topk(2, dim=-1).values
    tie = (top2[:, 0] - top2[:, 1]) <= 2 * diff
    agree = kern.argmax(-1) == plain.argmax(-1)
    log(f"[check] first mamba2 prefill (ssd_scan kernel vs plain scan): logits "
        f"{tuple(kern.shape)}, prompt lengths {plens.tolist()}, max abs diff {diff!r} "
        f"(max |logit| {scale!r}), argmax agreement {int(agree.sum())}/8")
    if diff > 1e-3 * scale or not bool((agree | tie).all()):
        fail("mamba2 prefill: kernel path and plain path disagree")
    _sync(device)


def _report_logits(label, kern, plain, gate: bool = True):
    import torch
    if not bool(torch.isfinite(kern).all()):
        fail(f"{label}: non-finite logits")
    diff = float((kern - plain).abs().max())
    scale = float(plain.abs().max())
    agree = int((kern.argmax(-1) == plain.argmax(-1)).sum())
    log(f"[check] {label}: logits {tuple(kern.shape)}, max abs diff {diff!r} "
        f"(max |logit| {scale!r}), argmax agreement {agree}/{kern.shape[0]}")
    # bf16 through 32 layers: the two attention paths round differently,
    # and random weights give near-flat logits whose top entries lie
    # closer together than that rounding, so exact agreement is not
    # expected.  On the H100 the difference reads about 0.017 x max |logit|;
    # a broken kernel moves every row well past the 0.05 gate.
    if gate and (agree < kern.shape[0] - 2 or diff > 0.05 * scale):
        fail(f"{label}: kernel path and plain path disagree")


def _window(label, fn, n):
    """``torch.profiler`` over ``n`` calls of ``fn``: logs the host wall
    time per call, the device busy time and share, and the kernels that
    take the most of it.  Returns ``[(kernel name, ms per call, launches
    per call)]`` (empty when the profiler recorded no device activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3 / n, e.count // n)
            for e in prof.key_averages()
            if e.device_type.name == "CUDA" and e.self_device_time_total > 0]
    busy = sum(ms for _k, ms, _c in rows)
    if busy == 0:
        log(f"[profile] {label}: {wall!r} ms wall; device time not measured "
            "(the profiler recorded no device activity)")
        return []
    log(f"[profile] {label}: {wall!r} ms wall, {busy!r} ms device busy "
        f"({busy / wall!r} busy share), {sum(c for *_r, c in rows)} kernels")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"[profile]   {ms!r} ms  x{count}  {key[:90]}")
    return rows


def _tick_walls(label, eng, ticks: int) -> None:
    """Host wall time of a decode tick, no profiler, mean of ``ticks``: the
    captured tick replayed, then the same tick under ``graphs.eager()``."""
    import torch
    from repro_torch.serving import graphs

    walls = {}
    for mode in ("graph replay", "eager()"):
        with graphs.eager() if mode == "eager()" else contextlib.nullcontext():
            eng.decode_tick()  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ticks):
                eng.decode_tick()
            torch.cuda.synchronize()
        walls[mode] = (time.perf_counter() - t0) / ticks * 1e3
    log(f"[profile] {label}, no profiler (mean of {ticks}): graph replay "
        f"{walls['graph replay']!r} ms wall, eager() {walls['eager()']!r} ms wall")


def _prefill_walls(eng, reqs, n: int = 4) -> None:
    """A prefill dispatch of ``reqs`` (8 prompts, bucket 8 x 256) on
    ``eng``: the first, which builds the bucket's step, runs it for real
    and records it (what the first request of a bucket waits for), with
    its parts (the step's host seconds), then the host wall of ``n``
    more, replayed and under ``graphs.eager()``, one replay under
    ``torch.profiler`` (the device's busy share), and the copy-out of the
    bucket's view of the staging cache timed alone with CUDA events.  The
    dispatch runs on the engine's own stream; every wall ends in
    ``torch.cuda.synchronize()``, which waits for it."""
    import torch
    from repro_torch.serving import graphs

    def dispatch():
        eng.prefill_dispatch(reqs)
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    dispatch()
    first = (time.perf_counter() - t0) * 1e3
    walls = {}
    for mode in ("graph replay", "eager()"):
        with graphs.eager() if mode == "eager()" else contextlib.nullcontext():
            dispatch()  # warm
            t0 = time.perf_counter()
            for _ in range(n):
                dispatch()
        walls[mode] = (time.perf_counter() - t0) / n * 1e3
    _window("prefill dispatch (graph replay) of 8 prompts, bucket 8 x 256",
            lambda: eng.prefill_dispatch(reqs), 1)
    view = [a[:, :len(reqs)] for a in _leaves(eng._prefill_out)]
    nbytes = sum(a.numel() * a.element_size() for a in view)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for a in view:
        a.clone()  # warm
    start.record()
    for _ in range(10):
        for a in view:
            a.clone()
    end.record()
    torch.cuda.synchronize()
    copy = start.elapsed_time(end) / 10
    parts = {k: v * 1e3 for k, v in eng._prefill_steps.steps[(len(reqs), 256)].parts.items()}
    log(f"[profile] prefill dispatch, bucket 8 x 256, no profiler: the first (a real run, "
        f"then the recording) {first!r} ms, its parts in host ms {parts}; mean of {n}: "
        f"graph replay "
        f"{walls['graph replay']!r} ms wall, eager() {walls['eager()']!r} ms wall; the "
        f"copy-out of the bucket's KV ({nbytes} bytes read and as many written) {copy!r} "
        f"ms on the device ({2 * nbytes / (copy / 1e3) / 1e12!r} TB/s)")


def phase_profile(arch, params, ticks: int = 8):
    """Where a decode tick's time goes at full width: host wall time per
    tick, replayed and under ``graphs.eager()``, against the device time
    ``torch.profiler`` records for the replayed tick (busy share), and the
    kernels that take the most of it; the same for one prefill dispatch
    of 8 prompts and for one fused tick (a 64-token chunk folded into the
    decode: 64 chunk-step replays and one tick replay), whose wall is also
    taken under ``eager()``; the prefill's first dispatch, replayed and
    eager walls and copy-out (``_prefill_walls``).  Runs after the main
    path, so its launches are not in the main path's counts."""
    import torch
    from repro_torch.serving import graphs
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request

    eng = PagedInferenceEngine(arch, params, n_lanes=8, max_prompt_len=256,
                               max_len=512, page_size=16)
    reqs = _requests(Request, arch.cfg.vocab_size, n=8)

    with torch.no_grad():
        _prefill_walls(eng, reqs)
        eng.commit_prefill(eng.prefill_dispatch(reqs))
        t0 = time.perf_counter()
        eng.decode_tick()  # the tick step's first call: a real run, then the recording
        torch.cuda.synchronize()
        tick_first = (time.perf_counter() - t0) * 1e3
        eng.decode_tick()  # warm
        log(f"[profile] the tick's first call (a real run, then the recording) "
            f"{tick_first!r} ms wall; parts in host ms "
            f"{ {k: v * 1e3 for k, v in eng._tick_step.parts.items()} }")
        _tick_walls("decode tick, 8 lanes", eng, ticks)
        rows = _window(f"decode tick (graph replay), 8 lanes (mean of {ticks})",
                       eng.decode_tick, ticks)
        paged = [(ms, c) for key, ms, c in rows if "paged_cluster_kernel" in key]
        log(f"[profile] decode tick: paged_decode_attention {sum(ms for ms, _c in paged)!r} "
            f"ms device time in {sum(c for _ms, c in paged)} launches per tick")
        # Fused ticks of the asynchronous path: the 8 lanes' paged decode
        # plus a 64-token prompt chunk fed through the dense decode path.
        prompt = np.random.default_rng(2).integers(
            0, arch.cfg.vocab_size, size=320).astype(np.int32)
        walls = {}
        for mode in ("eager()", "graph replay", "profiled"):
            staged = eng.prefill_dispatch([Request(rid=99, prompt=prompt)], chunk=256)
            torch.cuda.synchronize()
            if not eng.stage_chunk(staged):
                fail("profile: the fused tick declined the chunk")
            if mode == "profiled":
                _window("fused tick (graph replays), 8 lanes + a 64-token chunk",
                        eng.decode_tick, 1)
                continue
            with graphs.eager() if mode == "eager()" else contextlib.nullcontext():
                t0 = time.perf_counter()
                eng.decode_tick()
                torch.cuda.synchronize()
            walls[mode] = (time.perf_counter() - t0) * 1e3
        log(f"[profile] fused tick, 8 lanes + a 64-token chunk, no profiler: graph replays "
            f"{walls['graph replay']!r} ms wall, eager() {walls['eager()']!r} ms wall")
    torch.cuda.synchronize()


def phase_build_memory(arch, params, share: float = 0.6, ticks: int = 4):
    """6m. Device memory a paged engine takes while it is built: a page
    pool of ``share`` of the free memory, its tick and chunk steps made
    (each records its graph at its first call, with no copy of the cache),
    so the peak above what was allocated before is the pool plus the
    staging caches; fails at 1.1 x the pool.  Then ``ticks`` ticks on 8
    admitted prompts, the first recording the tick, with finite logits."""
    import torch
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request

    cfg, ps = arch.cfg, 16
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    item = torch.empty((), dtype=cfg.cdtype).element_size()
    page = cfg.n_layers * 2 * ps * cfg.n_kv_heads * cfg.hd * item  # K and V of every layer
    n_pages = int(share * free / page)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = PagedInferenceEngine(arch, params, n_lanes=8, max_prompt_len=256, max_len=512,
                               page_size=ps, n_pages=n_pages)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    pool = sum(a.numel() * a.element_size() for a in _leaves(eng.cache))
    log(f"[memory] {cfg.name} paged engine, {n_pages} pages of {page} bytes ({share} of "
        f"{free} free bytes): built in {build_s!r} s; peak {peak} bytes above "
        f"the {before} allocated before, against the pool's {pool} bytes "
        f"({peak / pool!r} x)")
    if peak >= 1.1 * pool:
        fail(f"memory: building the engine took {peak / pool!r} x its pool's bytes")
    reqs = _requests(Request, cfg.vocab_size, n=8)
    with torch.no_grad():
        eng.commit_prefill(eng.prefill_dispatch(reqs))
        for _ in range(ticks):
            eng.decode_tick()
        if not bool(torch.isfinite(eng._tick_step.out[0]).all()):
            fail("memory: the large-pool engine's tick logits are not finite")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def _pool_bytes(pools: dict):
    """Bytes of the allocator's segments in each graph pool of ``pools``
    (name -> pool id), or ``None`` when its snapshot names no pools."""
    import torch
    segs = torch.cuda.memory_snapshot()
    if not any("segment_pool_id" in seg for seg in segs):
        return None
    return {name: sum(seg["total_size"] for seg in segs
                      if tuple(seg.get("segment_pool_id", ())) == tuple(pid))
            for name, pid in pools.items()}


def phase_prefill_memory(arch, params, lanes: int = 8, max_len: int = 512):
    """6p. The prefill steps' first dispatches and memory.  A llama3-8b
    paged engine (``lanes`` lanes of ``max_len`` rows, prompts up to 256)
    is built, then serves one prefill dispatch of every bucket its
    templates can pin (batch 1, 2, 4, 8 x prompt 16 to 256, 20 in all),
    the largest first, each dropped uncommitted, then again (a replay) and
    once under ``graphs.eager()``, each dispatch timed to its end.  The
    first dispatch of a bucket is split into its parts, host seconds the
    step measured: the real run (its issue; its device work overlaps what
    follows), the recording and the instantiation.  Logs the device
    memory the build took, the
    bytes of each graph pool (the tick's with the main stream's chunk
    step, the engine stream's chunk step's, the prefill steps') after the
    largest bucket and after all, the memory allocated and the peak.
    Gates: every prefill step writes the one staging cache; each ran its
    first call once for real; the prefill pool after all buckets at most
    1.1 x after the largest; the memory allocated and the peak grow by at
    most 64 MiB after the largest."""
    import torch
    from repro_torch.serving import graphs
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request

    vocab, mib = arch.cfg.vocab_size, 2 ** 20
    buckets = [(b, p) for b in (8, 4, 2, 1) for p in (256, 128, 64, 32, 16)]
    rng = np.random.default_rng(5)
    prompts = {bp: [rng.integers(0, vocab, size=bp[1]).astype(np.int32) for _ in range(bp[0])]
               for bp in buckets}

    def engine():
        return PagedInferenceEngine(arch, params, n_lanes=lanes, max_prompt_len=256,
                                    max_len=max_len, page_size=16)

    def dispatch(eng, bp):
        reqs = [Request(rid=j, prompt=pr) for j, pr in enumerate(prompts[bp])]
        t0 = time.perf_counter()
        staged = eng.prefill_dispatch(reqs)
        torch.cuda.synchronize()
        if staged.shape != bp:
            fail(f"prefill memory: bucket {staged.shape}, not {bp}")
        return round((time.perf_counter() - t0) * 1e3, 3)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    eng = engine()
    torch.cuda.synchronize()
    built = torch.cuda.memory_allocated() - before
    staging = sum(a.numel() * a.element_size() for a in _leaves(eng._prefill_out))
    pools = {"tick": eng._tick_step.pool, "prefill": eng._prefill_steps.pool}
    pools.update({f"chunk {i}": s.pool for i, s in enumerate(eng._chunk_steps.values())
                  if s.pool is not eng._tick_step.pool})
    seen, walls, parts = {}, {}, {}
    ms = lambda x: round(x * 1e3, 3)  # noqa: E731
    with torch.no_grad():
        for i, bp in enumerate(buckets):
            first = dispatch(eng, bp)
            replay = dispatch(eng, bp)
            with graphs.eager():
                plain = dispatch(eng, bp)
            step = eng._prefill_steps.steps[bp]
            walls[f"{bp[0]}x{bp[1]}"] = (first, replay, plain)
            parts[f"{bp[0]}x{bp[1]}"] = tuple(ms(step.parts[k])
                                              for k in ("run", "record", "instantiate"))
            if i == 0 or i == len(buckets) - 1:
                seen[i] = dict(pools=_pool_bytes(pools),
                               allocated=torch.cuda.memory_allocated() - before,
                               reserved=torch.cuda.memory_reserved(),
                               peak=torch.cuda.max_memory_allocated() - before)
                torch.cuda.reset_peak_memory_stats()
    first, last = seen[0], seen[len(buckets) - 1]
    log(f"[memory] {arch.cfg.name} paged engine, {lanes} lanes of {max_len} rows: the build "
        f"took {built} bytes (the staging cache {staging}); pool bytes after the largest "
        f"bucket (8 x 256) {first['pools']}, after all {len(buckets)} buckets "
        f"{last['pools']}; allocated above the start {first['allocated']} / "
        f"{last['allocated']} bytes; reserved {first['reserved']} / {last['reserved']}; peak "
        f"above the start while the largest was served {first['peak']} bytes, while the "
        f"other {len(buckets) - 1} were {last['peak']}; {len(eng._prefill_steps.steps)} "
        f"prefill steps, {eng._prefill_steps.calls} calls, {eng._prefill_steps.replays} "
        f"replays")
    log(f"[first-dispatch] per bucket, ms of wall to the dispatch's end: (the first: a real "
        f"run, then the recording; the second: a replay; one under eager()): {walls}")
    log(f"[first-dispatch] per bucket, the first dispatch's parts, host ms: (the real run's "
        f"issue, the recording, the instantiation): {parts}")
    _expect_first_call_runs("prefill memory", eng._prefill_steps.steps.values(), "cuda")
    ptrs = [a.untyped_storage().data_ptr() for a in _leaves(eng._prefill_out)]
    if any([t.untyped_storage().data_ptr() for t in st.state[1:]] != ptrs
           for st in eng._prefill_steps.steps.values()):
        fail("prefill memory: a prefill step writes another cache than the staging cache")
    if first["pools"] is None:
        log("[memory] the allocator's snapshot names no pools: pool bytes not measured; "
            "gating the reserved bytes instead")
        grown = last["reserved"] - first["reserved"]
        if grown > 64 * mib:
            fail(f"prefill memory: the other buckets reserved {grown} more bytes")
    elif last["pools"]["prefill"] > 1.1 * first["pools"]["prefill"]:
        fail(f"prefill memory: the prefill pool grew from {first['pools']['prefill']} to "
             f"{last['pools']['prefill']} bytes with the buckets")
    if last["allocated"] - first["allocated"] > 64 * mib:
        fail("prefill memory: the memory allocated grew with the buckets")
    if last["peak"] > first["peak"] + 64 * mib:
        fail("prefill memory: the peak grew with the buckets")
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def phase_ssm_profile(arch, params, ticks: int = 4):
    """One full-width mamba2 prefill dispatch of 8 prompts (bucket 8 x
    2048) and a few decode ticks under the profiler, with ``ssd_scan``'s
    share of the prefill's device time."""
    import torch
    from repro_torch.serving.request import Request

    eng = _ssm_engine(arch, params)
    reqs = _ssm_requests(Request, arch.cfg.vocab_size)[:8]
    with torch.no_grad():
        rows = _window("mamba2 prefill dispatch of 8 prompts (bucket 8 x 2048)",
                       lambda: eng.prefill_dispatch(reqs), 1)
        if rows:
            scan = [(ms, c) for k, ms, c in rows if "ssd_scan" in k]
            busy = sum(ms for _k, ms, _c in rows)
            log(f"[profile]   ssd_scan: {sum(ms for ms, _c in scan)!r} ms over "
                f"{sum(c for _ms, c in scan)} launches, "
                f"{sum(ms for ms, _c in scan) / busy!r} of the prefill's device time")
        eng.commit_prefill(eng.prefill_dispatch(reqs))
        for _ in range(2):
            eng.decode_tick()  # warm
        _tick_walls("mamba2 decode tick, 8 lanes", eng, ticks)
        _window(f"mamba2 decode tick (graph replay), 8 lanes (mean of {ticks})",
                eng.decode_tick, ticks)
    torch.cuda.synchronize()


def phase_moe_profile(arch, params, ticks: int = 4):
    """One full-width deepseek-moe-16b decode tick of 8 lanes: its wall
    replayed and under ``graphs.eager()``, the replayed tick under the
    profiler (wall, busy time, kernels); then one tick under ``eager()``
    and the profiler: host wall time, device busy time, kernel count, the
    device time of the MoE layers (kernels launched inside ``moe``, through a
    ``record_function`` range around each call) and the least time that
    reading every routed expert's weights once takes (the capacity form
    runs every expert over its slots each tick)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import transformer as tf
    from repro_torch.serving import graphs
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request

    cfg = arch.cfg
    n_moe = cfg.n_layers - cfg.first_dense_layers
    expert_bytes = n_moe * cfg.n_experts * 3 * cfg.d_model * cfg.moe_d_ff * 2
    all_bytes = sum(a.numel() * a.element_size() for a in _leaves(params))
    eng = PagedInferenceEngine(arch, params, n_lanes=8, max_prompt_len=256,
                               max_len=512, page_size=16)
    inner = tf.moe

    def moe_range(*args):
        with record_function("moe_layer"):
            return inner(*args)

    with torch.no_grad():
        eng.commit_prefill(eng.prefill_dispatch(_requests(Request, cfg.vocab_size, n=8)))
        for _ in range(2):
            eng.decode_tick()  # warm
        _tick_walls(f"{cfg.name} decode tick, 8 lanes", eng, ticks)
        _window(f"{cfg.name} decode tick (graph replay), 8 lanes (mean of {ticks})",
                eng.decode_tick, ticks)
        # The MoE layers' ranges exist only where moe() is called: eagerly.
        with graphs.eager(), mock.patch.object(tf, "moe", moe_range), \
                profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.decode_tick()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    # The range is a CPU op whose device_time_total is its kernels' time,
    # and a device-side annotation whose time is the span the 27 ranges
    # cover on the device's timeline (kernels and the gaps between them).
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"
               and e.self_device_time_total > 0 and e.key != "moe_layer"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    moe_ms = sum(e.device_time_total for e in events
                 if e.key == "moe_layer" and e.device_type.name == "CPU") / 1e3
    span = sum(e.self_device_time_total for e in events
               if e.key == "moe_layer" and e.device_type.name == "CUDA") / 1e3
    log(f"[profile] {cfg.name} decode tick under eager() and the profiler: {wall!r} ms "
        f"wall, {busy!r} ms device busy ({busy / wall!r} busy share), "
        f"{sum(e.count for e in kernels)} kernels")
    log(f"[profile]   MoE layers ({n_moe}): "
        + (f"{moe_ms!r} ms of kernels ({moe_ms / busy!r} of the busy time), spanning "
           f"{span!r} ms of the device's timeline"
           if moe_ms else "device time not measured (no device time under the range)"))
    log(f"[profile]   byte bound: the routed experts' weights {expert_bytes} bytes, "
        f"{expert_bytes / HBM_BYTES_PER_S * 1e3!r} ms at {HBM_BYTES_PER_S:.3g} B/s; "
        f"every weight once, {all_bytes} bytes, {all_bytes / HBM_BYTES_PER_S * 1e3!r} ms")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3!r} ms  x{e.count}  {e.key[:90]}")
    torch.cuda.synchronize()


def _reduced_run(kind, arch, params, device):
    """One reduced-model serving run: ``kind`` is "paged" (phase 4's
    synchronous path), "dense" (the dense engine), "async" (paged,
    ``overlap=True``, ``chunk_tokens=8``, with prompts up to 30 tokens in
    their own template), "dense-async" (the dense engine under the same
    overlap + chunk traffic), "paged-prefix" (``prefix_share=True``,
    prompts that share a 16-token prefix), "paged-spill" (12 pages, half
    of full provisioning, with a spill pool), "paged-ssm" (the paged
    engine's dense-compute mode with a spill pool and ``lane_timeout``) or
    "paged-chaos" (the chaos phase at 4 lanes and pages of 8: a spill pool,
    ``ChaosEngine`` at fault rates of 0.25, so that six requests draw
    faults of both kinds, ``Resilience(quarantine_ticks=1)``, one request
    a prefill).  Returns (per-request streams, counters)."""
    from repro_torch.core.faults import ChaosEngine, ChaosPlan, chaos_seed
    from repro_torch.core.resilience import Resilience
    from repro_torch.core.strategies import GrowingUpperThreshold, PureAsync
    from repro_torch.serving.engine import HostSpillPool, InferenceEngine
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    rng = np.random.default_rng(1)
    lens = [int(n) for n in rng.integers(3, 17, size=6)]
    skw, ekw, prefix = {}, {}, np.zeros(0, np.int32)
    if kind == "paged-prefix":
        ekw = dict(prefix_share=True)
        prefix = rng.integers(1, 256, size=16).astype(np.int32)
    elif kind == "paged-spill":
        ekw = dict(n_pages=12, kv_spill=HostSpillPool(8), prefetch_pages=1)
    elif kind == "paged-ssm":
        ekw = dict(kv_spill=HostSpillPool(4))
        skw = dict(lane_timeout=6)
    elif kind == "paged-chaos":
        ekw = dict(kv_spill=HostSpillPool(8))
        skw = dict(resilience=Resilience(quarantine_ticks=1))
    if kind.startswith("dense"):
        eng = InferenceEngine(arch, params, n_lanes=4, max_prompt_len=16, max_len=48,
                              device=device)
    else:
        eng = PagedInferenceEngine(arch, params, n_lanes=4, max_prompt_len=16 + len(prefix),
                                   max_len=48, page_size=8, device=device, **ekw)
    if kind == "paged-chaos":
        eng = ChaosEngine(eng, ChaosPlan(seed=chaos_seed(0), decode_fault_rate=0.25,
                                         prefill_fault_rate=0.25))
    if kind.endswith("async"):
        lens += [21, 30]
        skw = dict(overlap=True, chunk_tokens=8)
    reqs = [Request(rid=i, prompt=np.concatenate(
                [prefix, rng.integers(1, 256, size=n)]).astype(np.int32),
                    max_new_tokens=24 if n <= 16 else 8,
                    template="long" if n > 16 else "default")
            for i, n in enumerate(lens)]
    sched = ContinuousBatchingScheduler(
        eng, strategy=PureAsync() if kind == "paged-chaos"
        else GrowingUpperThreshold(initial_upper=2), **skw)
    prefills = _prefill_counter(eng)
    for r in reqs:
        sched.submit(r)
    sched.producer_done()
    sched.run_until_drained()
    _expect_prefill_calls(f"reduced {arch.cfg.name} {kind}", eng, prefills, device)
    counters = {a: getattr(eng, a, None) for a in (
        "dispatches", "decode_steps", "prefill_calls", "kv_bytes_moved", "fused_folds",
        "prefix_hits", "page_evictions", "injected_decode_faults",
        "injected_prefill_faults")}
    for a in ("spec_chunks", "kv_spilled", "kv_restored", "quarantined", "prefill_retries"):
        counters[a] = getattr(sched.stats, a)
    return {r.rid: r.generated for r in reqs}, counters


def phase_reduced_check(name: str = "llama3-8b",
                        kinds=("paged", "dense", "async", "paged-prefix", "paged-spill",
                               "paged-chaos")):
    """A reduced model in float32: served on the card through the kernels
    and on the CPU through the plain versions, same weights and traffic,
    on each path of ``kinds`` (llama3-8b: the paged synchronous path, the
    dense engine, the paged overlap + chunk path, prefix sharing and an
    oversubscribed pool with spill; mamba2: the dense engine, synchronous
    and overlap + chunk, and the paged engine's dense-compute mode).  Per-request greedy streams
    and the engine's counters must be equal (float32 sums in another
    order differ by about 1e-6, far below the logit gaps argmax decides
    on; with one speculation bet in flight the scheduler joins it at every
    boundary, so overlap admits in a fixed order)."""
    import torch
    from repro_torch.kernels import registry
    from repro_torch.models.registry import get_arch

    arch = get_arch(name)
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    cpu_params = arch.init(seed=0, device="cpu")
    if arch.cfg.qkv_bias:  # the init's zeros would hide a missing add
        gen = torch.Generator().manual_seed(1)
        for b in ("bq", "bk", "bv"):
            a = cpu_params["layers"]["attn"][b]
            a.copy_(0.5 * torch.randn(a.shape, generator=gen))
    card_params = _to(cpu_params, "cuda")
    for kind in kinds:
        registry.reset_launches()
        card = _reduced_run(kind, arch, card_params, "cuda")
        torch.cuda.synchronize()
        launched = registry.launch_counts()
        cpu = _reduced_run(kind, arch, cpu_params, "cpu")
        same = card == cpu
        log(f"[check] reduced {name} f32 {kind}, card (kernels) vs CPU (plain): "
            f"greedy streams and counters {'equal' if same else 'DIFFER'} "
            f"({sum(len(g) for g in card[0].values())} tokens, {card[1]}; "
            f"card launches {launched})")
        if not same:
            log(f"[check]   card {card}")
            log(f"[check]   cpu  {cpu}")
            fail(f"reduced {name}, {kind}: kernel path differs from the plain path")
        if kind == "async" and not (card[1]["fused_folds"] and card[1]["spec_chunks"] >= 2
                                    and launched["decode_attention"] > 0):
            fail("reduced model, async: no fused chunk tick or no decode_attention launch")
        if kind == "dense-async" and card[1]["spec_chunks"] < 2:
            fail(f"reduced {name}, dense-async: fewer than two chunks on the spec thread")
        if arch.cfg.family in ("ssm", "hybrid") and launched["ssd_scan"] == 0:
            fail(f"reduced {name}, {kind}: the ssd_scan kernel never launched")
        c = card[1]
        if kind == "paged-prefix" and not (c["prefix_hits"] and launched["decode_attention"]):
            fail("reduced model, paged-prefix: no prefix hit or no decode_attention launch")
        if kind in ("paged-spill", "paged-ssm") and not (
                c["kv_restored"] == c["kv_spilled"] >= 1
                and (kind == "paged-ssm" or c["page_evictions"] >= 1)):
            fail(f"reduced {name}, {kind}: no eviction, or a spill without its restore")
        if kind == "paged-chaos" and not (
                c["injected_decode_faults"] and c["injected_prefill_faults"]
                and c["quarantined"] and c["prefill_retries"]
                and c["kv_restored"] == c["kv_spilled"]):
            fail("reduced model, paged-chaos: a fault kind never bit, no lane was "
                 "quarantined, or a salvaged lane was not restored")
    torch.cuda.synchronize()


def phase_reduced_steps(names=("hymba-1.5b", "qwen2-vl-2b", "seamless-m4t-medium"),
                        steps: int = 24):
    """The three new families reduced, in float32, on the card through the
    kernels and on the CPU through the plain versions, same weights and
    inputs: ``Arch.prefill`` (hymba: 40 tokens over its window of 16;
    qwen2-vl: 16 patches on a 4 x 4 grid and 24 text tokens; seamless: 24
    source frames, 7 target tokens) and ``steps`` greedy decode steps
    (hymba's rings wrap): the prefill's logits within 1e-4 and the greedy
    tokens equal."""
    import torch
    from repro_torch.models.registry import get_arch

    for name in names:
        arch = get_arch(name)
        arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
        cfg = arch.cfg
        cpu_params = arch.init(seed=0, device="cpu")
        out = {}
        for device in ("cuda", "cpu"):
            params = cpu_params if device == "cpu" else _to(cpu_params, device)
            if cfg.is_encoder_decoder:
                batch = _encdec_batch(cfg, device, b=2, src=24, tgt=7)
            elif cfg.frontend != "none":
                batch = _vlm_batch(cfg, params, device, b=2, side=4, text=24)
            else:
                toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 40))
                batch = {"tokens": torch.as_tensor(toks, device=device)}
            with torch.no_grad():
                first = arch.prefill(params, batch, max_len=72)[0].cpu()
            launches, _wall, toks = _greedy(arch, params, batch, steps, 72, device)
            out[device] = (first, toks, launches)
        diff = float((out["cuda"][0] - out["cpu"][0]).abs().max())
        same = bool(np.array_equal(out["cuda"][1], out["cpu"][1]))
        log(f"[check] reduced {name} f32 prefill + {steps} steps, card (kernels) vs CPU "
            f"(plain): prefill logits max abs diff {diff!r} (tolerance 1e-4), greedy tokens "
            f"{'equal' if same else 'DIFFER'}; card launches {out['cuda'][2]}")
        if diff > 1e-4 or not same or not out["cuda"][2]["decode_attention"]:
            fail(f"reduced {name}: the kernel path differs from the plain path")
    torch.cuda.synchronize()


def phase_reduced_bridge(name: str = "llama3-8b", n: int = 512):
    """The paper's layer on a reduced model in float32, on the card
    through the kernels and on the CPU through the plain versions: the
    three app traces through ``SchedulerQueryService`` (the vocabulary
    raised to 65536, since the bridge's prompt encoding emits tokens up to
    50020) and the ``model-service`` program over the embedding table with
    ``n`` ids.  Per-trace observables, per-query token tuples and drive
    counts must be equal on the card and on the CPU, synchronous =
    transformed on each; the service's results equal within rtol 1e-5."""
    import torch
    from repro_torch.core.app_traces import all_traces
    from repro_torch.kernels import registry
    from repro_torch.models.registry import get_arch

    arch = get_arch(name)
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(arch.cfg.reduced(),
                                                             vocab_size=65536))
    cpu_params = arch.init(seed=0, device="cpu")
    card_params = _to(cpu_params, "cuda")
    kw = dict(n_lanes=8, max_prompt_len=8, max_len=16, page_size=8)
    for tr in all_traces():
        registry.reset_launches()
        card = _trace_sides(arch, card_params, "cuda", tr, kw)
        torch.cuda.synchronize()
        launched = registry.launch_counts()
        cpu = _trace_sides(arch, cpu_params, "cpu", tr, kw)
        keys = ("observe", "log", "drives", "tokens", "prefills", "ticks")
        same = all(card[s][k] == cpu[s][k] for s in ("sync", "async") for k in keys)
        inner = all(c["sync"]["observe"] == c["async"]["observe"] and all(
            c["async"]["log"][q] == c["sync"]["log"][q] for q in c["async"]["log"])
            for c in (card, cpu))
        log(f"[check] reduced {name} f32 app trace {tr.name}, card vs CPU: observables, "
            f"token tuples and drives {'equal' if same else 'DIFFER'}; synchronous = "
            f"transformed {'on both' if inner else 'NOT on both'} (drives "
            f"{card['sync']['drives']} / {card['async']['drives']}, observables "
            f"{card['sync']['observe']}; card launches {launched})")
        if not (same and inner):
            fail(f"reduced {name}, app trace {tr.name}: card and CPU or synchronous and "
                 f"transformed differ")
        if not (launched["flash_attention"] and launched["paged_decode_attention"]):
            fail(f"reduced {name}, app trace {tr.name}: an attention kernel never launched")
    table = {d: p["embed"]["table"] for d, p in (("cuda", card_params), ("cpu", cpu_params))}
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    w = torch.randn(arch.cfg.d_model, generator=gen)
    ids = np.random.default_rng(0).integers(0, arch.cfg.vocab_size, n)
    runs = {d: _model_service_runs(table[d], w.to(d), ids, d) for d in ("cuda", "cpu")}
    for d in runs:
        _model_service_gates(f"reduced model-service ({d})", runs[d], n, d)
    card, cpu = runs["cuda"]["sync"], runs["cpu"]["sync"]
    close = np.allclose(card["log"], cpu["log"], rtol=1e-5, atol=1e-6)
    log(f"[check] reduced {name} f32 model-service, card vs CPU: totals {card['total']!r} / "
        f"{cpu['total']!r}, per-query results {'within' if close else 'NOT within'} rtol "
        f"1e-5; card batched_gather launches "
        f"{[r['launches'] for r in runs['cuda'].values()]}")
    if not close or abs(card["total"] - cpu["total"]) > 1e-5 * abs(cpu["total"]):
        fail(f"reduced {name}, model-service: the card's results differ from the CPU's")
    torch.cuda.synchronize()


# ----------------------------------------------------------------- phase 8
TRAIN_LAYERS = 4  # of llama3-8b's 32: what the step's state leaves room for


def _train_run(arch, params, fission: bool, steps: int, mb: int, batch: int, seq: int,
               profile: bool = False, eager: bool = False, batches=None,
               moments: str = "float32", step=None, state=None, retrace: bool = False):
    """``steps`` train steps of ``arch`` from ``params`` (written in place:
    the step donates them), ``AdamWConfig(lr=1e-3)``, ``microbatches=mb``,
    on ``batches`` or on ``SyntheticLMStream(vocab, seq, batch, seed=0)``
    through ``PrefetchLoader``, on the device of ``params``; the step
    compiled (one CUDA graph on the card, recorded at its first call), or
    under ``graphs.eager()`` with ``eager``; with ``retrace`` the fission
    plans are cleared before every step, so each traces its body again;
    ``step`` and ``state`` carry a step across calls.  Returns a dict:
    per step ``losses``, ``gnorms``, ``walls``, ``launches``, fission
    ``traces`` (seconds) and ``calls``
    (``trace_body`` calls), ``replays``; the peak memory allocated and
    reserved, the train graph pool's bytes, ``copies_in``, the final
    ``params``, ``state`` and ``step``.  ``profile``: one more step after
    those, under ``torch.profiler`` (``_window``), outside every count."""
    import torch
    from repro_torch.core import fission as fission_mod
    from repro_torch.data.pipeline import PrefetchLoader, SyntheticLMStream
    from repro_torch.kernels import registry
    from repro_torch.serving import graphs
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import TrainStepConfig, make_train_step

    traced, real_trace = [], fission_mod.trace_body

    def timed_trace(*args, **kwargs):  # this script's instrumentation only
        t0 = time.perf_counter()
        out = real_trace(*args, **kwargs)
        traced.append(time.perf_counter() - t0)
        return out

    device = next(_leaves(params)).device.type
    if step is None:
        init_state, step = make_train_step(
            arch, AdamWConfig(lr=1e-3, moments_dtype=moments),
            TrainStepConfig(microbatches=mb, fission=fission))
        state = init_state(params)
    if batches is None:
        batches = PrefetchLoader(SyntheticLMStream(arch.cfg.vocab_size, seq_len=seq,
                                                   batch=batch, seed=0),
                                 n_prefetch=2, max_steps=steps + int(profile))
    loader = iter(batches)
    out = {k: [] for k in ("losses", "gnorms", "walls", "launches", "traces", "calls",
                           "replays")}
    _sync(device)
    if device == "cuda":
        log(f"[train] device memory allocated before the first step (weights and "
            f"AdamW moments): {torch.cuda.memory_allocated() / 2**30!r} GiB")
        torch.cuda.reset_peak_memory_stats()
    mode = graphs.eager() if eager else contextlib.nullcontext()
    with mode, mock.patch.object(fission_mod, "trace_body", timed_trace):
        for _, b in zip(range(steps), loader):
            registry.reset_launches()
            del traced[:]
            if retrace:
                step.plans.clear()
            r0 = step.replays
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, b)
            out["losses"].append(float(metrics["loss"]))
            _sync(device)
            out["walls"].append(time.perf_counter() - t0)
            out["gnorms"].append(float(metrics["grad_norm"]))
            out["launches"].append(registry.launch_counts())
            out["traces"].append(sum(traced))
            out["calls"].append(len(traced))
            out["replays"].append(step.replays - r0)
        if profile:
            b = next(loader)
            if retrace:
                step.plans.clear()
            _window(f"one more train step ({'eager()' if eager else 'graph replay'}), "
                    f"fission={fission}", lambda: step(params, state, b), 1)
    cuda = device == "cuda"
    out.update(peak=torch.cuda.max_memory_allocated() if cuda else 0,
               reserved=torch.cuda.max_memory_reserved() if cuda else 0,
               pool=(_pool_bytes({"train": step.cache.pool}) or {}).get("train")
               if cuda and step.cache is not None else None,
               copies_in=step.copies_in, params=params, state=state, step=step)
    return out


def _train_log(label, smi, r, tokens: int) -> None:
    """One training run's lines: each step's loss, grad norm, wall, replays,
    fission trace and launches; memory, the graph pool and copies in."""
    for i, w in enumerate(r["walls"]):
        log(f"[{label}] on {smi}: step {i}: loss {r['losses'][i]!r}, grad norm "
            f"{r['gnorms'][i]!r}, wall {w!r} s, {tokens / w!r} tokens/s, replays "
            f"{r['replays'][i]}, fission trace {r['traces'][i]!r} s in {r['calls'][i]} "
            f"trace_body calls, launches {r['launches'][i]}")
    log(f"[{label}] peak device memory allocated {r['peak']} bytes "
        f"({r['peak'] / 2**30!r} GiB), reserved {r['reserved']} bytes "
        f"({r['reserved'] / 2**30!r} GiB); train graph pool {r['pool']} bytes; copies in "
        f"{r['copies_in']}")


def _against_eager(label, g, e, again) -> None:
    """A compiled run ``g`` against its ``eager()`` twin ``e`` (``_train_run``
    dicts) on the card: one replay a step from its second step (the first
    runs and records) and none eagerly; the same launches each step; the
    first loss bit for bit; every later loss, every grad norm and every
    parameter leaf bit for bit where two ``eager()`` runs repeat each other
    bit for bit, and within 1e-4 (relative to at least 1 for a loss or a
    norm; rtol and atol for a leaf) where they do not (sums with atomics:
    the embedding gradient's scatter-add, the MoE combine's backward).
    ``again()`` makes the second ``eager()`` run, only where ``g`` and
    ``e`` differ somewhere: where they agree everywhere the gate holds
    whatever it would show."""
    import torch

    n = len(e["losses"])
    log(f"[{label}] against eager(): losses {g['losses']} / {e['losses']}, grad norms "
        f"{g['gnorms']} / {e['gnorms']}; step walls {g['walls']} s / {e['walls']} s "
        f"(mean from the second step: {float(np.mean(g['walls'][1:]))!r} / "
        f"{float(np.mean(e['walls'][1:]))!r} s); replays a step {g['replays']} / "
        f"{e['replays']}")
    if g["replays"] != [0] + [1] * (n - 1) or any(e["replays"]):
        fail(f"{label}: replays a step {g['replays']}, eager() {e['replays']}")
    if g["launches"] != e["launches"]:
        fail(f"{label}: launches {g['launches']} differ from eager()'s {e['launches']}")
    if not all(np.isfinite(g["losses"] + g["gnorms"])):
        fail(f"{label}: a loss or grad norm is not finite")
    if g["losses"][0] != e["losses"][0]:
        fail(f"{label}: the first step's loss differs from eager()'s")

    def scalars(r):
        return r["losses"][1:] + r["gnorms"]

    sg, se = scalars(g), scalars(e)
    lg, le = list(_leaves(g["params"])), list(_leaves(e["params"]))
    ds = [i for i, (a, b) in enumerate(zip(sg, se)) if a != b]
    dl = [i for i, (a, b) in enumerate(zip(lg, le)) if not torch.equal(a, b)]
    log(f"[{label}] against eager(): {len(lg) - len(dl)} of {len(lg)} parameter leaves "
        f"({sum(int(a.numel()) for a in lg)} entries) bit for bit; "
        f"{len(sg) - len(ds)} of {len(sg)} later losses and grad norms bit for bit")
    if not ds and not dl:
        return
    e2 = again()
    s2, l2 = scalars(e2), list(_leaves(e2["params"]))
    bad = [f"scalar {i}" for i in ds
           if se[i] == s2[i] or abs(sg[i] - se[i]) > 1e-4 * max(1.0, abs(se[i]))]
    bad += [f"leaf {i}" for i in dl
            if torch.equal(le[i], l2[i])
            or not torch.allclose(lg[i].float(), le[i].float(), rtol=1e-4, atol=1e-4)]
    worst = max((float((lg[i].float() - le[i].float()).abs().max()) for i in dl), default=0.0)
    log(f"[{label}] a second eager() run: {sum(se[i] != s2[i] for i in ds)} of the {len(ds)} "
        f"differing scalars and {sum(not torch.equal(le[i], l2[i]) for i in dl)} of the "
        f"{len(dl)} differing leaves differ between the two eager() runs too; largest leaf "
        f"difference {worst!r}")
    if bad:
        fail(f"{label}: differs from eager() where two eager() runs repeat, or beyond 1e-4: "
             f"{bad[:8]}")


def _train_gates(label, launches, fission: bool, mb: int, layers: int) -> None:
    """Per step: ``batched_gather`` once when fissioned, once per microbatch
    otherwise; ``flash_attention`` once per layer per microbatch (its
    backward runs the plain version); no serving kernel."""
    for i, got in enumerate(launches):
        _expect(f"{label} step {i}", got, {
            "batched_gather": 1 if fission else mb, "flash_attention": mb * layers,
            "paged_decode_attention": 0, "decode_attention": 0, "ssd_scan": 0,
            "ssd_scan_bwd": 0})


def phase_train(smi, steps: int = 3, mb: int = 4, batch: int = 8, seq: int = 512):
    """The trainer at full width: llama3-8b (d_model 4096, 32 q / 8 kv
    heads, hd 128, d_ff 14336, vocab 128256, bf16), depth cut to
    ``TRAIN_LAYERS`` of 32, ``query_embedding=True``, ``remat=False``,
    through ``make_train_step(..., TrainStepConfig(microbatches=4,
    fission=...))``: fissioned, ``steps`` compiled steps (the first runs,
    traces the fission plan and records the step's CUDA graph; each later
    one replays it) and one more under the profiler, then the same under
    ``graphs.eager()`` with the plan traced again every step (the kept
    plan against a fresh trace); then the same unfissioned pair; each
    from the same weights (seed 0).  Gates: launches per step
    (``_train_gates``), one ``trace_body`` call in the compiled fissioned
    run and one a step in its twin, ``_against_eager`` for each pair, the first step's loss to 1e-5
    relative with and without fission (the forward is the same ops on the
    same rows; only the gradients differ)."""
    import torch
    from repro_torch.models.registry import get_arch

    arch = get_arch("llama3-8b")
    full = arch.cfg.n_layers
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, n_layers=TRAIN_LAYERS, query_embedding=True, remat=False))
    tokens = batch * seq
    out, firsts = {}, {}

    def run(fission: bool, eager: bool) -> dict:
        r = _train_run(arch, arch.init(seed=0, device="cuda"), fission, steps, mb, batch, seq,
                       profile=True, eager=eager, retrace=eager and fission)
        del r["state"], r["step"]
        gc.collect()
        torch.cuda.empty_cache()
        return r

    for fission in (True, False):
        pair = {}
        for eager in (False, True):
            label = ("train" if fission else "train-plain") + ("-eager" if eager else "")
            r = run(fission, eager)
            n_params = sum(int(a.numel()) for a in _leaves(r["params"]))
            log(f"[{label}] on {smi}: llama3-8b full width, depth cut to {TRAIN_LAYERS} of "
                f"{full} layers ({n_params} parameters, bf16, seed 0), query_embedding, "
                f"fission={fission}, {mb} microbatches of {batch // mb} x {seq} tokens, "
                f"{'compiled: one CUDA graph a step' if not eager else 'eager()'}"
                f"{', the fission plan traced again every step' if eager and fission else ''}")
            _train_log(label, smi, r, tokens)
            _train_gates(label, r["launches"], fission, mb, TRAIN_LAYERS)
            want = [1] * steps if eager and fission else \
                [1 if fission else 0] + [0] * (steps - 1)
            if r["calls"] != want:
                fail(f"{label}: trace_body calls per step {r['calls']}, not {want}")
            pair[eager] = r
        label = "train" if fission else "train-plain"
        _against_eager(label, pair[False], pair[True],
                       functools.partial(run, fission, True))
        out[label] = pair[False]["launches"]
        out[label + "-eager"] = pair[True]["launches"]
        firsts[fission] = pair[False]["losses"][0]
        del pair
        gc.collect()
        torch.cuda.empty_cache()
    first_f, first_p = firsts[True], firsts[False]
    log(f"[train] first-step loss with fission {first_f!r}, without {first_p!r}, "
        f"difference {abs(first_f - first_p)!r} (gate 1e-5 relative)")
    if abs(first_f - first_p) > 1e-5 * abs(first_p):
        fail("train: the first step's loss differs with and without fission")
    torch.cuda.synchronize()
    return {label: {k: sum(c[k] for c in launches) for k in launches[0]}
            for label, launches in out.items()}


def phase_train_reduced(name: str = "llama3-8b", steps: int = 3, mb: int = 4):
    """Reduced llama3-8b in float32 with ``query_embedding``: ``steps``
    train steps on the card (kernels; compiled, a replay a step from the
    second) and on the CPU (plain versions), fissioned and not, same
    weights and batches.  Losses and parameters must agree to 1e-4
    (float32 sums in another order, about 1e-6 per op) and the card's
    launches must be ``_train_gates``' counts."""
    import torch
    from repro_torch.models.registry import get_arch

    arch = get_arch(name)
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg.reduced(), query_embedding=True))
    params = arch.init(seed=0, device="cpu")
    for fission in (False, True):
        card = _train_run(arch, _to(params, "cuda"), fission, steps, mb, 8, 16)
        cpu = _train_run(arch, _clone(params), fission, steps, mb, 8, 16)
        dloss = max(abs(a - b) for a, b in zip(card["losses"], cpu["losses"]))
        dparam = max(float((a.cpu() - b).abs().max())
                     for a, b in zip(_leaves(card["params"]), _leaves(cpu["params"])))
        log(f"[check] reduced {name} f32 train, fission={fission}, card vs CPU: losses "
            f"{card['losses']} / {cpu['losses']}, max difference {dloss!r}; parameters "
            f"after {steps} steps max difference {dparam!r}; card launches "
            f"{card['launches']}, replays a step {card['replays']}")
        if dloss > 1e-4 or dparam > 1e-4:
            fail(f"reduced {name} train, fission={fission}: card differs from CPU")
        if card["replays"] != [0] + [1] * (steps - 1):
            fail(f"reduced {name} train: replays a step {card['replays']}")
        _train_gates(f"reduced train fission={fission}", card["launches"], fission, mb,
                     arch.cfg.n_layers)
    torch.cuda.synchronize()


def _train_expect(cfg, mb: int = 1) -> dict:
    """Kernel launches of one train step of ``cfg``, from the code: per
    microbatch, each attention (the encoder's, the decoder's self and
    cross attention) launches ``flash_attention`` once and each mixer
    ``ssd_scan`` once in the forward, and ``remat`` recomputes each block's
    forward in the backward, which launches ``ssd_scan_bwd`` once a mixer
    (the flash op's backward recomputes the plain version: no launch); no
    serving kernel, and ``batched_gather`` only with ``query_embedding``,
    which none of these configs sets."""
    fwd = 2 if cfg.remat else 1
    layers = cfg.n_layers
    attn = 0 if cfg.family == "ssm" else layers
    if cfg.is_encoder_decoder:
        attn = cfg.n_enc_layers + 2 * layers
    mixers = layers if cfg.family == "ssm" or cfg.hybrid else 0
    return {"flash_attention": mb * fwd * attn, "ssd_scan": mb * fwd * mixers,
            "ssd_scan_bwd": mb * mixers, "paged_decode_attention": 0,
            "decode_attention": 0, "batched_gather": 0}


class _StepLaunches:
    """Wraps ``launch.train``'s ``make_train_step`` so every step's kernel
    launches are counted from 0, beside its replays and grad norm; ``take``
    hands over a run's record with its step's copies in and graph pool
    (this script's instrumentation only)."""

    def __init__(self):
        self.per_step, self.replays, self.gnorms, self.step = [], [], [], None

    def __call__(self, real):
        from repro_torch.kernels import registry

        def make(*args, **kwargs):
            init_state, step = real(*args, **kwargs)
            self.step = step

            def counted(params, state, batch):
                registry.reset_launches()
                r0 = step.replays
                out = step(params, state, batch)
                self.per_step.append(registry.launch_counts())
                self.replays.append(step.replays - r0)
                self.gnorms.append(float(out[2]["grad_norm"]))
                return out

            return init_state, counted

        return make

    def take(self) -> dict:
        """The last wrapped run's launches, replays and grad norms a step,
        its step's copies in and graph pool bytes; forgets the step."""
        step, self.step = self.step, None
        pool = (_pool_bytes({"train": step.cache.pool}) or {}).get("train") \
            if step.cache is not None and step.cache.pool is not None else None
        out = dict(launches=self.per_step, replays=self.replays, gnorms=self.gnorms,
                   copies_in=step.copies_in, pool=pool)
        self.per_step, self.replays, self.gnorms = [], [], []
        return out


TRAIN_SSM = ["--arch", "mamba2-1.3b", "--batch", "8", "--seq", "2048", "--moments", "int8",
             "--log-every", "1"]


def _overlap_report(label, out, tokens: int) -> None:
    """Each step's wall beside whether a checkpoint write ran during it."""
    writes = [(w["start"], w["end"]) for w in out["writes"]]
    for k, (t0, t1) in enumerate(out["walls"]):
        busy = any(w0 < t1 and t0 < w1 for w0, w1 in writes)
        log(f"[{label}] step {out['start'] + k + 1}: wall {t1 - t0!r} s, "
            f"{tokens / (t1 - t0)!r} tokens/s, loss {out['losses'][k]!r}, "
            f"{'overlapped a checkpoint write' if busy else 'no write in flight'}")


def phase_train_ssm(smi):
    """Phase 8b, ``train-ssm``: the training launcher at full width,
    ``repro_torch.launch.train`` in this process on mamba2-1.3b (48
    layers, bf16, seed 0, remat) at 8 x 2048 with int8 moments, its step
    compiled (``donate=False``: one CUDA graph in place on the step's own
    parameters and moments, recorded at the first step, which each call
    copies the tensors passed in into and copies out of): ``--steps 4
    --ckpt-every 2`` into a directory under ``build/``,
    then ``--steps 6``, which restores step 4 and takes two more.  Their
    ``eager()`` twins: ``--steps 4`` without checkpoints, and ``--steps
    6`` from the same checkpoint of step 4 (run before the compiled
    resume; its own checkpoint of step 6 removed after it).  Gates: each
    step's launches exactly ``_train_expect``'s; ``_against_eager`` for
    both runs; a copy in every step; the checkpoint of step
    4 read back equal, bit for bit, to the parameters and int8 state the
    first run ended with.  Logs tokens/s, step walls, one more step of
    each compiled run under the profiler, memory, the graph
    pool, bytes written, how long each ``save()`` blocked the loop against
    how long its write took on the runtime's thread, and which steps
    overlapped a write.  Fails before writing if the disk holds less than
    two checkpoints and a gigabyte; removes the directory at the end."""
    import shutil

    import torch
    from repro_torch.data.pipeline import SyntheticLMStream
    from repro_torch.launch import train as train_mod
    from repro_torch.models.registry import get_arch
    from repro_torch.serving import graphs

    arch = get_arch("mamba2-1.3b")
    want = _train_expect(arch.cfg)
    ckpt = ROOT / "build" / "train-ssm-ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    # A checkpoint: float32 parameters, int8 m and v with a float32 scale
    # per 64 entries each; two on disk at once, and a gigabyte to spare.
    one = arch.cfg.param_count() * (4 + 2 * (1 + 4 / 64))
    free = shutil.disk_usage(ckpt).free
    log(f"[train-ssm] {free} bytes free under {ckpt}; a checkpoint takes about {one:.0f}")
    if free < 2 * one + 2**30:
        fail(f"train-ssm: {free} bytes free under {ckpt}, two checkpoints need {2 * one:.0f}")
    counter = _StepLaunches()

    def launch(steps: int, eager: bool, with_ckpt: bool, profile: bool = True) -> dict:
        argv = TRAIN_SSM + ["--steps", str(steps)]
        if with_ckpt:
            argv += ["--ckpt-every", "2", "--ckpt-dir", str(ckpt)]
        log(f"[train-ssm] python -m repro_torch.launch.train {' '.join(argv)}"
            f"{' under graphs.eager()' if eager else ''}")
        torch.cuda.reset_peak_memory_stats()
        with mock.patch.object(train_mod, "make_train_step",
                               counter(train_mod.make_train_step)), \
                (graphs.eager() if eager else contextlib.nullcontext()):
            out = train_mod.main(argv)
            step, record = counter.step, counter.take()
            if profile:  # one more step of the run's own step, outside its counts
                batch = SyntheticLMStream(arch.cfg.vocab_size, seq_len=2048,
                                          batch=8).batch_at(steps)
                _window(f"train-ssm: one more step ({'eager()' if eager else 'graph replay'}"
                        f", a copy in and out)", lambda: step(out["params"], out["state"],
                                                             batch), 1)
            del step
        out.update(record, peak=torch.cuda.max_memory_allocated(),
                   reserved=torch.cuda.max_memory_reserved())
        tag = "train-ssm" + ("-eager" if eager else "")
        if with_ckpt:
            _overlap_report(tag, out, 8 * 2048)
        out["walls"] = [t1 - t0 for t0, t1 in out["walls"]]
        log(f"[{tag}] on {smi}: run to step {steps}: losses {out['losses']}, grad norms "
            f"{out['gnorms']}, step walls {out['walls']} s, replays a step {out['replays']}, "
            f"copies in {out['copies_in']}; peak device memory allocated {out['peak']} bytes "
            f"({out['peak'] / 2**30!r} GiB), reserved {out['reserved']} bytes "
            f"({out['reserved'] / 2**30!r} GiB); train graph pool {out['pool']} bytes")
        if not all(np.isfinite(out["losses"])):
            fail(f"{tag}: a loss is not finite: {out['losses']}")
        for i, got in enumerate(out["launches"]):
            _expect(f"{tag} step {out['start'] + i + 1}", got, want)
        if with_ckpt:
            for step, blocked in out["saves"]:
                w = next(w for w in out["writes"] if w["step"] == step)
                log(f"[{tag}] checkpoint of step {step}: save() blocked the loop "
                    f"{blocked!r} s; the write took {w['end'] - w['start']!r} s on the "
                    f"runtime's thread, {w['bytes']} bytes")
        gc.collect()
        torch.cuda.empty_cache()
        return out

    totals = {}
    try:
        first = launch(4, False, True)
        _check_readback(ckpt, first)
        del first["state"]
        shutil.rmtree(ckpt / "step_0000000002")  # two checkpoints on disk at most
        twin2 = launch(6, True, True, profile=False)
        del twin2["state"]
        shutil.rmtree(ckpt / "step_0000000006")  # the compiled resume restores step 4
        (ckpt / "LATEST").unlink()
        second = launch(6, False, True)
        del second["state"]
        if any(r["start"] != 4 or len(r["losses"]) != 2 for r in (second, twin2)):
            fail(f"train-ssm: the second runs started at {second['start']} / "
                 f"{twin2['start']} and took {len(second['losses'])} / "
                 f"{len(twin2['losses'])} steps; expected a restore of step 4 and 2 steps")
        def resume_again():  # the same restore of step 4 under eager()
            shutil.rmtree(ckpt / "step_0000000006")
            (ckpt / "LATEST").unlink()
            return launch(6, True, True, profile=False)

        _against_eager("train-ssm resumed", second, twin2, resume_again)
        del second["params"], twin2["params"]
        twin1 = launch(4, True, False, profile=False)
        del twin1["state"]
        _against_eager("train-ssm", first, twin1,
                       functools.partial(launch, 4, True, False, profile=False))
        if first["copies_in"] != 4 or second["copies_in"] != 2:
            fail("train-ssm: a compiled run without donation did not copy in every step")
        runs = (first, second)
        totals = {k: sum(c[k] for r in runs for c in r["launches"])
                  for k in first["launches"][0]}
        log(f"[train-ssm] launches per step {first['launches'][0]} (expected {want}); "
            f"losses {first['losses'] + second['losses']}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.synchronize()
    return {"train-ssm": totals}


def _check_readback(ckpt, out) -> None:
    """The newest checkpoint (step 4) read back from disk equals what the
    run ended with, bit for bit: bf16 parameters, int8 blocks and float32
    scales of both moments, the step count."""
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager, _flatten_with_paths

    with CheckpointManager(ckpt) as mgr:
        step, params, state = mgr.restore_latest(out["params"], out["state"])
    saved = _flatten_with_paths({"params": out["params"], "state": out["state"]})
    read = _flatten_with_paths({"params": params, "state": state})
    bad = [k for (k, a), (_k, b) in zip(saved, read)
           if a.dtype != b.dtype or not torch.equal(a, b)]
    log(f"[train-ssm] checkpoint of step {step} read back: {len(read)} tensors, "
        f"{sum(int(t.numel()) for _k, t in read)} elements, {len(bad)} differ")
    if step != 4 or bad or len(saved) != len(read):
        fail(f"train-ssm: the checkpoint of step {step} differs from what was saved: {bad[:5]}")


HYBRID_TRAIN_LAYERS = 16  # 8c: hymba-1.5b at full width, 16 of its 32 layers (32 until PR 26)


def phase_train_hybrid(smi, steps: int = 3, batch: int = 8, seq: int = 2048):
    """Phase 8c, ``train-hybrid``: hymba-1.5b at full width cut to
    ``HYBRID_TRAIN_LAYERS`` hybrid layers (bf16, seed 0, remat), ``steps`` compiled train steps of
    ``batch`` x ``seq`` tokens through ``make_train_step`` and one more
    under the profiler, then the same under ``graphs.eager()``: the banded
    flash kernel and ``ssd_scan`` forward, ``ssd_scan_bwd`` in the
    backward.  Gates: each step's launches exactly ``_train_expect``'s and
    ``_against_eager``.  Logs the step walls and the memory (the flash
    op's backward builds the plain version's (8, 25, 2048, 2048) float32
    scores, a layer at a time)."""
    import torch

    arch = _cut("hymba-1.5b", n_layers=HYBRID_TRAIN_LAYERS)
    want = _train_expect(arch.cfg)
    pair = {}

    def run(eager: bool) -> dict:
        r = _train_run(arch, arch.init(seed=0, device="cuda"), False, steps, 1, batch, seq,
                       profile=True, eager=eager)
        del r["state"], r["step"]
        gc.collect()
        torch.cuda.empty_cache()
        return r

    for eager in (False, True):
        label = "train-hybrid" + ("-eager" if eager else "")
        r = run(eager)
        _train_log(label, smi, r, batch * seq)
        for i, got in enumerate(r["launches"]):
            _expect(f"{label} step {i}", got, want)
        pair[eager] = r
    _against_eager("train-hybrid", pair[False], pair[True], functools.partial(run, True))
    launches = pair[False]["launches"]
    del pair
    gc.collect()
    torch.cuda.empty_cache()
    return {"train-hybrid": {k: sum(c[k] for c in launches) for k in launches[0]}}


TRAIN_FAMILIES = ("mamba2-1.3b", "hymba-1.5b", "deepseek-moe-16b", "qwen2-vl-2b",
                  "seamless-m4t-medium")


def _train_batch(cfg, seed: int, b: int = 4, s: int = 24) -> dict:
    """A numpy training batch of ``cfg``'s family (``SyntheticLMStream``
    makes tokens only): tokens; or patch embeddings on a 4 x 4 grid at
    temporal position 0 and text after it, with (3, B, S) positions; or
    source frames and target tokens.  Labels are the tokens."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    if cfg.is_encoder_decoder:
        src = rng.standard_normal((b, 20, cfg.d_model)).astype(np.float32)
        return {"src_embeds": src, "tgt_tokens": tokens, "labels": tokens}
    if cfg.frontend != "none":
        pos = np.zeros((3, b, s), np.int32)
        pos[1, :, :16], pos[2, :, :16] = np.arange(16) // 4, np.arange(16) % 4
        pos[:, :, 16:] = 4 + np.arange(s - 16)
        emb = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        return {"embeds": emb, "positions": pos, "labels": tokens}
    return {"tokens": tokens, "labels": tokens}


def _family_steps(arch, params, steps: int, moments: str = "float32", start: int = 0,
                  state=None, step=None, eager: bool = False, profile: bool = False):
    """``steps`` donating train steps of ``arch`` from ``params`` on their
    device (``_train_run``, one microbatch), batches ``_train_batch(cfg,
    start + i)``; ``step`` and ``state`` carry a step across calls."""
    batches = [_train_batch(arch.cfg, start + i) for i in range(steps + int(profile))]
    return _train_run(arch, params, False, steps, 1, 0, 0, profile=profile, eager=eager,
                      batches=batches, moments=moments, step=step, state=state)


def phase_train_families(names=TRAIN_FAMILIES, steps: int = 3):
    """Reduced, float32: ``steps`` train steps of each family on the card,
    compiled (kernels; one more replay under the profiler) and under
    ``graphs.eager()``, and on the CPU (plain versions) from the same
    weights and batches: the compiled run against its ``eager()`` twin
    (``_against_eager``), and against the CPU's losses and parameters
    within 1e-4 (float32 sums in another order, about 1e-6 an op; the
    embedding and MoE gradients sum with atomics on the card), the card's
    launches ``_train_expect``'s."""
    import torch
    from repro_torch.models.registry import get_arch

    for name in names:
        arch = get_arch(name)
        arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
        params = arch.init(seed=0, device="cpu")
        card = _family_steps(arch, _to(params, "cuda"), steps, profile=True)
        twin = _family_steps(arch, _to(params, "cuda"), steps, eager=True, profile=True)
        cpu = _family_steps(arch, _clone(params), steps + 1)
        _train_log(f"train {name} reduced", "the card", card, 4 * 24)
        _against_eager(f"train {name} reduced", card, twin,
                       lambda: _family_steps(arch, _to(params, "cuda"), steps, eager=True,
                                             profile=True))
        dloss = max(abs(a - b) for a, b in zip(card["losses"], cpu["losses"]))
        dparam = max(float((a.cpu() - b).abs().max())
                     for a, b in zip(_leaves(card["params"]), _leaves(cpu["params"])))
        log(f"[check] reduced {name} f32 train, card vs CPU: losses {card['losses']} / "
            f"{cpu['losses'][:steps]}, max difference {dloss!r}; parameters after "
            f"{steps + 1} steps max difference {dparam!r}; card launches {card['launches']}")
        if dloss > 1e-4 or dparam > 1e-4:
            fail(f"reduced {name} train: card differs from CPU")
        for i, got in enumerate(card["launches"]):
            _expect(f"reduced {name} train step {i}", got, _train_expect(arch.cfg))
        del card, twin, cpu
        gc.collect()
    torch.cuda.synchronize()


def phase_train_restart(name: str = "mamba2-1.3b", steps: int = 4, at: int = 2):
    """The restart on the card: reduced ``name`` (float32, int8 moments)
    trained ``steps`` compiled steps with an asynchronous checkpoint after
    step ``at`` (its snapshot taken before the next replay writes the
    parameters in place), then restored from it into fresh tensors and
    continued through the same step, which copies them in (one copy in)
    and replays.  The first resumed step's loss equals the uninterrupted
    run's bit for bit (the same parameters and batch through a
    deterministic forward); later steps within 1e-5 relative, since the
    embedding gradient's scatter-add uses atomics, so parameters after a
    step may differ in their last bits between runs."""
    import tempfile

    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.registry import get_arch
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import TrainStepConfig, make_train_step

    arch = get_arch(name)
    arch = dataclasses.replace(arch, cfg=arch.cfg.reduced())
    init_state, step = make_train_step(arch, AdamWConfig(lr=1e-3, moments_dtype="int8"),
                                       TrainStepConfig())
    params = arch.init(seed=0, device="cuda")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        with CheckpointManager(d) as mgr:
            head = _family_steps(arch, params, at, "int8", step=step, state=init_state(params))
            mgr.save(at, head["params"], head["state"])
            tail = _family_steps(arch, head["params"], steps - at, "int8", at, head["state"],
                                 step=step)
            mgr.wait()
            fresh = arch.init(seed=1, device="cuda")
            _s, p, st = mgr.restore_latest(fresh, init_state(fresh))
        resumed = _family_steps(arch, p, steps - at, "int8", at, st, step=step)
    log(f"[check] reduced {name} restart on the card: uninterrupted losses "
        f"{head['losses'] + tail['losses']}, resumed from step {at} into fresh tensors "
        f"through the same compiled step: {resumed['losses']}; replays a step "
        f"{head['replays'] + tail['replays']} / {resumed['replays']}; copies in "
        f"{resumed['copies_in']}")
    if resumed["losses"][0] != tail["losses"][0]:
        fail(f"restart: the first resumed step's loss {resumed['losses'][0]!r} differs from "
             f"the uninterrupted run's {tail['losses'][0]!r}")
    if any(abs(a - b) > 1e-5 * abs(b) for a, b in zip(resumed["losses"], tail["losses"])):
        fail("restart: a resumed loss differs beyond 1e-5 relative")
    if resumed["copies_in"] != 1 or resumed["replays"] != [1] * (steps - at):
        fail("restart: the restored tensors were not copied in once and replayed")
    torch.cuda.synchronize()


def phase_fission(v: int = 10_000, d: int = 256, n: int = 2048, device: str = "cuda"):
    """The port's twin of ``benchmarks/bench_fission.py::device_fission``
    at its full size: a loop of ``n`` iterations, each gathering one row of
    a (v, d) float32 table and adding its sum to the carry, run as the
    plain ``scan`` (one ``batched_gather`` launch per iteration) and
    through ``fission_scan`` (one launch).  Results must agree to 1e-4
    relative, as in the benchmark."""
    import torch
    from repro_torch.core.fission import fission_scan, scan
    from repro_torch.core.query import async_query, table_gather_spec
    from repro_torch.kernels import registry

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    table = torch.randn((v, d), generator=gen, device=device)
    ids = ((torch.arange(n, device=device) * 37) % v).to(torch.int32)

    def body(c, i):
        return c + async_query(table_gather_spec, table, i).sum(), None

    res = {}
    for label, fn in (("scan", scan), ("fission_scan", fission_scan), ("scan", scan),
                      ("fission_scan", fission_scan)):
        registry.reset_launches()
        _sync(device)
        t0 = time.perf_counter()
        c, _ = fn(body, torch.zeros((), device=device), ids)
        _sync(device)
        res.setdefault(label, []).append(
            (float(c), time.perf_counter() - t0, registry.launch_counts()["batched_gather"]))
    log(f"[fission] table {v} x {d} f32, {n} iterations, (result, wall s, batched_gather "
        f"launches) in turns: {res}")
    for label, want in (("scan", n), ("fission_scan", 1)):
        if any(k != want for _c, _w, k in res[label]):
            fail(f"fission: {label} launched batched_gather {res[label]}, expected {want}")
    a, b = res["scan"][0][0], res["fission_scan"][0][0]
    if not abs(a - b) <= 1e-4 * abs(a):
        fail(f"fission: scan {a!r} and fission_scan {b!r} differ beyond 1e-4 relative")
    log(f"[fission] wall: scan {res['scan'][1][1]!r} s, fission_scan "
        f"{res['fission_scan'][1][1]!r} s (second turn of each)")
    _sync(device)


# ---------------------------------------------------------------- phase 12
DEPTH_ENGINE = dict(n_lanes=8, max_prompt_len=256, max_len=576)  # 12a; the paged one in pages of 16
DEPTH_CHUNK = 256
DEPTHS = (1, 2, 4)


def _depth_requests(Request, vocab: int, n: int = 48, n_templates: int = 6):
    """12a's traffic, ``benchmarks/bench_lanes.py::run_overlap_depth``'s
    shape at full width: ``n`` single-request bets over ``n_templates``
    templates (round robin), prompts of 128-256 tokens and three of
    320-512, longer than ``max_prompt_len`` 256 (chunked), generation
    lengths staggered over 16-48 tokens, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 257, size=n)
    for at, m in zip((5, 20, 35), rng.integers(320, 513, size=3)):
        lens[at] = m
    news = rng.integers(16, 49, size=n)
    return [Request(rid=i, prompt=rng.integers(0, vocab, size=int(m)).astype(np.int32),
                    max_new_tokens=int(k), template=f"t{i % n_templates}")
            for i, (m, k) in enumerate(zip(lens, news))]


def _depth_drives(label, arch, params, depth: int, paged: bool, device: str, drives: int,
                  want=None):
    """``drives`` drives of 12a's traffic at ``spec_depth`` ``depth`` on one
    fresh engine (``PureAsync``, ``overlap=True``, ``chunk_tokens`` 256):
    every request's greedy stream equal to ``want``'s (by request), no
    speculation crash, the ledger balanced, exact launches against the
    engine's counters (``flash_attention`` = prefill dispatches x L,
    aborted bets included; ``decode_attention`` = tokens through the
    decode path x L, plus decode ticks x L on the dense engine;
    ``paged_decode_attention`` = decode ticks x L), and through ``_drive``
    every dispatch a call of its compiled step, each step's first call a
    real run and the others replays.  Returns (the first drive's launches,
    its streams, [(tokens/s, TTFT p50 ms) per drive])."""
    import torch
    from repro_torch.core.strategies import PureAsync
    from repro_torch.serving.engine import InferenceEngine
    from repro_torch.serving.paged_kv import PagedInferenceEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import ContinuousBatchingScheduler

    L = arch.cfg.n_layers
    if paged:
        eng = PagedInferenceEngine(arch, params, page_size=16, device=device, **DEPTH_ENGINE)
    else:
        eng = InferenceEngine(arch, params, device=device, **DEPTH_ENGINE)
    n_prefill = _count_calls(eng, "_prefill_step")
    n_extend = _count_calls(eng, "_extend")
    fed = _count_calls(eng, "_extend", lambda _c, toks, _l: int(toks.shape[1]))
    first, facts = None, []
    for i in range(drives):
        lab = label if i == 0 else f"{label}-warm{i}"
        sched = ContinuousBatchingScheduler(eng, strategy=PureAsync(), overlap=True,
                                            spec_depth=depth, chunk_tokens=DEPTH_CHUNK)
        c0 = (n_prefill[0], n_extend[0], fed[0], eng.dispatches, eng.decode_steps,
              getattr(eng, "fused_folds", 0))
        reqs = _depth_requests(Request, arch.cfg.vocab_size)
        launches, wall = _drive(lab, eng, sched, reqs, device)
        pre, ext, tok, disp, ticks, folds = (b - a for a, b in zip(c0, (
            n_prefill[0], n_extend[0], fed[0], eng.dispatches, eng.decode_steps,
            getattr(eng, "fused_folds", 0))))
        st = sched.stats
        streams = RUNS[lab]["streams"]
        ttft = float(np.median([r.metrics.ttft for r in reqs])) * 1e3
        facts.append((RUNS[lab]["tokens"] / wall, ttft))
        log(f"[{lab}] spec_depth {depth}: spec_dispatched {st.spec_dispatched}, "
            f"spec_committed {st.spec_committed}, spec_aborted {st.spec_aborted}, "
            f"spec_chunks {st.spec_chunks}, spec_crashes {st.spec_crashes}, fused_folds "
            f"{folds}; prefill dispatches {pre}, chunk extends {ext}, tokens through the "
            f"decode path {tok}; settle order (tick, admitted) {st.admission_trace}")
        if st.spec_crashes or st.spec_dispatched != st.spec_committed + st.spec_aborted:
            fail(f"{lab}: spec_crashes {st.spec_crashes}, or spec_dispatched != "
                 "spec_committed + spec_aborted")
        if st.spec_chunks < 1 or disp != pre + ext + ticks - folds:
            fail(f"{lab}: no chunk, or dispatches != prefills + extends + ticks - fused folds")
        want_launches = {"flash_attention": pre * L, "ssd_scan": 0,
                         "decode_attention": (tok if paged else tok + ticks) * L,
                         "paged_decode_attention": ticks * L if paged else 0}
        _expect(lab, launches, want_launches)
        _expect_chunk_calls(lab, tok, device)
        want = streams if want is None else want
        bad = [r.rid for r, a, b in zip(reqs, streams, want) if a != b]
        if bad:
            fail(f"{lab}: greedy streams differ from depth 1's for requests {bad}")
        first = (launches, streams) if first is None else first
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return first[0], first[1], facts


def phase_depth(arch, params, device="cuda") -> dict:
    """12a: depth k over the compiled engines, llama3-8b at full width.
    ``spec_depth`` 1, 2 and 4 on ``PagedInferenceEngine`` (fused chunk
    ticks) and 2 on the dense ``InferenceEngine``, each fresh and warmed
    (a second drive of the same engine), then depth 2 on the paged engine
    under ``graphs.eager()``: every stream equal to the paged depth-1
    run's, request by request.  Returns launches by path."""
    from repro_torch.serving import graphs

    paths, facts = {}, {}
    runs = [(f"depth-{d}", d, True) for d in DEPTHS] + [("depth-2-dense", 2, False)]
    want = None
    for label, depth, paged in runs:
        paths[label], streams, facts[label] = _depth_drives(
            label, arch, params, depth, paged, device, 1 + 1, want)
        want = streams if want is None else want
    with graphs.eager():
        paths["depth-2-eager"], _s, facts["depth-2-eager"] = _depth_drives(
            "depth-2-eager", arch, params, 2, True, device, 1, want)
    log(f"[depth] tokens/s and TTFT p50 ms (fresh, warmed) by run: {facts}")
    return paths


def _engines_made():
    """Patch the engines' ``_compile`` to collect every engine built while
    open, and ``_extend`` to count the tokens it feeds (this script's
    instrumentation): yields (engines, fed)."""
    from repro_torch.serving.engine import InferenceEngine

    made, fed = [], [0]
    compile_, extend = InferenceEngine._compile, InferenceEngine._extend

    def compile_and_keep(self):
        made.append(self)
        return compile_(self)

    def extend_and_count(self, cache, toks, lengths):
        fed[0] += int(np.asarray(toks).shape[1])
        return extend(self, cache, toks, lengths)

    return (mock.patch.object(InferenceEngine, "_compile", compile_and_keep),
            mock.patch.object(InferenceEngine, "_extend", extend_and_count), made, fed)


def _example_part(label, arch, fn, device="cuda"):
    """Run one part of the serving example with every launch count set to
    0 before and read after; every engine it built ran each compiled step
    once for real and replayed it after, and launched exactly one
    ``flash_attention`` a layer per prefill dispatch and one
    ``decode_attention`` a layer per decode tick and per token fed through
    the decode path.  Returns (fn's result, launches)."""
    from repro_torch.kernels import registry

    L = arch.cfg.n_layers
    p_compile, p_extend, made, fed = _engines_made()
    _sync(device)
    registry.reset_launches()
    t0 = time.perf_counter()
    with p_compile, p_extend:
        out = fn()
    _sync(device)
    wall = time.perf_counter() - t0
    launches = registry.launch_counts()
    ticks = sum(e._tick_step.calls for e in made)
    prefills = sum(e._prefill_steps.calls for e in made)
    chunks = sum(s.calls for e in made for s in e._chunk_steps.values())
    for e in made:
        _expect_first_call_runs(label, _steps_of(e), device)
    if device == "cuda" and chunks != fed[0]:
        fail(f"{label}: {chunks} chunk-step calls for {fed[0]} tokens fed through _extend")
    _expect(label, launches, {"flash_attention": prefills * L,
                              "decode_attention": (ticks + fed[0]) * L,
                              "paged_decode_attention": 0, "ssd_scan": 0})
    log(f"[{label}] {len(made)} engines, {ticks} decode ticks, {prefills} prefill "
        f"dispatches, {fed[0]} tokens through the decode path in {wall!r} s; launches "
        f"{launches}")
    return out, launches


def phase_example_serving(arch, params, device="cuda") -> dict:
    """12b: ``repro_torch.examples.serve_continuous_batching``'s parts on
    ``arch`` at full width, at the example's lane sizes (``max_prompt_len``
    16, ``max_len`` 48): the three strategies, the mixed-template lanes
    (each template's bucket its own: homogeneous admissions), the overlap
    demo with ``kv_shares`` from ``lane_weights``, and the depth-2 demo
    (its oversized prompt chunked, every spilled lane restored).  Returns
    launches by part."""
    from repro_torch.examples import serve_continuous_batching as ex
    from repro_torch.serving.engine import proportional_shares

    vocab = arch.cfg.vocab_size
    rng = np.random.default_rng(0)
    paths = {}

    def in_vocab(label, done, n):
        if len(done) != n or not all(r.done and r.generated and
                                     all(0 <= t < vocab for t in r.generated) for r in done):
            fail(f"{label}: not every request finished with in-vocabulary tokens")

    runs, paths["example-strategies"] = _example_part(
        "example-strategies", arch, lambda: ex.compare_strategies(arch, params, rng,
                                                                  verbose=False, device=device),
        device)
    for name, (done, eng, dt) in runs.items():
        in_vocab(f"example {name}", done, 24)
        toks = sum(len(r.generated) for r in done)
        log(f"[example-strategies] {name}: {toks / dt!r} tokens/s, TTFT p50 "
            f"{float(np.median([r.metrics.ttft for r in done])) * 1e3!r} ms, decode steps "
            f"{eng.decode_steps}, prefills {eng.prefill_calls} (warmed engine)")
    (done, sched, eng), paths["example-lanes"] = _example_part(
        "example-lanes", arch, lambda: ex.mixed_lanes_demo(arch, params, rng, verbose=False,
                                                           device=device), device)
    in_vocab("example-lanes", done, 16)
    adm = {t: [n for _, n in tr] for t, tr in sched.stats.lane_admissions.items()}
    log(f"[example-lanes] admissions {adm}; buckets {eng.template_shapes}")
    if eng.template_shapes["chat"][1] != 8 or eng.template_shapes["summarize"][1] != 16 \
            or {t: sum(v) for t, v in adm.items()} != {"chat": 8, "summarize": 8}:
        fail("example-lanes: a lane's admissions were not homogeneous")
    (done, st), paths["example-overlap"] = _example_part(
        "example-overlap", arch, lambda: ex.overlap_kv_demo(arch, params, verbose=False,
                                                            device=device), device)
    in_vocab("example-overlap", done, 16)
    shares = proportional_shares({"chat": 2.0, "summarize": 1.0}, n_lanes=8, reserve=0.5)
    log(f"[example-overlap] kv_shares {shares}; spec {st.spec_dispatched} dispatched, "
        f"{st.spec_committed} committed, {st.spec_aborted} aborted; admissions "
        f"{st.lane_admissions}")
    if shares != {"chat": 3, "summarize": 1} or \
            st.spec_dispatched != st.spec_committed + st.spec_aborted or st.spec_crashes:
        fail("example-overlap: kv_shares, or the speculation ledger")
    (done, st), paths["example-depth-spill"] = _example_part(
        "example-depth-spill", arch, lambda: ex.depth_spill_demo(arch, params, verbose=False,
                                                                 device=device), device)
    in_vocab("example-depth-spill", done, 12)
    log(f"[example-depth-spill] spec {st.spec_dispatched} dispatched / {st.spec_committed} "
        f"committed / {st.spec_aborted} aborted, {st.spec_chunks} prefill chunks, kv "
        f"spilled {st.kv_spilled} restored {st.kv_restored}, crashes {st.spec_crashes}")
    if st.spec_chunks < 1 or st.kv_restored != st.kv_spilled or st.spec_crashes or \
            st.spec_dispatched != st.spec_committed + st.spec_aborted:
        fail("example-depth-spill: need spec_chunks >= 1, kv_restored == kv_spilled, no "
             "crash and a balanced ledger")
    return paths


EXAMPLE_TRAIN = dict(steps=6, every=2, resume=2)  # 12c's cadence (the reference: 60, 20, 20)


def phase_example_train(smi, arch=None, params=None) -> dict:
    """12c: ``repro_torch.examples.train_checkpoint_restart.run`` on
    olmo-1b at full width (16 layers, bf16 parameters, float32 moments,
    the reference's AdamW and ``donate=False``), 6 steps with an
    asynchronous checkpoint every 2, ``on_preempt`` at 6, a restore into
    fresh tensors and 2 resumed steps; beside it the uninterrupted twin,
    the preempted parameters and state continued in memory through the
    same compiled step on the same batches.  The first resumed loss bit
    for bit the twin's step 7, the second within 1e-5 relative (the
    backward's sums with atomics); one compiled step, every call a copy
    in, every call after the first a replay; each call's launches
    ``_train_expect``'s.  Returns the launches."""
    import tempfile

    import torch
    from repro_torch.examples import train_checkpoint_restart as ex
    from repro_torch.kernels import registry

    if arch is None:
        arch, params = _init_full("olmo-1b", smi)
    device = _device_of(params)
    c = EXAMPLE_TRAIN
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        registry.reset_launches()
        t0 = time.perf_counter()
        out = ex.run(arch, params, ckpt_dir=d, verbose=False, **c)
        wall = time.perf_counter() - t0
        params, state, step = out["params"], out["state"], out["step"]
        twin = []
        for i in range(c["resume"]):
            params, state, m = step(params, state, out["stream"].batch_at(c["steps"] + i))
            twin.append(float(m["loss"]))
        _sync(device)
        launches = registry.launch_counts()
    writes = [(w["step"], w["bytes"], w["end"] - w["start"]) for w in out["writes"]]
    calls = c["steps"] + 2 * c["resume"]
    log(f"[example-train] {arch.cfg.name} on {smi}: losses {out['losses']}, resumed at "
        f"{out['resumed_at']}: {out['resumed']}, uninterrupted twin {twin}; save() blocked "
        f"{out['save_blocked']} s; writes (step, bytes, s) {writes}; on_preempt "
        f"{out['preempt_s']!r} s; restore {out['restore_s']!r} s; run {wall!r} s; step "
        f"calls {step.calls}, replays {step.replays}, copies in {step.copies_in}, "
        f"signatures {len(step.cache.steps)}; launches {launches}")
    if not all(np.isfinite(out["losses"] + out["resumed"] + twin)):
        fail("example-train: a loss is not finite")
    if out["resumed_at"] != c["steps"] or out["resumed"][0] != twin[0]:
        fail(f"example-train: resumed at {out['resumed_at']}, first resumed loss "
             f"{out['resumed'][0]!r} against the twin's {twin[0]!r}")
    if any(abs(a - b) > 1e-5 * abs(b) for a, b in zip(out["resumed"], twin)):
        fail("example-train: a resumed loss differs from the twin's beyond 1e-5 relative")
    if device == "cuda" and (step.calls, step.replays, step.copies_in,
                             len(step.cache.steps)) != (calls, calls - 1, calls, 1):
        fail("example-train: not one compiled step copied into and replayed every call")
    if [w[0] for w in writes] != list(range(c["every"], c["steps"] + 1, c["every"])):
        fail(f"example-train: writes of steps {[w[0] for w in writes]}")
    _expect("example-train", launches,
            {k: v * calls for k, v in _train_expect(arch.cfg).items()})
    del out, params, state, step
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return launches


EXAMPLE_TABLES = (("example", 5000, 64, "float32"),
                  ("llama3-8b embedding", 128256, 4096, "bfloat16"))


def phase_example_fission(device="cuda", tables=EXAMPLE_TABLES) -> dict:
    """12d: ``repro_torch.examples.device_fission`` at the example's sizes
    (a 5000 x 64 float32 table, ids ``arange(256) * 37 % 5000``) and on
    the llama3-8b embedding table (128256 x 4096 bf16, 256 ids): the plain
    loop launches ``batched_gather`` once an id, the fissioned one once;
    both give the same bits; one query batched; the traced programs hold
    256 per-iteration queries against one batched gather; the gradient's
    nonzero rows are the distinct ids.  Returns the launches."""
    import torch
    from repro_torch.core.fission import FissionReport, fission_scan, scan
    from repro_torch.examples import device_fission as ex
    from repro_torch.kernels import registry

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    total = {}
    for label, v, d, dtype in tables:
        table = torch.randn((v, d), generator=gen, device=device).to(getattr(torch, dtype))
        ids = ((torch.arange(256, device=device) * 37) % v).to(torch.int32)
        got = {}
        for name, fn in (("scan", scan), ("fission_scan", fission_scan)):
            rep = FissionReport()
            _sync(device)
            registry.reset_launches()
            t0 = time.perf_counter()
            out = ex.loop(fn, table, ids, report=rep if fn is fission_scan else None)
            _sync(device)
            got[name] = (out, time.perf_counter() - t0, registry.launch_counts(), rep)
            for k, n in got[name][2].items():
                total[k] = total.get(k, 0) + n
        (a, wa, la, _r), (b, wb, lb, rep) = got["scan"], got["fission_scan"]
        plain, fissioned = ex.structure(scan, table, ids), ex.structure(fission_scan, table, ids)
        g, rows = ex.table_grad(table, ids)
        nz = torch.nonzero(g.float().abs().sum(-1)).flatten()
        distinct = torch.unique(ids.long())
        log(f"[example-fission] {label} {v} x {d} {dtype}: carry {float(a[0])!r} / "
            f"{float(b[0])!r}; batched_gather launches {la['batched_gather']} / "
            f"{lb['batched_gather']}; walls {wa!r} / {wb!r} s; {rep.n_queries_batched} query "
            f"batched; traced {plain} / {fissioned}; gradient {tuple(g.shape)}, {rows} "
            f"nonzero rows of {len(distinct)} distinct ids")
        if (la["batched_gather"], lb["batched_gather"]) != (len(ids), 1):
            fail(f"example-fission {label}: batched_gather launches {la['batched_gather']} / "
                 f"{lb['batched_gather']}, expected {len(ids)} / 1")
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            fail(f"example-fission {label}: the fissioned loop's results differ")
        if rep.n_queries_batched != 1 or plain != {"table_gather": len(ids),
                                                   "batched_gather": 0} or \
                fissioned != {"table_gather": 0, "batched_gather": 1}:
            fail(f"example-fission {label}: the loop's structure")
        if rows != len(distinct) or not torch.equal(nz, distinct):
            fail(f"example-fission {label}: the gradient's nonzero rows are not the ids")
        del table, g
    _sync(device)
    return total


def phase_examples(smi) -> dict:
    """Phase 12: the JAX package's examples through the port's twins
    (``repro_torch.examples``), 12a-d.  Returns launches by path."""
    import torch
    from repro_torch.models.registry import get_arch

    arch = get_arch("llama3-8b")
    params = arch.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[examples] llama3-8b full width, weights from seed 0 (phase 4's) on {smi}")
    _warm(arch, params)
    paths = phase_depth(arch, params)
    _elapsed("12a depth")
    paths.update(phase_example_serving(arch, params))
    _elapsed("12b serving example")
    del arch, params
    gc.collect()
    torch.cuda.empty_cache()
    paths["example-train"] = phase_example_train(smi)
    _elapsed("12c training example")
    paths["example-fission"] = phase_example_fission()
    return paths


# ---------------------------------------------------------------- phase 11
SHARD_MESH = (2, 2)  # (data, model): four ranks sharing the one card, over gloo
# 11a: phase 8's batch in one microbatch (4 microbatches move 13.2 GB a
# step through gloo: 4 x the FSDP gathers, which the fissioned loop's
# consumer recomputes each microbatch too); 11e: the same batch in 2
# microbatches, the loop fissioned
SHARD_TRAIN = dict(steps=2, batch=8, seq=512)
SHARD_FISSION_MB = 2
# 11f: decode on the mesh, 8 lanes of 256-token prompts, caches of 512 rows
SHARD_DECODE = dict(lanes=8, prompt=256, max_len=512, steps=8)  # 16 steps until PR 26
# 11a, 11c, 11e: llama3-8b at full width, 2 of its 32 layers (4 until PR 26;
# phase 12's time came out of earlier phases)
SHARD_TRAIN_LAYERS = 2
SHARD_DECODE_LAYERS = 2  # 11f: llama3-8b at full width, 2 of its 32 layers
MOE_EP_LAYERS = 4  # 11b: deepseek-moe-16b's dense block and 3 MoE blocks
MOE_EP_BATCH = (8, 256)


def _cut(name: str, **overrides):
    from repro_torch.models.registry import get_arch
    a = get_arch(name)
    return dataclasses.replace(a, cfg=dataclasses.replace(a.cfg, **overrides))


def _reduced_cut(name: str, **overrides):
    from repro_torch.models.registry import get_arch
    a = get_arch(name)
    return dataclasses.replace(a, cfg=dataclasses.replace(a.cfg.reduced(), **overrides))


def _sharded_train_arch(reduced: bool = False):
    kw = dict(query_embedding=True, remat=False)
    if reduced:
        return _reduced_cut("llama3-8b", **kw)
    return _cut("llama3-8b", n_layers=SHARD_TRAIN_LAYERS, **kw)


def _sharded_decode_arch(reduced: bool = False):
    """11f's model: 11a's at ``SHARD_DECODE_LAYERS`` layers (the decode on
    gloo takes the most of phase 11's wall)."""
    if reduced:
        return _sharded_train_arch(reduced)
    return _cut("llama3-8b", n_layers=SHARD_DECODE_LAYERS, query_embedding=True, remat=False)


def _moe_ep_arch(reduced: bool = False):
    if reduced:
        return _reduced_cut("deepseek-moe-16b")
    return _cut("deepseek-moe-16b", n_layers=MOE_EP_LAYERS, remat=False)


def _c10d_all_gather(x, group_size: int, group_name: str):
    """``_c10d_functional::all_gather_into_tensor`` through c10d's
    synchronous ``all_gather_into_tensor``: the ranks' shards concatenated
    along dim 0, in rank order, ready when it returns (the op's
    ``wait_tensor`` finds no work to wait for)."""
    import torch.distributed as dist
    pg = dist.distributed_c10d._resolve_process_group(group_name)
    out = x.new_empty((group_size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=pg)
    return out


_C10D_GATHER = []  # the library that holds the override, kept alive


def use_c10d_all_gather(device: str) -> None:
    """Run the functional all-gather on ``device`` in this rank's process
    through c10d's: gloo's functional all-gather of CUDA tensors never
    completes when ranks share one card (PyTorch 2.11), c10d's does.  The
    op's kernel is replaced, not its name, so DTensor calls it as before,
    a traced graph (the fissioned train step's) records and replays it as
    the pure functional collective it is, and ``OpCost`` counts it as an
    all-gather.  NCCL ranks, one a card, need no such patch."""
    import torch
    if not _C10D_GATHER:
        lib = torch.library.Library("_c10d_functional", "IMPL")
        lib.impl("all_gather_into_tensor", _c10d_all_gather,
                 "CUDA" if device == "cuda" else "CPU")
        _C10D_GATHER.append(lib)


def _rank_start(device: str):
    """A rank's set-up: the card, TF32 off, the functional all-gather
    through c10d's (``use_c10d_all_gather``), the (data, model) mesh."""
    import torch
    from repro_torch.launch.mesh import make_test_mesh
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    use_c10d_all_gather(device)
    return make_test_mesh(*SHARD_MESH, device_type=device)


def _peak(device: str) -> int:
    import torch
    return torch.cuda.max_memory_allocated() if device == "cuda" else 0


def _reset_peak(device: str) -> None:
    import torch
    _sync(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _collective_probe(mesh, device: str) -> dict:
    """The collectives the phase runs, once each over the ``model`` group
    (CUDA tensors on the card): a call that completes is taken."""
    import torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    g = mesh.get_group("model")
    x = torch.ones(8, 4, device=device)
    calls = (("c10d all_gather_into_tensor",
              lambda: dist.all_gather_into_tensor(torch.empty(16, 4, device=device), x, group=g)),
             ("functional all_reduce", lambda: funcol.wait_tensor(funcol.all_reduce(x, "sum", g))),
             ("functional reduce_scatter",
              lambda: funcol.wait_tensor(funcol.reduce_scatter_tensor(x, "sum", 0, g))),
             ("functional all_to_all",
              lambda: funcol.wait_tensor(funcol.all_to_all_single(x, None, None, g))))
    out = {}
    for name, fn in calls:
        fn()
        _sync(device)
        out[name] = "taken"
    return out


def _rank_11a(mesh, device: str, reduced: bool, mb: int = 1, retrace: bool = False) -> dict:
    """11a on one rank: llama3-8b at full width cut to 2 layers, its
    parameters placed by ``param_shardings``, ``SHARD_TRAIN["steps"]``
    sharded steps; the last under ``OpCost``.  With ``mb`` > 1 (11e) the
    batch is split into ``mb`` microbatches and the loop fissioned: its
    plan is traced once and kept, or with ``retrace`` (one step, no
    ``OpCost``) traced again (the plans cleared).  Counts ``trace_body``
    calls a step."""
    import torch
    from repro_torch.core import fission as fission_mod
    from repro_torch.data.pipeline import SyntheticLMStream
    from repro_torch.distributed.sharding import distribute_params
    from repro_torch.kernels import registry
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import TrainStepConfig, make_train_step

    t = SHARD_TRAIN
    arch = _sharded_train_arch(reduced)
    params = distribute_params(mesh, arch.init(seed=0, device=device))
    _free(device)
    init, step = make_train_step(arch, AdamWConfig(lr=1e-3),
                                 TrainStepConfig(microbatches=mb), mesh=mesh)
    state = init(params)
    stream = SyntheticLMStream(arch.cfg.vocab_size, seq_len=t["seq"], batch=t["batch"], seed=0)
    out = dict(wq_local=tuple(params["layers"]["attn"]["wq"].to_local().shape),
               losses=[], walls=[], launches=[], peaks=[], traces=[])
    oc = None
    traced, real_trace = [], fission_mod.trace_body

    def counted_trace(*args, **kwargs):  # this script's instrumentation only
        traced.append(1)
        return real_trace(*args, **kwargs)

    n = 1 if retrace else t["steps"]
    for i in range(n):
        counted = not retrace and i == n - 1
        oc = OpCost(mesh) if counted else None
        _reset_peak(device)
        registry.reset_launches()
        if retrace:
            step.plans.clear()
        n0 = len(traced)
        t0 = time.perf_counter()
        with oc if counted else contextlib.nullcontext(), \
                mock.patch.object(fission_mod, "trace_body", counted_trace):
            params, state, m = step(params, state, stream.batch_at(i))
        out["losses"].append(float(m["loss"]))
        _sync(device)
        out["walls"].append(time.perf_counter() - t0)
        out["launches"].append(registry.launch_counts())
        out["peaks"].append(_peak(device))
        out["traces"].append(len(traced) - n0)
    out["wq0"] = params["layers"]["attn"]["wq"].full_tensor()[0].float().cpu().numpy()
    if oc is not None:
        out.update(flops=oc.flops, collectives=oc.collectives_row(),
                   by_axis=oc.by_axis_row())
    del params, state
    _free(device)
    return out


def _rank_11b(mesh, device: str, reduced: bool, tokens, routes) -> dict:
    """11b on one rank: deepseek-moe-16b at full width cut to a dense and 3
    MoE blocks, experts over ``model``; the prefill of ``tokens`` on the
    single-device run's routes, every ``moe`` call under ``OpCost``, then
    one train step."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.data.pipeline import SyntheticLMStream
    from repro_torch.distributed.sharding import batch_placements, distribute_params, mesh_context
    from repro_torch.kernels import registry
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.models import transformer
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import TrainStepConfig, make_train_step

    arch = _moe_ep_arch(reduced)
    params = distribute_params(mesh, arch.init(seed=0, device=device))
    _free(device)
    ex = params["layers"]["moe"]["experts"]
    out = {"local": {k: tuple(ex[k].to_local().shape) for k in ("w_gate", "w_in", "w_out")}}
    tok = distribute_tensor(torch.as_tensor(tokens, device=device), mesh,
                            batch_placements(mesh, tokens.shape), src_data_rank=None)
    calls, inner = [], transformer.moe

    def counted(p, cfg, x):
        oc = OpCost(mesh)
        with oc:
            y = inner(p, cfg, x)
        calls.append((oc.count("all-reduce", "model"), oc.count("all-reduce")))
        return y

    registry.reset_launches()
    t0 = time.perf_counter()
    with mesh_context(mesh), _Routes().replay(routes), \
            mock.patch.object(transformer, "moe", counted):
        logits, _cache = arch.prefill(params, {"tokens": tok})
        logits = logits.full_tensor()
    _sync(device)
    out["prefill_wall"] = time.perf_counter() - t0
    out["prefill_launches"] = registry.launch_counts()
    out["moe_calls"] = calls
    out["logits"] = logits.float().cpu().numpy()
    del logits, _cache
    init, step = make_train_step(arch, AdamWConfig(lr=1e-3), TrainStepConfig(), mesh=mesh)
    state = init(params)
    b = SyntheticLMStream(arch.cfg.vocab_size, seq_len=MOE_EP_BATCH[1], batch=MOE_EP_BATCH[0],
                          seed=1).batch_at(0)
    _reset_peak(device)
    registry.reset_launches()
    t0 = time.perf_counter()
    params, state, m = step(params, state, b)
    out["loss"] = float(m["loss"])
    _sync(device)
    out["step_wall"] = time.perf_counter() - t0
    out["step_launches"] = registry.launch_counts()
    out["peak"] = _peak(device)
    del params, state
    _free(device)
    return out


def _rank_11d(mesh, device: str, cases) -> dict:
    """11d on one rank: each reduced float32 case's parameters (numpy, the
    CPU run's) placed on the mesh and trained 2 steps (the ``/fission``
    cases at 4 microbatches, the loop fissioned); the ``/decode`` cases'
    decode steps in both cache layouts (``_reduced_decode``)."""
    from repro_torch.distributed.sharding import distribute_params
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import TrainStepConfig, make_train_step

    out = {}
    for key, (overrides, ts_kw, tree, data) in cases.items():
        arch = _reduced_cut(key.split("/")[0], **overrides)
        params = distribute_params(mesh, params_from_numpy(tree, arch.cfg, device=device))
        if key.endswith("/decode"):
            out[key] = _reduced_decode(arch, params, data, mesh, device)
            continue
        init, step = make_train_step(arch, AdamWConfig(lr=1e-3), TrainStepConfig(**ts_kw),
                                     mesh=mesh)
        state, losses = init(params), []
        for b in data:
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
        full = {k: v.full_tensor().float().cpu().numpy() for k, v in _flat(params).items()}
        out[key] = (losses, full)
    _sync(device)
    return out


def _reduced_decode(arch, params, data, mesh=None, device: str = "cpu"):
    """``REDUCED_DECODE["steps"]`` decode steps of ``arch`` from ``data``'s
    cache (numpy), lengths and tokens: on one device without ``mesh``, else
    in both cache layouts of a decode cell.  → (logits, caches), numpy, per
    layout (one entry, "single", without a mesh)."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from torch.utils import _pytree as pytree
    from repro_torch.distributed.sharding import full, mesh_context
    from repro_torch.launch.dryrun import _input_placements

    cache0, tokens, lengths = data
    out = {}
    for layout in (("default", "kv_seq_shard") if mesh is not None else ("single",)):
        inputs = {"token": torch.as_tensor(tokens[0], device=device),
                  "cache": _map_leaves(lambda a: torch.tensor(a, device=device), cache0),
                  "lengths": torch.as_tensor(lengths, device=device)}
        if mesh is not None:
            inputs = pytree.tree_map(
                lambda t, pl: distribute_tensor(t, mesh, pl, src_data_rank=None), inputs,
                _input_placements(mesh, inputs, frozenset({layout}) - {"default"}),
                is_leaf=lambda x: isinstance(x, tuple))
        cache, logits = inputs["cache"], []
        with mesh_context(mesh) if mesh is not None else contextlib.nullcontext():
            for i in range(len(tokens)):
                tok = torch.as_tensor(tokens[i], device=device)
                if mesh is not None:
                    tok = distribute_tensor(tok, mesh, inputs["token"].placements,
                                            src_data_rank=None)
                lg, cache = arch.decode_step(params, tok, cache, inputs["lengths"] + i)
                logits.append(full(lg).float().cpu().numpy())
        out[layout] = (np.stack(logits), {k: _gathered(v).float().cpu().numpy()
                                          for k, v in _flat(cache).items()})
    return out


def _rank_11f(mesh, device: str, reduced: bool, case) -> dict:
    """11f on one rank: 11a's cut decoding on the mesh, its parameters
    placed by ``param_shardings``; the twin's caches and tokens placed as
    the dry run places a decode cell's (``_input_placements``), in the
    default layout and under ``kv_seq_shard``, ``SHARD_DECODE["steps"]``
    steps each, the last under ``OpCost``; per layout the logits, the new
    tokens' cache rows (rank 0), launches, step walls and collectives."""
    import torch
    from torch.distributed.tensor import distribute_tensor
    from torch.utils import _pytree as pytree
    from repro_torch.distributed.sharding import distribute_params, full, mesh_context
    from repro_torch.kernels import registry
    from repro_torch.launch.dryrun import _input_placements
    from repro_torch.launch.op_cost import OpCost

    cache0, tokens, lengths = case
    arch = _sharded_decode_arch(reduced)
    params = distribute_params(mesh, arch.init(seed=0, device=device))
    _free(device)
    out = {}
    for layout in ("default", "kv_seq_shard"):
        inputs = {"token": torch.as_tensor(tokens[0], device=device),
                  "cache": _to(cache0, device),
                  "lengths": torch.as_tensor(lengths, device=device)}
        placed = pytree.tree_map(
            lambda t, pl: distribute_tensor(t, mesh, pl, src_data_rank=None), inputs,
            _input_placements(mesh, inputs, frozenset({layout}) - {"default"}),
            is_leaf=lambda x: isinstance(x, tuple))
        del inputs
        cache, f = placed["cache"], dict(logits=[], walls=[])
        registry.reset_launches()
        with mesh_context(mesh):
            for i in range(len(tokens)):
                tok = distribute_tensor(torch.as_tensor(tokens[i], device=device), mesh,
                                        placed["token"].placements, src_data_rank=None)
                oc = OpCost(mesh) if i == len(tokens) - 1 else contextlib.nullcontext()
                t0 = time.perf_counter()
                with oc:
                    logits, cache = arch.decode_step(params, tok, cache, placed["lengths"] + i)
                    logits = full(logits)
                _sync(device)
                f["walls"].append(time.perf_counter() - t0)
                f["logits"].append(logits.float().cpu().numpy())
        f["launches"] = registry.launch_counts()
        f["by_axis"], f["collectives"] = oc.by_axis_row(), oc.collectives_row()
        f["rows"] = {k: v.numpy() for k, v in _new_rows(cache, len(tokens)).items()}
        out[layout] = f
        del placed, cache
        _free(device)
    del params
    _free(device)
    return out


def _new_rows(cache, steps: int) -> dict:
    """The rows the decode steps wrote: ``[prompt, prompt + steps)`` of each
    K/V stack, float32 on the host (a DTensor's gathered first)."""
    p = SHARD_DECODE["prompt"]
    return {k: _gathered(v)[:, :, p:p + steps].float().cpu() for k, v in _flat(cache).items()}


def _gathered(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _rank_phase11(rank, world, device, reduced, tokens, routes, reduced_cases,
                  decode_case) -> dict:
    """Everything phase 11 runs on one rank, in order; rank 0's outputs
    carry the logits and parameters the parent compares."""
    mesh = _rank_start(device)
    out = {"probe": _collective_probe(mesh, device)}
    for name, fn in (("11a", lambda: _rank_11a(mesh, device, reduced)),
                     ("11b", lambda: _rank_11b(mesh, device, reduced, tokens, routes)),
                     ("11d", lambda: _rank_11d(mesh, device, reduced_cases)),
                     ("11e", lambda: _rank_11a(mesh, device, reduced, SHARD_FISSION_MB)),
                     ("11e-retrace", lambda: _rank_11a(mesh, device, reduced, SHARD_FISSION_MB,
                                                       retrace=True)),
                     ("11f", lambda: _rank_11f(mesh, device, reduced, decode_case))):
        t0 = time.perf_counter()
        out[name] = fn()
        if rank == 0:
            log(f"[sharded] rank 0: {name} done in {time.perf_counter() - t0!r} s")
    if rank:
        out["11a"]["wq0"] = out["11e"]["wq0"] = out["11e-retrace"]["wq0"] = None
        out["11b"]["logits"] = None
        out["11d"] = {k: None if k.endswith("/decode") else (v[0], None)
                      for k, v in out["11d"].items()}
        for f in out["11f"].values():
            f["logits"] = f["rows"] = None
    return out


def _free(device: str) -> None:
    import torch
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def _map_leaves(fn, tree):
    return {k: _map_leaves(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _flat(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# 11d's decode cases: 4 lanes, caches of 16 rows, 6 steps; lane 1 starts
# empty, and under kv_seq_shard the second rank holds none of lanes 0, 1, 3
REDUCED_DECODE = dict(lanes=4, rows=16, steps=6, lengths=(2, 0, 9, 1))


def _reduced_sharded_cases():
    """11d's cases: reduced llama3-8b (``query_embedding``: the masked
    vocabulary-parallel gather) and deepseek-moe-16b in float32, their
    parameters drawn on the CPU, 2 batches of 8 x 16, and the unsharded
    CPU run's losses and parameters; ``llama3-8b/fission``, the same at 4
    microbatches fissioned; ``llama3-8b/decode``, a random cache and 6
    steps of fixed tokens (``REDUCED_DECODE``) and the CPU decode's logits
    and caches."""
    from repro_torch.models.convert import params_to_numpy
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import TrainStepConfig, make_train_step

    cases, refs = {}, {}
    rng = np.random.default_rng(11)
    for key, overrides, ts_kw in (("llama3-8b", dict(query_embedding=True), {}),
                                  ("deepseek-moe-16b", {}, {}),
                                  ("llama3-8b/fission", dict(query_embedding=True),
                                   dict(microbatches=4)),
                                  ("llama3-8b/decode", {}, {})):
        arch = _reduced_cut(key.split("/")[0], **overrides)
        params = arch.init(seed=0, device="cpu")
        # copies: on the CPU .numpy() shares memory, and the step donates params
        tree = _map_leaves(np.copy, params_to_numpy(params))
        if key.endswith("/decode"):
            d = REDUCED_DECODE
            spec = arch.init_cache(d["lanes"], d["rows"], device="meta")
            cache0 = _map_leaves(lambda t: rng.standard_normal(t.shape).astype(np.float32),
                                 spec)
            data = (cache0, rng.integers(0, arch.cfg.vocab_size, size=(d["steps"], d["lanes"]))
                    .astype(np.int32), np.asarray(d["lengths"], np.int32))
            cases[key] = (overrides, ts_kw, tree, data)
            refs[key] = _reduced_decode(arch, params, data)["single"]
            continue
        batches = []
        for _ in range(2):
            t = rng.integers(0, arch.cfg.vocab_size, size=(8, 16)).astype(np.int64)
            batches.append({"tokens": t, "labels": t})
        init, step = make_train_step(arch, AdamWConfig(lr=1e-3), TrainStepConfig(**ts_kw))
        state, losses = init(params), []
        for b in batches:
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
        cases[key] = (overrides, ts_kw, tree, batches)
        refs[key] = (losses, {k: v.detach().numpy().copy() for k, v in _flat(params).items()})
    return cases, refs


def _train_reference(smi, device: str = "cuda", reduced: bool = False, mb: int = 1):
    """11a's unsharded twin on the card: the same cut llama3-8b, seed and
    batches, ``SHARD_TRAIN["steps"]`` steps in ``mb`` microbatches (11e's:
    2, the loop fissioned).  Returns the losses and layer 0 of ``wq``
    before and after (float32, host)."""
    from repro_torch.data.pipeline import SyntheticLMStream
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import TrainStepConfig, make_train_step

    t = SHARD_TRAIN
    arch = _sharded_train_arch(reduced)
    params = arch.init(seed=0, device=device)
    wq_init = params["layers"]["attn"]["wq"][0].float().cpu().clone()  # the step writes params
    init, step = make_train_step(arch, AdamWConfig(lr=1e-3), TrainStepConfig(microbatches=mb))
    state = init(params)
    stream = SyntheticLMStream(arch.cfg.vocab_size, seq_len=t["seq"], batch=t["batch"], seed=0)
    losses = []
    for i in range(t["steps"]):
        params, state, m = step(params, state, stream.batch_at(i))
        losses.append(float(m["loss"]))
    wq_after = params["layers"]["attn"]["wq"][0].float().cpu()
    del params, state, m, step, init
    _free(device)
    log(f"[sharded-train] unsharded reference on {smi}, {mb} microbatch(es): losses {losses}")
    return losses, wq_init, wq_after


def _decode_reference(smi, device: str = "cuda", reduced: bool = False):
    """11f's unsharded twin on the card: 11a's cut and seed, the prefill of
    8 random 256-token prompts into caches of 512 rows, then
    ``SHARD_DECODE["steps"]`` greedy decode steps.  Returns the caches
    after the prefill (host), the steps' tokens and starting lengths
    (numpy), each step's logits and the rows the steps wrote (float32,
    host)."""
    import torch
    d = SHARD_DECODE
    arch = _sharded_decode_arch(reduced)
    params = arch.init(seed=0, device=device)
    prompts = np.random.default_rng(13).integers(
        0, arch.cfg.vocab_size, size=(d["lanes"], d["prompt"])).astype(np.int64)
    logits, cache = arch.prefill(params, {"tokens": torch.as_tensor(prompts, device=device)},
                                 max_len=d["max_len"])
    cache0 = _map_leaves(lambda t: t.cpu(), cache)
    lengths = np.full(d["lanes"], d["prompt"], np.int32)
    tokens, step_logits, walls = [], [], []
    for i in range(d["steps"]):
        tok = logits.argmax(-1).to(torch.int32)
        tokens.append(tok.cpu().numpy())
        t0 = time.perf_counter()
        logits, cache = arch.decode_step(params, tok, cache,
                                         torch.as_tensor(lengths + i, device=device))
        _sync(device)
        walls.append(time.perf_counter() - t0)
        step_logits.append(logits.float().cpu())
    rows = _new_rows(cache, d["steps"])
    del params, logits, cache
    _free(device)
    log(f"[sharded-decode] unsharded twin on {smi}: {arch.cfg.name} {arch.cfg.n_layers} layers, "
        f"prefill {prompts.shape} into {d['max_len']} rows, {d['steps']} decode steps, step "
        f"walls {walls} s")
    return (cache0, np.stack(tokens), lengths), step_logits, rows


def _moe_reference(smi, device: str = "cuda", reduced: bool = False):
    """11b's single-device run: the same cut deepseek-moe-16b and seed, the
    prefill of a fixed 8 x 256 batch, its logits and the routes each
    ``moe`` call took (on the host)."""
    import torch
    arch = _moe_ep_arch(reduced)
    params = arch.init(seed=0, device=device)
    tokens = np.random.default_rng(7).integers(
        0, arch.cfg.vocab_size, size=MOE_EP_BATCH).astype(np.int64)
    routes = _Routes()
    with routes.record():
        logits, _cache = arch.prefill(params, {"tokens": torch.as_tensor(tokens, device=device)})
    _sync(device)
    out = (tokens, [c.cpu() for c in routes.calls], logits.float().cpu())
    del params, logits, _cache
    _free(device)
    log(f"[moe-ep] single-device reference on {smi}: {arch.cfg.name}, {arch.cfg.n_layers} "
        f"layers, prefill {MOE_EP_BATCH}, {len(out[1])} moe calls")
    return out


def _gate_11a(smi, res, ref, reduced: bool = False, key: str = "11a", mb: int = 1) -> dict:
    """11a's gates, or 11e's (``key``, ``mb`` microbatches, fissioned): per
    rank and step ``batched_gather`` once either way, ``flash_attention``
    once a layer and microbatch; the losses and ``wq`` against the
    unsharded twin ``ref``."""
    import torch
    cfg = _sharded_train_arch(reduced).cfg
    want = {"flash_attention": cfg.n_layers * mb, "batched_gather": 1,
            "paged_decode_attention": 0, "decode_attention": 0, "ssd_scan": 0, "ssd_scan_bwd": 0}
    dm, mm = SHARD_MESH
    wq = (cfg.n_layers, cfg.d_model // dm, cfg.n_heads // mm, cfg.hd)  # (2, 2048, 16, 128)
    tag = "sharded-train" if mb == 1 else "sharded-fission"
    for r, out in enumerate(res):
        a = out[key]
        log(f"[{tag}] rank {r} on {smi}: {mb} microbatch(es), wq local {a['wq_local']}, losses "
            f"{a['losses']}, step walls {a['walls']} s (the last under OpCost), peak device "
            f"memory {[p / 2**30 for p in a['peaks']]} GiB, launches {a['launches']}")
        log(f"[{tag}] rank {r} collectives of a step: {a['collectives']}; by mesh "
            f"axis {a['by_axis']}; flops {a['flops']!r}")
        if a["wq_local"] != wq:
            fail(f"{tag}: rank {r}'s wq shard is {a['wq_local']}, not {wq}")
        if not all(np.isfinite(a["losses"])):
            fail(f"{tag}: rank {r} has a loss that is not finite")
        for i, got in enumerate(a["launches"]):
            _expect(f"{tag} rank {r} step {i}", got, want)
    # Losses to 1e-3 relative: the sharded step sums its bf16 gradients in
    # another order; the first step moves the loss by about a fifth, so a
    # wrong gradient or moment layout shows in the second loss.  wq's layer
    # 0 after the steps: its distance from the unsharded one, over the
    # distance the unsharded steps moved it (an update unrelated to the
    # right one gives about 1.4, a flipped one 2).
    want_losses, w0, w_ref = ref
    losses, w = res[0][key]["losses"], torch.from_numpy(res[0][key]["wq0"])
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, want_losses)]
    moved = float(torch.linalg.vector_norm(w_ref - w0))
    dist_w = float(torch.linalg.vector_norm(w - w_ref)) / moved
    log(f"[{tag}] rank 0's losses {losses} against the unsharded steps' "
        f"{want_losses} (same seed and batches): relative differences {rel} (gate 1e-3); "
        f"wq layer 0 after {len(losses)} steps: distance from the unsharded one "
        f"{dist_w!r} of the {moved!r} the steps moved it (gate 0.25)")
    if max(rel) > 1e-3:
        fail(f"{tag}: the sharded steps' losses differ from the unsharded ones")
    if not dist_w <= 0.25:
        fail(f"{tag}: the sharded steps moved wq elsewhere than the unsharded ones")
    return {k: sum(sum(l[k] for l in out[key]["launches"]) for out in res) for k in want}


def _gate_11f(smi, res, twin_logits, twin_rows, reduced: bool = False) -> dict:
    """11f's gates: per rank and layout ``decode_attention`` once a layer
    and step and ``batched_gather`` once a step (``query_embedding``); the
    ``kv_seq_shard`` step 3 all-reduces over ``model`` a layer more than
    the default layout's and no all-gather over ``model`` more (q's, which
    both gather: no cache is gathered); rank 0's logits at each step
    against the twin's (``_report_logits``' gate) and the new rows against
    the twin's: layer 0's within 1e-2 of their largest entry (bf16's
    tolerance: they come from the token's embedding through one
    projection), every layer's within 0.05 of it, the logits' gate (the
    deeper layers' rows carry the hidden state, which the mesh's bf16
    partial sums round apart from the twin's as they do the logits).  A
    row written into a copy instead would miss by its whole size."""
    import torch
    cfg = _sharded_decode_arch(reduced).cfg
    steps = SHARD_DECODE["steps"]
    want = {"flash_attention": 0, "batched_gather": steps, "paged_decode_attention": 0,
            "decode_attention": cfg.n_layers * steps, "ssd_scan": 0, "ssd_scan_bwd": 0}
    tol = 1e-2 if cfg.cdtype == torch.bfloat16 else 1e-4
    for r, out in enumerate(res):
        for layout, f in out["11f"].items():
            log(f"[sharded-decode] rank {r} on {smi}, {layout}: step walls {f['walls']} s, "
                f"launches {f['launches']}, the last step's collectives {f['collectives']}, by "
                f"mesh axis {f['by_axis']}")
            _expect(f"sharded-decode rank {r} {layout}", f["launches"], want)
        d, k = out["11f"]["default"]["by_axis"], out["11f"]["kv_seq_shard"]["by_axis"]
        extra = k.get("all-reduce@model", 0) - d.get("all-reduce@model", 0)
        if extra != 3 * cfg.n_layers or k.get("all-gather@model", 0) != d.get(
                "all-gather@model", 0):
            fail(f"sharded-decode: rank {r}'s kv_seq_shard step holds {extra} all-reduces over "
                 f"model more than the default layout's (want {3 * cfg.n_layers}) and "
                 f"{k.get('all-gather@model', 0)} all-gathers over model against "
                 f"{d.get('all-gather@model', 0)}")
    for layout, f in res[0]["11f"].items():
        ratios, agree = [], []
        for got, want_l in zip(f["logits"], twin_logits):
            got = torch.from_numpy(got)
            ratios.append(float((got - want_l).abs().max() / want_l.abs().max()))
            agree.append(int((got.argmax(-1) == want_l.argmax(-1)).sum()))
        log(f"[check] sharded-decode {layout}: rank 0's logits against the twin's at each of "
            f"{len(ratios)} steps: max abs diff over max |logit| {ratios} (gate 0.05), argmax "
            f"agreement {agree} of {got.shape[0]} (gate: at most 2 off)")
        if not all(np.isfinite(x).all() for x in f["logits"]) or max(ratios) > 0.05 or \
                min(agree) < got.shape[0] - 2:
            fail(f"sharded-decode: the {layout} layout's logits disagree with the twin's")
        for name, rows in f["rows"].items():
            rows, want_r = torch.from_numpy(rows), twin_rows[name]
            scale = float(want_r.abs().max())
            ratios = [float((rows[i] - want_r[i]).abs().max()) / scale
                      for i in range(rows.shape[0])]
            log(f"[sharded-decode] {layout}: the steps' new rows of {name} {tuple(rows.shape)} "
                f"against the twin's: max abs diff over max |row| ({scale!r}) by layer {ratios} "
                f"(gates: layer 0 {tol}, every layer 0.05)")
            if not (np.isfinite(ratios).all() and ratios[0] <= tol and max(ratios) <= 0.05):
                fail(f"sharded-decode: {layout} wrote other {name} rows than the twin")
    return {k: sum(sum(f["launches"][k] for f in out["11f"].values()) for out in res)
            for k in want}


def _gate_11b(smi, res, ref_logits, reduced: bool = False) -> dict:
    import torch
    cfg = _moe_ep_arch(reduced).cfg
    want = {"flash_attention": cfg.n_layers, "batched_gather": 0, "paged_decode_attention": 0,
            "decode_attention": 0, "ssd_scan": 0, "ssd_scan_bwd": 0}
    n_moe = cfg.n_layers - cfg.first_dense_layers
    dm, mm = SHARD_MESH
    local = (n_moe, cfg.n_experts // mm, cfg.d_model // dm, cfg.moe_d_ff)  # (3, 32, 1024, 1408)
    for r, out in enumerate(res):
        b = out["11b"]
        log(f"[moe-ep] rank {r} on {smi}: expert stacks local {b['local']}, prefill wall "
            f"{b['prefill_wall']!r} s, moe calls (all-reduces over model, all) "
            f"{b['moe_calls']}, train step loss {b['loss']!r} wall {b['step_wall']!r} s, peak "
            f"{b['peak'] / 2**30!r} GiB, launches {b['prefill_launches']} + "
            f"{b['step_launches']}")
        for k in ("w_gate", "w_in"):
            if b["local"][k] != local:
                fail(f"moe-ep: rank {r}'s {k} shard is {b['local'][k]}, not {local}")
        if len(b["moe_calls"]) != n_moe or any(c[0] != 1 for c in b["moe_calls"]):
            fail(f"moe-ep: rank {r}'s moe calls hold {b['moe_calls']} all-reduces over model")
        if not np.isfinite(b["loss"]):
            fail(f"moe-ep: rank {r}'s train step loss is not finite")
        _expect(f"moe-ep rank {r} prefill", b["prefill_launches"], want)
        _expect(f"moe-ep rank {r} train step", b["step_launches"], want)
    _report_logits("moe-ep: expert-parallel prefill against the single-device one, on its "
                   "routes", torch.as_tensor(res[0]["11b"]["logits"]), ref_logits)
    return {k: sum(out["11b"]["prefill_launches"][k] + out["11b"]["step_launches"][k]
                   for out in res) for k in want}


def _gate_11d(res, refs) -> None:
    """Losses within 1e-4 of the CPU step's, and parameters within 1e-4;
    the ``/fission`` case's parameters as ``tests/test_torch_train.py``
    holds a microbatched step's (``_assert_params_close``): every entry
    within 2 x lr and at most 0.1 % of a leaf's (at least one) above 1e-4.
    Adam's update of a gradient near its eps (1e-8) turns on rounding:
    one entry of this case's ``layers/ln1/w`` has a first gradient of
    8.6e-9 on the CPU, so, unlike that test, a norm gain may hold it."""
    for name, (want_losses, want) in refs.items():
        if name.endswith("/decode"):
            _gate_11d_decode(name, res, want_losses, want)
            continue
        losses, got = res[0]["11d"][name]
        dl = max(abs(a - b) for a, b in zip(losses, want_losses))
        diffs = {k: np.abs(got[k] - want[k]) for k in want}
        dp = max(float(d.max()) for d in diffs.values())
        above = {k: int((d > 1e-4).sum()) for k, d in diffs.items() if (d > 1e-4).any()}
        log(f"[sharded-reduced] {name}: mesh {SHARD_MESH} against the unsharded CPU step, "
            f"losses {losses} vs {want_losses} (max diff {dl!r}), parameters max diff {dp!r}, "
            f"entries above 1e-4 by leaf {above} (gate 1e-4"
            f"{'; 2 x lr and 0.1 % above 1e-4' if name.endswith('/fission') else ''})")
        if name.endswith("/fission"):
            params_ok = dp <= 2e-3 and all(n <= max(1, diffs[k].size // 1000)
                                           for k, n in above.items())
        else:
            params_ok = dp <= 1e-4
        if dl > 1e-4 or not params_ok or any(r["11d"][name][0] != losses for r in res):
            fail(f"sharded-reduced: {name} on the mesh differs from the CPU step")


def _gate_11d_decode(name, res, want_logits, want_cache) -> None:
    """A ``/decode`` case: each layout's logits and caches on the ranks
    against the CPU decode's, within 1e-4 (float32 on both sides)."""
    for layout, (logits, cache) in res[0]["11d"][name].items():
        dl = float(np.abs(logits - want_logits).max())
        dc = max(float(np.abs(cache[k] - want_cache[k]).max()) for k in want_cache)
        log(f"[sharded-reduced] {name} {layout}: mesh {SHARD_MESH} against the unsharded CPU "
            f"decode, {len(logits)} steps: logits max diff {dl!r}, caches max diff {dc!r} "
            f"(gate 1e-4)")
        if dl > 1e-4 or dc > 1e-4:
            fail(f"sharded-reduced: {name} in the {layout} layout differs from the CPU decode")


def _phase_11c(smi, res, reduced: bool = False) -> None:
    """11c on the host: the dry run of 11a's configuration and mesh, and of
    11e's (2 microbatches, fissioned), each held to the step rank 0
    counted; then one production cell, timed."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models.config import ShapeSpec

    t = SHARD_TRAIN
    for key, mb in (("11a", 1), ("11e", SHARD_FISSION_MB)):
        counted = res[0][key]
        t0 = time.perf_counter()
        row = run_cell(_sharded_train_arch(reduced),
                       ShapeSpec("sharded-train", t["seq"], t["batch"], "train"), "single",
                       mesh_shape=SHARD_MESH, microbatches=mb)
        wall = time.perf_counter() - t0
        rel = abs(row["flops_per_device"] - counted["flops"]) / counted["flops"]
        kinds = {k: v["count"] for k, v in row["collectives"].items() if isinstance(v, dict)}
        real = {k: v["count"] for k, v in counted["collectives"].items() if isinstance(v, dict)}
        log(f"[dryrun] {key}'s cell ({mb} microbatch(es)) on fake ranks ({row['traced_on']} "
            f"fakes, {wall!r} s): flops per device {row['flops_per_device']!r} against the "
            f"step's {counted['flops']!r} (relative {rel!r}, gate 1e-2); collectives {kinds} "
            f"against {real}; by mesh axis {row['collectives_by_axis']} against "
            f"{counted['by_axis']}; live bytes {row['live_bytes']!r}")
        if rel > 1e-2 or kinds != real or row["collectives_by_axis"] != counted["by_axis"]:
            fail(f"dryrun: the dry run of {key}'s cell does not count what the step ran")
    if reduced:
        return
    t0 = time.perf_counter()
    prod = run_cell("llama3-8b", "train_4k", "single")
    wall = time.perf_counter() - t0
    keys = ("chips", "lower_s", "flops_per_device", "bytes_per_device",
            "collective_counts_loop_aware", "collective_bytes_loop_aware", "t_compute_s",
            "t_memory_s", "t_collective_s", "dominant", "useful_flops_ratio", "hbm_fit",
            "live_bytes")
    log(f"[dryrun] llama3-8b|train_4k|single on the host of {smi}: {wall!r} s; "
        f"{ {k: prod[k] for k in keys} }")


def phase_sharded(smi, device: str = "cuda", reduced: bool = False) -> dict:
    """Phase 11 (module docstring): the distribution layer on four ranks
    that share the card (``device="cpu", reduced=True`` rehearses it)."""
    from repro_torch.distributed.launch import run_ranks

    train_ref = _train_reference(smi, device, reduced)
    fission_ref = _train_reference(smi, device, reduced, SHARD_FISSION_MB)
    decode_case, twin_logits, twin_rows = _decode_reference(smi, device, reduced)
    tokens, routes, ref_logits = _moe_reference(smi, device, reduced)
    cases, refs = _reduced_sharded_cases()
    t0 = time.perf_counter()
    res = run_ranks(_rank_phase11, SHARD_MESH[0] * SHARD_MESH[1], device, reduced, tokens,
                    routes, cases, decode_case, timeout_s=600)
    log(f"[sharded] {len(res)} ranks on {smi}, mesh (data, model) = {SHARD_MESH} over gloo, "
        f"{time.perf_counter() - t0!r} s; collectives taken: {res[0]['probe']}")
    paths = {"sharded-train": _gate_11a(smi, res, train_ref, reduced),
             "moe-ep": _gate_11b(smi, res, ref_logits, reduced),
             "sharded-fission": _gate_11a(smi, res, fission_ref, reduced, "11e",
                                          SHARD_FISSION_MB),
             "sharded-decode": _gate_11f(smi, res, twin_logits, twin_rows, reduced)}
    _gate_11e_traces(res)
    _gate_11d(res, refs)
    _phase_11c(smi, res, reduced)
    return paths


def _gate_11e_traces(res) -> None:
    """11e's plan kept across steps: on every rank ``trace_body`` runs in
    the first step only, as much as a run that traces afresh (its plans
    cleared) does; the first loss equals that run's bit for bit (later
    ones are held to the unsharded twin by ``_gate_11a``)."""
    for r, out in enumerate(res):
        kept, again = out["11e"], out["11e-retrace"]
        log(f"[sharded-fission] rank {r}: trace_body calls a step {kept['traces']} "
            f"({sum(kept['traces'])} over {len(kept['traces'])} steps), a run tracing afresh "
            f"{again['traces']}; first loss {kept['losses'][0]!r} / {again['losses'][0]!r}, "
            f"{'equal' if kept['losses'][0] == again['losses'][0] else 'DIFFERENT'}; first "
            f"step walls {kept['walls'][0]!r} / {again['walls'][0]!r} s, later "
            f"{kept['walls'][1:]} s")
        first = kept["traces"][0]
        if first < 1 or any(kept["traces"][1:]) or again["traces"] != [first]:
            fail(f"sharded-fission: rank {r} traced {kept['traces']} a step (afresh "
                 f"{again['traces']})")
        if kept["losses"][0] != again["losses"][0]:
            fail(f"sharded-fission: rank {r}'s kept plan gives another first loss")


def _sync(device) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def _device_of(tree) -> str:
    """The device type of a params tree's first leaf."""
    return next(iter(_leaves(tree))).device.type


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


# -------------------------------------------------------------------- main
_T_START = [0.0]


def _elapsed(label: str) -> None:
    """Log the script's wall so far at a phase's end (where its time goes)."""
    log(f"[time] {label} done at {time.perf_counter() - _T_START[0]!r} s")


def main() -> None:
    t_start = _T_START[0] = time.perf_counter()
    smi, kind = phase_card()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch.models.registry import get_arch

    phase_build()
    timer = Timer()
    log(f"[kernels] on {smi}")
    rows = phase_kernels(timer)
    _elapsed("kernels")
    del timer
    torch.cuda.empty_cache()

    arch = get_arch("llama3-8b")
    t0 = time.perf_counter()
    params = arch.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(int(a.numel()) for a in _leaves(params))
    log(f"[main] llama3-8b full width: {arch.cfg.n_layers} layers, d_model "
        f"{arch.cfg.d_model}, {n_params} parameters in bf16, drawn from seed 0 "
        f"in {time.perf_counter() - t0!r} s")
    _warm(arch, params)
    paths = {"main": phase_main_path(arch, params, drives=1 + WARM_DRIVES)}
    paths["async"], async_wall = phase_async(arch, params, drives=1 + WARM_DRIVES)
    paths["dense"] = phase_dense(arch, params)
    log(f"[prefix] on {smi}")
    paths.update(phase_prefix(arch, params, drives=1 + WARM_DRIVES))
    log(f"[spill] on {smi}")
    paths.update(phase_spill(arch, params))
    log(f"[app-traces] on {smi}")
    paths["app-traces"] = phase_app_traces(arch, params)
    log(f"[model-service] on {smi}")
    paths["model-service"] = phase_model_service(arch, params)
    log(f"[chaos] on {smi}")
    paths.update(phase_chaos(arch, params))
    _elapsed("llama3-8b paths")
    log(f"[graphs] on {smi}")
    phase_graph_twins(arch, params)
    _elapsed("4s graphs")
    phase_logits_check(arch, params)
    log(f"[check] on {smi}")
    phase_prefix_check(arch, params)
    phase_profile(arch, params)
    phase_build_memory(arch, params)
    phase_prefill_memory(arch, params)
    _elapsed("profile and memory")
    del params
    gc.collect()  # engines and their threads can hold the weights in cycles
    torch.cuda.empty_cache()

    arch = get_arch("mamba2-1.3b")
    t0 = time.perf_counter()
    params = arch.init(seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(int(a.numel()) for a in _leaves(params))
    log(f"[ssm] on {smi}: mamba2-1.3b full width: {arch.cfg.n_layers} layers, d_model "
        f"{arch.cfg.d_model}, {n_params} parameters (bf16; A_log, D, dt_bias float32), "
        f"drawn from seed 0 in {time.perf_counter() - t0!r} s")
    paths["ssm"], ssm_wall, ssm_streams = phase_ssm(arch, params)
    log(f"[ssm-async] on {smi}")
    paths["ssm-async"], ssm_async_wall = phase_ssm_async(arch, params)
    log(f"[ssm-paged] on {smi}")
    paths["ssm-paged"], ssm_paged_wall = phase_ssm_paged(arch, params, ssm_streams)
    log(f"[check] on {smi}")
    phase_ssm_logits_check(arch, params)
    log(f"[profile] on {smi}")
    phase_ssm_profile(arch, params)
    _elapsed("mamba2")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    arch, params = _init_full("deepseek-moe-16b", smi)
    _warm(arch, params)
    paths["moe"] = phase_main_path(arch, params, label="moe")
    log(f"[moe-async] on {smi}")
    paths["moe-async"], moe_async_wall = phase_async(arch, params, label="moe-async")
    log(f"[moe-dense] on {smi}")
    paths["moe-dense"] = phase_dense(arch, params, label="moe-dense")
    log(f"[check] on {smi}")
    phase_logits_check(arch, params)
    log(f"[profile] on {smi}")
    phase_moe_profile(arch, params)
    _elapsed("deepseek-moe-16b")
    del arch, params
    gc.collect()
    torch.cuda.empty_cache()
    paths["configs"] = phase_configs(smi)
    paths["launcher"] = phase_launcher(smi)
    _elapsed("configs and launcher")

    from repro_torch.serving.engine import InferenceEngine
    arch, params = _init_full("hymba-1.5b", smi)
    _warm(arch, params, InferenceEngine(arch, params, **HYMBA_ENGINE))
    paths["hymba"], hymba_wall, hymba_streams = phase_hymba(arch, params)
    log(f"[hymba-paged] on {smi}")
    paths["hymba-paged"], hymba_paged_wall, _s = phase_hymba(arch, params, paged=True,
                                                             streams=hymba_streams)
    log(f"[hymba-chunked] on {smi}")
    paths["hymba-chunked"], _w = phase_hymba_chunked(arch, params)
    log(f"[check] on {smi}")
    phase_hymba_check(arch, params)
    _elapsed("hymba")
    del arch, params
    gc.collect()
    torch.cuda.empty_cache()
    arch, params = _init_full("qwen2-vl-2b", smi)
    _warm(arch, params)
    paths["vlm"] = phase_main_path(arch, params, label="vlm")
    log(f"[vlm-embeds] on {smi}")
    paths["vlm-embeds"], _w = phase_vlm_embeds(arch, params)
    log(f"[check] on {smi}")
    phase_logits_check(arch, params)
    del arch, params
    gc.collect()
    torch.cuda.empty_cache()
    arch, params = _init_full("seamless-m4t-medium", smi)
    paths["encdec"], _w = phase_encdec(arch, params)
    _elapsed("vlm and encdec")
    del arch, params
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(phase_train(smi))
    _elapsed("8 train")
    log(f"[train-ssm] on {smi}")
    paths.update(phase_train_ssm(smi))
    _elapsed("8b train-ssm")
    log(f"[train-hybrid] on {smi}")
    paths.update(phase_train_hybrid(smi))
    _elapsed("8c train-hybrid")
    phase_reduced_check()
    phase_reduced_bridge()
    phase_reduced_check("mamba2-1.3b", ("dense", "dense-async", "paged-ssm"))
    for config in NEW_CONFIGS + ("qwen2-vl-2b",):
        phase_reduced_check(config, ("paged", "dense", "async", "paged-prefix", "paged-spill"))
    phase_reduced_check("hymba-1.5b", ("dense", "dense-async", "paged-ssm"))
    phase_reduced_steps()
    _elapsed("7 reduced checks")
    log(f"[check] on {smi}")
    phase_train_reduced()
    phase_train_families()
    phase_train_restart()
    _elapsed("9 train checks")
    log(f"[fission] on {smi}")
    phase_fission()
    _elapsed("10 fission")
    log(f"[examples] on {smi}")
    paths.update(phase_examples(smi))
    _elapsed("12 examples")
    log(f"[sharded] on {smi}")
    paths.update(phase_sharded(smi))
    _elapsed("11 sharded")

    # Launches on the serving paths and the training runs (llama3-8b's two,
    # train-ssm's six steps, train-hybrid's two, phase 11's sharded runs
    # summed over their four ranks), each counted from 0 in its own run.
    launches = {n: sum(p[n] for p in paths.values()) for n in rows}
    log(f"[paths] launches by path {paths}; async wall {async_wall!r} s, ssm wall "
        f"{ssm_wall!r} s, ssm-async wall {ssm_async_wall!r} s, ssm-paged wall "
        f"{ssm_paged_wall!r} s, moe-async wall {moe_async_wall!r} s, hymba wall "
        f"{hymba_wall!r} s, hymba-paged wall {hymba_paged_wall!r} s")
    kernels = [dict(name=n, launches=launches[n], **rows[n]) for n in sorted(rows)]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "sub_rows")
    log(f"[total] {time.perf_counter() - t_start!r} s, kernel builds included")
    log(smi)
    print(json.dumps({"kernels": [{k: row[k] for k in keys if k in row} for row in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    main()
