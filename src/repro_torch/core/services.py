"""Query services — what the runtime submits requests *to*.

The paper's "database" generalizes (its §6, Experiment 4 uses a Web
service).  In this framework a service is anything with a blocking
single-request form and (optionally) a set-oriented batched form:

* :class:`SimulatedDBService` — a latency-model service for benchmarks that
  reproduces the paper's cost structure: each individual request pays one
  network round trip plus per-query processing; a batch pays **3 round
  trips** (parameter insert, batched query, temp-table cleanup — §5.2.3)
  plus cheaper per-item set-oriented processing.
* :class:`ModelService` — the ML-serving instantiation: a request is a model
  forward (e.g. score/embed/generate-step) executed by a JAX callable; the
  batched form pads and stacks requests into one device invocation —
  batching amortizes dispatch + kernel-launch + HBM-stream fixed costs the
  same way set-oriented SQL amortizes round trips and random IO.
  (In this package the callable is PyTorch: ``batch_fn`` defaults to
  ``torch.func.vmap(single_fn)``, and each is compiled per shape.)
* :class:`TableService` — an in-memory key→row "database" used for unit
  tests and the HIR interpreter (deterministic, no latency).

Each service also exposes counters (round trips, executed queries, batches)
so tests and benchmarks can assert the *mechanism*, not just timing.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Mapping, Optional, Protocol, Sequence

from repro_torch.core.concurrency import ShardedCounter

__all__ = [
    "QueryService",
    "ServiceStats",
    "TableService",
    "SimulatedDBService",
    "ModelService",
    "torch_block",
]


class QueryService(Protocol):
    """What the runtime requires of a backing service: a single-request
    call and a set-oriented batch call (the paper's batched query)."""

    def execute(self, query_name: str, params: tuple) -> Any:
        """Execute ONE query — one service round trip."""
        ...

    def execute_batch(self, query_name: str, params_list: Sequence[tuple]) -> list:
        """Execute many parameter sets of one query as a single
        set-oriented call, results in ``params_list`` order."""
        ...


class ServiceStats:
    """Service-side counters, striped across locks
    (:class:`~repro.core.concurrency.ShardedCounter`) so concurrent worker
    threads counting calls never convoy on one stats lock.  Fields
    compare/convert like numbers; ``snapshot`` returns plain values."""

    _COUNTERS = ("round_trips", "single_queries", "batches", "batched_items",
                 "padded_items")

    def __init__(self):
        for name in self._COUNTERS:
            setattr(self, name, ShardedCounter())
        self.busy_time = ShardedCounter()

    def snapshot(self) -> dict:
        """Plain-number copy of every counter."""
        d = {name: int(getattr(self, name)) for name in self._COUNTERS}
        d["busy_time"] = float(self.busy_time)
        return d


class _StatsMixin:
    def __init__(self):
        self.stats = ServiceStats()

    def _count(self, *, round_trips=0, single=0, batches=0, items=0, padded=0,
               busy=0.0):
        st = self.stats
        if round_trips:
            st.round_trips.add(round_trips)
        if single:
            st.single_queries.add(single)
        if batches:
            st.batches.add(batches)
        if items:
            st.batched_items.add(items)
        if padded:
            st.padded_items.add(padded)
        if busy:
            st.busy_time.add(busy)


class TableService(_StatsMixin):
    """Deterministic in-memory database: ``tables[name][key] -> row``.

    ``queries`` maps a query name to ``fn(tables, params) -> result`` so
    tests can define arbitrary deterministic queries.  The default query
    ``"<table>.lookup"`` returns ``tables[table].get(key)``.
    """

    def __init__(
        self,
        tables: Optional[Mapping[str, Mapping[Any, Any]]] = None,
        queries: Optional[Mapping[str, Callable]] = None,
        latency: float = 0.0,
        batch_latency: Optional[Callable[[int], float]] = None,
    ):
        super().__init__()
        self.tables = dict(tables or {})
        self.queries = dict(queries or {})
        self.latency = latency
        self.batch_latency = batch_latency

    def _run(self, query_name: str, params: tuple) -> Any:
        if query_name in self.queries:
            return self.queries[query_name](self.tables, params)
        if query_name.endswith(".lookup"):
            table = query_name[: -len(".lookup")]
            (key,) = params
            return self.tables[table].get(key)
        raise KeyError(f"unknown query {query_name!r}")

    def execute(self, query_name: str, params: tuple) -> Any:
        """One lookup/query (1 round trip; optional fixed latency)."""
        if self.latency:
            time.sleep(self.latency)
        self._count(round_trips=1, single=1)
        return self._run(query_name, params)

    def execute_batch(self, query_name: str, params_list: Sequence[tuple]) -> list:
        """Set-oriented form: one call, 3 round trips (§5.2.3)."""
        if self.batch_latency is not None:
            time.sleep(self.batch_latency(len(params_list)))
        elif self.latency:
            time.sleep(self.latency)
        self._count(round_trips=3, batches=1, items=len(params_list))
        return [self._run(query_name, p) for p in params_list]


class SimulatedDBService(_StatsMixin):
    """Latency-model service reproducing the paper's cost trade-offs.

    Cost model (times in seconds):
      single request : ``rtt + single_proc``           (1 round trip)
      batch of n     : ``3*rtt + batch_fixed + n*batch_proc``  (3 round trips)

    With ``single_proc > batch_proc`` (set-oriented plans beat n random
    probes — §5.2.1 "random IO at the database") and ``concurrency`` limiting
    how many requests the server truly overlaps (its CPUs/disks).  A
    ``threading.Semaphore(concurrency)`` models server capacity, so client
    threads beyond it queue — matching Fig. 5's plateau when threads exceed
    what the server exploits.
    """

    def __init__(
        self,
        rtt: float = 2e-3,
        single_proc: float = 1e-3,
        batch_proc: float = 2e-4,
        batch_fixed: float = 1e-3,
        concurrency: int = 8,
        compute_fn: Optional[Callable[[str, tuple], Any]] = None,
        fail_rate: float = 0.0,
        fail_seed: int = 0,
    ):
        super().__init__()
        self.rtt = rtt
        self.single_proc = single_proc
        self.batch_proc = batch_proc
        self.batch_fixed = batch_fixed
        self._server = threading.Semaphore(concurrency)
        self.compute_fn = compute_fn or (lambda q, p: (q, p))
        self.fail_rate = fail_rate
        self.fail_seed = fail_seed

    def _check_fault(self, query_name: str, params: tuple) -> None:
        """Deterministic failure injection for degraded-mode benchmarks: a
        ``fail_rate`` fraction of ``(query_name, params)`` identities always
        fails — pure in the seed, so A/B runs poison the same requests
        regardless of batching or thread interleaving."""
        if self.fail_rate <= 0.0:
            return
        from repro_torch.core.faults import InjectedParamError
        from repro_torch.core.resilience import hash_unit
        if hash_unit(self.fail_seed, "db", query_name,
                     params) < self.fail_rate:
            raise InjectedParamError(query_name, params)

    def execute(self, query_name: str, params: tuple) -> Any:
        """One simulated request: 1 round trip + single-query processing."""
        t0 = time.perf_counter()
        time.sleep(self.rtt / 2)
        self._check_fault(query_name, params)
        with self._server:
            time.sleep(self.single_proc)
            out = self.compute_fn(query_name, params)
        time.sleep(self.rtt / 2)
        self._count(round_trips=1, single=1, busy=time.perf_counter() - t0)
        return out

    def execute_batch(self, query_name: str, params_list: Sequence[tuple]) -> list:
        """One simulated set-oriented call: 3 round trips + batch costs.

        With ``fail_rate`` set, a batch containing any poisoned param fails
        as a whole (statement-level poisoning) — the runtime's
        fission-retry isolates the culprits."""
        n = len(params_list)
        t0 = time.perf_counter()
        # 3 round trips: parameter insert, batched query, cleanup (§5.2.3).
        time.sleep(self.rtt * 1.5)
        for p in params_list:
            self._check_fault(query_name, p)
        with self._server:
            time.sleep(self.batch_fixed + n * self.batch_proc)
            out = [self.compute_fn(query_name, p) for p in params_list]
        time.sleep(self.rtt * 1.5)
        self._count(round_trips=3, batches=1, items=n, busy=time.perf_counter() - t0)
        return out


class ModelService(_StatsMixin):
    """A PyTorch model as the query service (the ML-serving instantiation).

    ``single_fn(params...) -> result``; the batched form stacks the
    per-request parameter tuples along a new leading axis and runs
    ``batch_fn`` (default ``torch.func.vmap(single_fn)``) **once** — one
    device dispatch for the whole batch, the device analogue of the
    set-oriented query.  Results are split back per request.  The device is
    the tensors' own: nothing is moved and nothing falls back.

    Each forward is a compiled step (:mod:`repro_torch.serving.graphs`,
    the counterpart of the reference's jit): ``execute`` replays a step
    keyed on its parameters' shapes, dtypes and device, the batched form
    one keyed on the stacked shapes.  A step is built at its key's first
    use, from whichever thread calls first, and that call runs it; on the
    card it also records the step as a CUDA graph for the calls after it
    (each a replay); the parameters are copied (the batched ones
    stacked) straight into its static inputs and the results copied out of
    its outputs before the step is released.  On the CPU a step runs the
    function on its static inputs; under ``graphs.eager()`` it runs as
    plain ops.  A parameter that is not a tensor is part of the key and
    passed as it is.  ``steps`` maps each device to its steps.

    With ``pad_batches=True`` the batch axis is padded to a per-lane fixed
    bucket keyed by ``query_name``: a lane's bucket is the power of two of
    the largest batch it has seen, so each lane settles on ONE compiled
    step instead of one per distinct batch size the strategy emits (the
    analogue of the reference's jit cache, and of the paper's prepared
    statement).  ``lane_buckets`` exposes the current bucket per lane and
    ``stats.padded_items`` counts the filler rows paid for shape stability.
    """

    def __init__(self, single_fn: Callable, batch_fn: Optional[Callable] = None,
                 pad_batches: bool = False):
        super().__init__()
        import torch

        self.single_fn = single_fn
        self.batch_fn = batch_fn if batch_fn is not None else torch.func.vmap(single_fn)
        self.pad_batches = pad_batches
        self.lane_buckets: dict[str, int] = {}
        self.steps: dict = {}  # device -> graphs.StepCache
        self._steps_lock = threading.Lock()

    def execute(self, query_name: str, params: tuple) -> Any:
        """One model forward, blocking until the device result is ready."""
        self._count(round_trips=1, single=1)
        out = self._forward(False, [params])
        return torch_block(out)

    def execute_batch(self, query_name: str, params_list: Sequence[tuple]) -> list:
        """One device dispatch for the whole batch; blocks for the results.

        Equivalent to ``execute_batch_async(...)()`` — dispatch + resolve
        in one call."""
        return self.execute_batch_async(query_name, params_list)()

    def execute_batch_async(self, query_name: str,
                            params_list: Sequence[tuple]) -> Callable[[], list]:
        """Dispatch the batched forward WITHOUT blocking; returns a resolver.

        CUDA launches are asynchronous: the step's replay and the copy of
        its results return as soon as they are enqueued.  An event recorded
        on the current stream right after them marks the batch's end; the
        returned zero-arg resolver waits on that event (CPU results need no
        wait) and splits every leaf of the result per request — the
        paper's "results already fetched by the time they are consumed",
        at the service layer.
        """
        import torch
        from torch.utils._pytree import tree_leaves, tree_map

        n = len(params_list)
        n_pad = 0
        if self.pad_batches:
            bucket = max(self.lane_buckets.get(query_name, 1),
                         1 << (n - 1).bit_length())
            self.lane_buckets[query_name] = bucket
            n_pad = bucket - n
            # Repeat the last request as filler: same shapes/dtypes, results
            # beyond n are sliced away below.
            params_list = list(params_list) + [params_list[-1]] * n_pad
        self._count(round_trips=3, batches=1, items=n, padded=n_pad)
        pending = self._forward(True, params_list)  # enqueued, not waited on
        cuda = [a.device for a in tree_leaves(pending)
                if isinstance(a, torch.Tensor) and a.is_cuda]
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(cuda[0]))

        def resolve() -> list:
            """Wait for the dispatched batch and split it per request."""
            if done is not None:
                done.synchronize()
            return [tree_map(lambda a: a[i], pending) for i in range(n)]

        return resolve

    def _forward(self, batched: bool, params_list: Sequence[tuple]):
        """Replay the step of ``single_fn`` on ``params_list[0]``, or of
        ``batch_fn`` on the parameters stacked along a new leading axis,
        and return copies of its results."""
        import torch
        from torch.utils._pytree import tree_unflatten

        first = params_list[0]
        key = (batched, len(params_list) if batched else None,
               tuple((tuple(p.shape), p.dtype) if isinstance(p, torch.Tensor) else ("value", p)
                     for p in first))
        devices = {p.device for p in first if isinstance(p, torch.Tensor)}
        if len(devices) > 1:
            raise ValueError(f"a query's tensors lie on several devices: {devices}")
        device = devices.pop() if devices else torch.device("cpu")
        with self._step_cache(device).exclusive(key) as step:
            for i, p in enumerate(first):
                if not isinstance(p, torch.Tensor):
                    continue
                if batched:
                    torch.stack([ps[i] for ps in params_list], out=step.inputs[str(i)])
                else:
                    step.inputs[str(i)].copy_(p)
            outs = [o.clone() for o in step()]
        return tree_unflatten(outs, step.fn.tree)

    def _step_cache(self, device):
        from repro_torch.serving import graphs

        with self._steps_lock:
            if device not in self.steps:
                self.steps[device] = graphs.StepCache(
                    lambda key, pool, hold: self._build(key, device, pool, hold), device)
            return self.steps[device]

    def _build(self, key, device, pool, hold):
        """The step of one key: the function over static inputs shaped as
        the key says, returning its results' leaves (their structure kept
        as the step function's ``tree``)."""
        from torch.utils._pytree import tree_flatten

        from repro_torch.serving import graphs

        batched, n, specs = key
        fn = self.batch_fn if batched else self.single_fn
        tensors = {str(i): ((n, *s[0]) if batched else s[0], s[1])
                   for i, s in enumerate(specs) if s[0] != "value"}
        inputs = graphs.StaticInputs(tensors, device)
        args = [inputs[str(i)] if str(i) in tensors else s[1] for i, s in enumerate(specs)]

        def forward():
            leaves, forward.tree = tree_flatten(fn(*args))
            return tuple(leaves)

        return graphs.CompiledStep(forward, inputs, [], device, pool, hold)


def torch_block(x):
    """Wait until the CUDA work that produced every tensor in the pytree is
    done (each device's current stream); a no-op for CPU tensors.
    Returns ``x``."""
    import torch
    from torch.utils._pytree import tree_leaves

    for dev in {a.device for a in tree_leaves(x)
                if isinstance(a, torch.Tensor) and a.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()
    return x
