"""KVView: the one capacity/placement interface the scheduler consumes.

The scheduler used to reach into the engine through a hand-delegated
quartet (``n_free``/``n_free_for``/``free_lanes``/``lane_benefits``), each
mirrored on :class:`~repro.serving.engine.InferenceEngine` as a
pass-through to its :class:`~repro.serving.engine.KVPartition`.  That
duplication is what made swapping the KV backend invasive: a paged pool
would have to re-mirror four methods on the engine.

:class:`KVView` names the contract once.  Both backends implement it —
the dense lane partition (:class:`~repro.serving.engine.KVPartition`)
and the paged pool's capacity view
(:class:`~repro.serving.paged_kv.PagedKVView`) — and engines expose it as
``engine.kv``.  The scheduler binds ``engine.kv`` when present and falls
back to the engine itself, so duck-typed bench/test engines keep working
unchanged.

The contract (all in *allocation units* — lanes today; a paged backend
reports lane-equivalents bounded by its instantaneous page budget, and
under oversubscription ``n_free_for`` additionally subtracts the pages
still owed to other templates' quotas — a reservation is a floor on
*pages*, not just lanes, so a shared-pool burst can never starve a
reserved template's page budget):

* ``n_free`` — total free units.
* ``n_free_for(template)`` — units ``template`` may allocate right now
  (its reservation plus the shared pool).
* ``alloc(template)`` / ``release(unit)`` — take/return one unit.
* ``benefits(unit, template)`` — would releasing ``unit`` raise
  ``n_free_for(template)``?  (Speculative-sizing hint.)
* ``free_lanes`` — sorted snapshot of free units (introspection).
"""
from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

__all__ = ["KVView"]


@runtime_checkable
class KVView(Protocol):
    """Structural protocol for KV capacity/placement backends."""

    @property
    def n_free(self) -> int:
        """Total free allocation units across every pool."""
        ...

    def n_free_for(self, template: Optional[str]) -> int:
        """Units ``template`` may allocate right now."""
        ...

    def alloc(self, template: Optional[str]) -> int:
        """Take one unit for ``template`` (reserved pool first)."""
        ...

    def release(self, unit: int) -> None:
        """Return a unit to its home pool."""
        ...

    def benefits(self, unit: int, template: Optional[str]) -> bool:
        """Whether releasing ``unit`` raises ``n_free_for(template)``."""
        ...

    @property
    def free_lanes(self) -> list[int]:
        """Sorted snapshot of every free unit (introspection)."""
        ...
