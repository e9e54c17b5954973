"""Per-tenant fair admission: deficit-weighted round-robin (DRR).

The engine's own wait queue stays strict FIFO — that ordering is part of
the v1.2 page-budget admission rule. Fairness therefore lives one layer
up: the :class:`EngineDriver` holds accepted-but-not-yet-offered requests
in a :class:`FairScheduler` and only hands the engine as many as it has
free slots, so the DRR decision *is* the admission order.

DRR (Shreedhar & Varghese): each tenant owns a FIFO queue and a deficit
counter in "committed tokens" (clipped prompt + generation budget — the
same unit the v1.1 ``max_resident_tokens`` cap meters). Tenants sit on a
round-robin ring; when the ring reaches a tenant, its deficit grows by
``quantum * weight`` and it may release requests while the deficit covers
the head request's cost. A tenant that empties its queue loses its
deficit (no banking idle credit), so a flooding tenant can never starve a
trickling one: per ring rotation every backlogged tenant moves
O(quantum * weight) tokens regardless of how deep any other queue is.

Two caps compose with the engine's own admission budgets:

* ``max_pending`` — bound on requests waiting in the frontend across all
  tenants; past it, ``push`` refuses and the driver sheds the request
  with finish_reason ``"rejected"`` (HTTP 429).
* ``tenant_max_resident_tokens`` — per-tenant bound on committed tokens
  *inside the engine* (offered and not yet retired). A tenant at its cap
  is skipped without replenishing its deficit (blocked turns must not
  bank credit) until retirements free room.

Thread safety: this class is plain data guarded by the driver's lock —
every method is called with the :class:`EngineDriver` condition held.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Any, Callable, Dict, Iterator, List, Optional


class _TenantQueue:
    __slots__ = ("name", "q", "deficit", "inflight_tokens")

    def __init__(self, name: str):
        self.name = name
        self.q: deque = deque()
        self.deficit = 0.0
        self.inflight_tokens = 0  # committed tokens offered, not retired


class FairScheduler:
    """Deficit-weighted round-robin over per-tenant FIFO queues.

    Args:
      quantum: deficit replenished per ring visit, in committed tokens.
        Smaller → finer interleaving (more alternation between tenants);
        larger → longer per-tenant runs. Must be >= 1.
      weights: tenant → relative share (default 1.0 each). A tenant with
        weight 2 replenishes twice the deficit per rotation, i.e. twice
        the admission bandwidth under contention.
      max_pending: cap on waiting requests across all tenants (None = no
        cap); ``push`` returns a shed reason past it.
      tenant_max_resident_tokens: per-tenant cap on committed tokens
        concurrently inside the engine (None = no cap).
      cost: request → committed-token cost. The driver binds this to the
        engine's ``min(len(prompt), capacity) + max_new_tokens`` rule;
        the default uses the unclipped prompt length.
    """

    def __init__(self, *, quantum: int = 256,
                 weights: Optional[Dict[str, float]] = None,
                 max_pending: Optional[int] = None,
                 tenant_max_resident_tokens: Optional[int] = None,
                 cost: Optional[Callable[[Any], int]] = None):
        if quantum < 1:
            raise ValueError("quantum must be >= 1")
        if max_pending is not None and max_pending < 1:
            raise ValueError("max_pending must be >= 1 (None disables)")
        if tenant_max_resident_tokens is not None \
                and tenant_max_resident_tokens < 1:
            raise ValueError("tenant_max_resident_tokens must be >= 1 "
                             "(None disables)")
        self.quantum = quantum
        self.weights = dict(weights or {})
        self.max_pending = max_pending
        self.tenant_max_resident_tokens = tenant_max_resident_tokens
        self._cost = cost
        # ring order = insertion order of tenants with live state; tenants
        # are dropped once both queue and inflight are empty
        self._tenants: "OrderedDict[str, _TenantQueue]" = OrderedDict()
        self._ring: deque = deque()      # tenant names, rotation order
        self._pending = 0
        # True when the front tenant's turn has not replenished yet; a
        # turn spans pop() calls and ends when the ring rotates
        self._turn_fresh = True

    # ------------------------------------------------------------- plumbing
    def bind_cost(self, cost: Callable[[Any], int]) -> None:
        """Install the engine-derived cost rule (driver start-time hook);
        an explicitly constructed ``cost=`` wins."""
        if self._cost is None:
            self._cost = cost

    def _tenant_of(self, h: Any) -> str:
        return getattr(h.params, "tenant", "") or ""

    def _weight(self, tenant: str) -> float:
        w = float(self.weights.get(tenant, 1.0))
        return w if w > 0 else 1.0

    def _get(self, tenant: str) -> _TenantQueue:
        tq = self._tenants.get(tenant)
        if tq is None:
            tq = self._tenants[tenant] = _TenantQueue(tenant)
            self._ring.append(tenant)
        return tq

    def _rotate(self) -> None:
        """End the front tenant's turn: advance the ring; the next front
        tenant starts a fresh turn (entitled to one replenish)."""
        self._ring.rotate(-1)
        self._turn_fresh = True

    def _gc(self, tq: _TenantQueue) -> None:
        """Drop a tenant with no queued and no inflight work (its deficit
        must not survive idleness — that would bank credit)."""
        if not tq.q and tq.inflight_tokens <= 0:
            self._tenants.pop(tq.name, None)
            if self._ring and self._ring[0] == tq.name:
                self._turn_fresh = True  # front changes: fresh turn
            try:
                self._ring.remove(tq.name)
            except ValueError:
                pass

    def cost(self, h: Any) -> int:
        if self._cost is not None:
            return int(self._cost(h))
        return len(h.prompt) + h.params.max_new_tokens

    # ------------------------------------------------------------- mutation
    def push(self, h: Any) -> Optional[str]:
        """Queue a request under its tenant. Returns ``None`` when
        accepted, or a human-readable shed reason (the driver turns it
        into finish_reason ``"rejected"``)."""
        if self.max_pending is not None and self._pending >= self.max_pending:
            return (f"frontend queue full ({self._pending}/"
                    f"{self.max_pending} pending)")
        self._get(self._tenant_of(h)).q.append(h)
        self._pending += 1
        return None

    def pop(self) -> Optional[Any]:
        """Release the next request under DRR order, or ``None`` when no
        tenant can be served right now (empty, or every backlogged tenant
        is at its resident-token cap).

        Charges the request's cost to the tenant's deficit and inflight
        account; the driver must call :meth:`retire` when the request
        leaves the engine.
        """
        # one replenish per tenant per *ring visit* (a visit may span many
        # pop() calls while the deficit lasts; it ends — and the ring
        # rotates — the moment the deficit stops covering the head), so
        # the scan terminates: after a full ring pass either someone's
        # deficit covered their head request or nobody is servable
        for _ in range(len(self._ring)):
            name = self._ring[0]
            tq = self._tenants[name]
            if not tq.q:
                tq.deficit = 0.0
                self._rotate()
                self._gc(tq)
                continue
            head_cost = self.cost(tq.q[0])
            cap = self.tenant_max_resident_tokens
            if cap is not None and tq.inflight_tokens + head_cost > cap:
                # blocked on its own cap: skip WITHOUT replenishing, so a
                # capped tenant cannot bank an unbounded deficit
                self._rotate()
                continue
            if tq.deficit < head_cost:
                if self._turn_fresh:
                    tq.deficit += self.quantum * self._weight(name)
                    self._turn_fresh = False
                if tq.deficit < head_cost:
                    self._rotate()
                    continue
            h = tq.q.popleft()
            tq.deficit -= head_cost
            if not tq.q:
                tq.deficit = 0.0  # no banking credit while idle
            tq.inflight_tokens += head_cost
            h._drr_cost = head_cost  # retire() refunds exactly this
            self._pending -= 1
            return h
        return None

    def retire(self, h: Any) -> None:
        """Refund a previously popped request's inflight tokens (called at
        engine retirement on every finish path)."""
        cost = getattr(h, "_drr_cost", None)
        if cost is None:
            return
        h._drr_cost = None
        tq = self._tenants.get(self._tenant_of(h))
        if tq is None:
            return
        tq.inflight_tokens = max(tq.inflight_tokens - cost, 0)
        self._gc(tq)

    def remove(self, h: Any) -> bool:
        """Withdraw a still-queued request (cancel before offer)."""
        tq = self._tenants.get(self._tenant_of(h))
        if tq is None:
            return False
        try:
            tq.q.remove(h)
        except ValueError:
            return False
        self._pending -= 1
        self._gc(tq)
        return True

    def drain(self) -> List[Any]:
        """Remove and return every waiting request (driver shutdown path);
        inflight accounting is untouched."""
        out: List[Any] = []
        for tq in list(self._tenants.values()):
            out.extend(tq.q)
            tq.q.clear()
            tq.deficit = 0.0
            self._gc(tq)
        self._pending = 0
        return out

    # ---------------------------------------------------------------- reads
    def __len__(self) -> int:
        return self._pending

    def pending(self) -> Iterator[Any]:
        """Iterate waiting requests across tenants (deadline sweeps)."""
        for tq in self._tenants.values():
            yield from tq.q

    def pending_by_tenant(self) -> Dict[str, int]:
        return {name: len(tq.q) for name, tq in self._tenants.items()
                if tq.q}

    def inflight_by_tenant(self) -> Dict[str, int]:
        return {name: tq.inflight_tokens
                for name, tq in self._tenants.items()
                if tq.inflight_tokens}
