"""Data-parallel router over N serving cells on one device.

N independent :class:`~repro_torch.serve.engine.BatchedEngine` cells, each
keeping its host-sync-free tick, behind one admission point.  The router is
host-side policy only; it adds no per-tick host synchronization:

- **Admission** routes each request (FIFO, like the engine's own
  ``admit``) to a cell chosen by, in order:

  1. *prefix affinity*: the cell whose :class:`PagePool` holds the deepest
     chain-hash match for the request's leading full prompt pages, so that
     refcount sharing keeps working across the fleet (pages live in one
     cell's pool; a prefix split across cells shares nothing);
  2. *least-loaded*: most free pages (dense cells: most free slots), ties
     to the lowest cell index.

  Failover walks the remaining candidates when the chosen cell cannot take
  the request (pool exhausted, slots full); a request no candidate can take
  stops admission (FIFO order is kept).  A request whose page reservation
  exceeds every usable cell's whole pool is rejected outright (the
  engine's own never-admittable rule, applied fleet-wide).

- **Draining**: :meth:`drain` takes a cell out of admission (its resident
  requests finish normally); :meth:`undrain` puts it back.

- **Harvest**: :meth:`sync` takes every cell's pending device-side history
  and stats (:meth:`BatchedEngine._pending_harvest`) and fetches them with
  one transfer (:func:`~repro_torch.serve.engine.fetch_harvests`), then
  replays each cell's host bookkeeping: N cells cost one transfer per
  harvest, as one cell does.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.serve.engine import (_SYNC_STRIDE, BatchedEngine, PagePool,
                                      Request, fetch_harvests)


class CellRouter:
    def __init__(self, cells: Sequence[BatchedEngine],
                 prefix_affinity: bool = True):
        if not cells:
            raise ValueError("CellRouter needs at least one cell")
        self.cells: List[BatchedEngine] = list(cells)
        self.prefix_affinity = prefix_affinity
        self._drained = set()
        self.tick_count = 0

    # ---- observability ----

    @property
    def num_cells(self) -> int:
        return len(self.cells)

    def active_requests(self) -> List[Request]:
        return [r for c in self.cells for r in c.slots
                if r is not None and not r.done]

    def drain(self, cell: int) -> None:
        """Stop admitting to ``cell`` (its resident requests finish)."""
        self._drained.add(cell)

    def undrain(self, cell: int) -> None:
        self._drained.discard(cell)

    @property
    def drained(self) -> frozenset:
        return frozenset(self._drained)

    def cell_stats(self) -> List[dict]:
        """Each cell's load and occupancy."""
        out = []
        for i, c in enumerate(self.cells):
            row = {"cell": i, "drained": i in self._drained,
                   "ticks": c.tick_count,
                   "live_slots": sum(1 for r in c.slots
                                     if r is not None and not r.done),
                   "slots": len(c.slots)}
            if c.pool is not None:
                row.update(
                    num_pages=c.num_pages,
                    occupied_pages=c.pool.occupied_pages,
                    utilization=c.pool.occupied_pages
                    / max(c.num_pages, 1),
                    shared_prefix_hits=c.pool.shared_hits)
            out.append(row)
        return out

    # ---- admission policy ----

    def _usable(self, req: Request) -> List[int]:
        """Cells that could ever hold ``req``: not drained, and a pool
        whose total covers the page reservation (dense cells always)."""
        out = []
        for i, c in enumerate(self.cells):
            if i in self._drained:
                continue
            if c.pool is not None and c._page_reserve(req) > c.num_pages:
                continue
            out.append(i)
        return out

    def _affinity_depth(self, cell: BatchedEngine, req: Request) -> int:
        """Leading full prompt pages of ``req`` already in ``cell``'s pool
        (the chain hash vouches for the whole path)."""
        if cell.pool is None or not cell.cfg.prefix_sharing:
            return 0
        depth = 0
        for h in PagePool.prefix_hashes(req.prompt, cell.cfg.page_size):
            if cell.pool.lookup_prefix(h) is None:
                break
            depth += 1
        return depth

    def _load_key(self, i: int):
        """Least-loaded first: most free pages (dense: most free slots),
        then the lowest index."""
        c = self.cells[i]
        if c.pool is not None:
            free = c.pool.free_pages
        else:
            free = sum(1 for r in c.slots if r is None or r.done)
        return (-free, i)

    def _candidates(self, req: Request) -> List[int]:
        usable = self._usable(req)
        usable.sort(key=self._load_key)
        if self.prefix_affinity and usable:
            depths = {i: self._affinity_depth(self.cells[i], req)
                      for i in usable}
            if max(depths.values()) > 0:
                # affinity cells first (deepest match, then load), the
                # rest in load order as failover
                usable.sort(key=lambda i: (-depths[i],) + self._load_key(i))
        return usable

    def admit(self, reqs: List[Request]) -> int:
        """Route as many of ``reqs`` (in order) as the fleet can take.
        Each request tries its candidate cells in policy order, and
        admission stops at the first request no cell can take.  Returns
        how many requests were consumed (admitted or rejected)."""
        consumed = 0
        for req in reqs:
            candidates = self._candidates(req)
            if not candidates:
                if any(i not in self._drained
                       for i in range(len(self.cells))):
                    # admitting cells exist, but none can ever hold the
                    # reservation: reject fleet-wide, keep consuming
                    req.rejected = True
                    req.done = True
                    consumed += 1
                    continue
                break                    # every cell drained: hold the queue
            if not any(self.cells[i].admit([req]) == 1 for i in candidates):
                break                    # fleet saturated: FIFO stop
            consumed += 1
        return consumed

    # ---- the sync-free tick ----

    def step(self) -> None:
        """One decode tick on every cell, with no host transfer."""
        for c in self.cells:
            c.step()
        self.tick_count += 1

    def sync(self) -> None:
        """Harvest every cell with one device->host transfer."""
        pendings = [c._pending_harvest() for c in self.cells]
        if not any(pendings):
            return
        for cell, harvest in zip(self.cells, fetch_harvests(pendings)):
            if harvest:
                cell._apply_harvest(harvest)

    # ---- the serve loop ----

    def run(self, requests: List[Request],
            max_ticks: int = 10_000) -> List[Request]:
        """Continuous batching across the fleet: the router's form of
        :meth:`BatchedEngine.run` (the same livelock guards and
        harvest-bounded stretches of ticks)."""
        pending = list(requests)
        admitted: List[Request] = []
        while self.tick_count < max_ticks:
            n = 0
            if pending:
                n = self.admit(pending)   # each cell's admit syncs and reaps
                admitted.extend(pending[:n])
                del pending[:n]
            else:
                self.sync()
            active = self.active_requests()
            if not pending and not active:
                break
            if pending and not active and n == 0:
                break                     # nothing can free capacity
            if pending:
                self.step()
            else:
                bound = max(r.max_new_tokens - len(r.generated)
                            for r in active)
                bound = min(bound, _SYNC_STRIDE,
                            max_ticks - self.tick_count)
                for _ in range(max(1, bound)):
                    self.step()
        self.sync()
        return admitted


def make_cells(model, params, cfg, n_cells: int,
               policy=None) -> CellRouter:
    """``n_cells`` identical cells over one model and one parameter set,
    behind one router.  ``cfg`` describes one cell, so ``n_cells``
    multiplies the fleet's slots and pages; the parameters are shared
    tensors, not copies."""
    return CellRouter([BatchedEngine(model, params, cfg, policy=policy)
                       for _ in range(n_cells)])
