"""Batched serving engine with a host-sync-free decode tick.

The decode state is a fixed ``[B, ...]`` cache (KV strips for a
transformer, the SSM state and conv history for a mamba model, both for a
hybrid); requests
claim a slot, a prefill writes that slot's cache entries, and every tick
advances all slots by one token.  With ``ServeConfig.page_size`` set the
cache is paged: a pool of fixed-size pages plus per-slot block tables on
the device.
Admission is then by page budget: a request reserves the pages its
``prompt + max_new_tokens - 1`` frontier can reach, and leading full prompt
pages are shared by refcount across requests with a common prefix (the
frontier page is always fresh, so decode writes never alias).  A reaped
slot's table row resets to the sentinel ``num_pages``; its writes then drop
(models/attention.py) while its ``pos`` keeps advancing.

The tick makes no host transfer: the last tokens, the liveness mask and
the per-slot budgets live on the device, and the tick is decode + greedy
argmax + EOS/length masking in device ops.  Emitted tokens accumulate as
device vectors; :meth:`sync` drains them (and the paged per-tick stats)
with one stacked transfer, in two halves: ``_pending_harvest`` stacks on
the device, ``_apply_harvest`` replays on the host (a router fetches every
cell's pending harvest in one transfer between them).  The host synchronizes only at admission,
where a new request needs a prefill and a slot decision.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

#: max ticks between harvest syncs once admissions have drained
_SYNC_STRIDE = 64


def fetch_harvests(pendings: List[dict]) -> List[dict]:
    """Fetch pending harvests (:meth:`BatchedEngine._pending_harvest`)
    to the host in one transfer: every device tensor is flattened into
    one int32 vector, copied with one ``.cpu()``, and split back into
    numpy arrays of the same shapes; host entries pass through."""
    tensors = [t for p in pendings for t in p.values()
               if isinstance(t, torch.Tensor)]
    if not tensors:
        return [dict(p) for p in pendings]
    host = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    out, off = [], 0
    for p in pendings:
        got = {}
        for key, t in p.items():
            if isinstance(t, torch.Tensor):
                got[key] = host[off:off + t.numel()].reshape(t.shape)
                off += t.numel()
            else:
                got[key] = t
        out.append(got)
    return out


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int
    max_seq_len: int
    max_new_tokens: int = 64
    eos_id: int = 1
    greedy: bool = True                  # the only sampling; not read
    # ---- paged KV cache (None = dense per-slot strips) ----
    page_size: Optional[int] = None
    num_pages: Optional[int] = None      # None = dense-equivalent pool
    prefix_sharing: bool = True
    # pool sized by a device-byte budget when num_pages is None: an int8
    # page costs less (BatchedEngine.page_footprint_bytes), so the same
    # bytes hold more pages
    kv_pool_bytes: Optional[int] = None

    @property
    def paged(self) -> bool:
        return self.page_size is not None

    @property
    def max_pages_per_slot(self) -> int:
        if self.page_size is None:
            raise ValueError("max_pages_per_slot needs a page_size")
        return -(-self.max_seq_len // self.page_size)


class PagePool:
    """Host-side allocator for the KV page pool: refcounted page ids, and a
    chain-hash index of full prompt pages for prefix sharing.  A page
    returns to the free list only when its refcount reaches 0."""

    def __init__(self, num_pages: int, page_size: int):
        self.num_pages = num_pages
        self.page_size = page_size
        self._free = list(range(num_pages - 1, -1, -1))   # pop() -> ascending
        self.refcount: dict = {}
        self._prefix: dict = {}       # chain hash -> page id
        self._hash_of: dict = {}      # page id -> chain hash
        self.shared_hits = 0          # pages not allocated thanks to sharing

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def occupied_pages(self) -> int:
        return self.num_pages - len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: need {n}, have {len(self._free)}")
        ids = [self._free.pop() for _ in range(n)]
        for p in ids:
            self.refcount[p] = 1
        return ids

    def retain(self, page_id: int) -> None:
        if self.refcount.get(page_id, 0) <= 0:
            raise RuntimeError(f"retain of free page {page_id}")
        self.refcount[page_id] += 1

    def release(self, page_id: int) -> None:
        rc = self.refcount[page_id] - 1
        if rc > 0:
            self.refcount[page_id] = rc
            return
        del self.refcount[page_id]
        h = self._hash_of.pop(page_id, None)
        if h is not None:
            self._prefix.pop(h, None)
        self._free.append(page_id)

    def lookup_prefix(self, chain_hash) -> Optional[int]:
        return self._prefix.get(chain_hash)

    def publish_prefix(self, chain_hash, page_id: int) -> None:
        if chain_hash not in self._prefix and page_id not in self._hash_of:
            self._prefix[chain_hash] = page_id
            self._hash_of[page_id] = chain_hash

    @staticmethod
    def prefix_hashes(prompt: List[int], page_size: int) -> List:
        """One chain hash per full page of prompt tokens."""
        out, h = [], hash(("uisa-kv-page-chain",))
        for i in range(len(prompt) // page_size):
            h = hash((h, tuple(prompt[i * page_size:(i + 1) * page_size])))
            out.append(h)
        return out


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 64
    slot: Optional[int] = None
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # the page reservation can never fit the pool: done without a slot
    rejected: bool = False


class BatchedEngine:
    def __init__(self, model, params, cfg: ServeConfig, policy=None):
        if policy is not None:
            model = model.with_policy(policy)
        self.model = model
        self.policy = model.policy
        self.param_layout = getattr(model, "param_layout", None)
        self.params = params
        self.cfg = cfg
        self.device = model.device
        b = cfg.batch_slots
        self._paged = cfg.paged
        if self._paged:
            self._max_pages = cfg.max_pages_per_slot
            if cfg.num_pages is not None:
                self.num_pages = cfg.num_pages
            elif cfg.kv_pool_bytes is not None:
                self.num_pages = max(
                    cfg.kv_pool_bytes // self.page_footprint_bytes(), 1)
            else:
                self.num_pages = b * self._max_pages
            self.pool: Optional[PagePool] = PagePool(self.num_pages,
                                                     cfg.page_size)
            self._slot_pages: List[List[int]] = [[] for _ in range(b)]
            self.cache = model.init_paged_cache(
                b, self.num_pages, cfg.page_size, self._max_pages)
        else:
            self.pool = None
            self.cache = model.init_cache(b, cfg.max_seq_len)
        self._stats_history: List[torch.Tensor] = []
        self.tick_stats: List[dict] = []
        self.slots: List[Optional[Request]] = [None] * b
        # device-resident tick state (never read per tick)
        dev = self.device
        self.last_tokens = torch.zeros(b, dtype=torch.int32, device=dev)
        self.live = torch.zeros(b, dtype=torch.bool, device=dev)
        self.remaining = torch.zeros(b, dtype=torch.int32, device=dev)
        self._history: List[torch.Tensor] = []
        self.tick_count = 0

    def page_footprint_bytes(self) -> int:
        """Device bytes one KV page costs across the layer stack: the K and
        V blocks, plus the f32 per-(token, head) scales when the cache is
        int8, which then costs ``hd + 4`` bytes per token, head and
        direction against ``itemsize * hd``."""
        mcfg = self.model.cfg
        hkv, hd = mcfg.num_kv_heads, mcfg.resolved_head_dim
        ps = self.cfg.page_size
        if self.model.par.kv_cache_int8:
            per_layer = 2 * hkv * ps * (hd + 4)
        else:
            itemsize = torch.empty((), dtype=getattr(torch, mcfg.dtype)
                                   ).element_size()
            per_layer = 2 * hkv * ps * hd * itemsize
        return mcfg.num_layers * per_layer

    # ---- slot management ----

    def _free_slot(self) -> Optional[int]:
        for i, r in enumerate(self.slots):
            if r is None or r.done:
                return i
        return None

    def add_request(self, req: Request) -> bool:
        """Claim a slot and prefill it.  False if the engine is full."""
        return self.admit([req]) == 1

    def admit(self, reqs: List[Request]) -> int:
        """Batched admission: prefill as many of ``reqs`` (in order) as
        there are free slots (and, paged, free pages), then fetch all
        first tokens in one host transfer.  Returns how many requests were
        consumed (admitted or rejected)."""
        self.sync()
        if self._paged:
            self._reap_done_pages()
        staged = []
        consumed = 0
        for req in reqs:
            if self._paged and self._page_reserve(req) > self.num_pages:
                # no amount of draining ever admits this request
                req.rejected = True
                req.done = True
                consumed += 1
                continue
            slot = self._free_slot()
            if slot is None:
                break
            if self._paged:
                plan = self._plan_pages(req)
                if plan is None:
                    break
            req.slot = slot
            self.slots[slot] = req
            toks = torch.tensor([req.prompt], dtype=torch.int32,
                                device=self.device)
            logits, cache1 = self.model.prefill(self.params, {"tokens": toks})
            if self._paged:
                self._write_slot_paged(slot, cache1, len(req.prompt), *plan)
            else:
                self._write_slot(slot, cache1)
            staged.append((req, slot, torch.argmax(logits[0]).to(torch.int32)))
            consumed += 1
        if not staged:
            return consumed
        idx = torch.tensor([s for _, s, _ in staged], dtype=torch.long,
                           device=self.device)
        firsts_dev = torch.stack([t for _, _, t in staged])
        budgets = torch.tensor(
            [max(r.max_new_tokens - 1, 0) for r, _, _ in staged],
            dtype=torch.int32, device=self.device)
        firsts = firsts_dev.cpu().numpy()          # the one admission sync
        alive = []
        for (req, _, _), tok in zip(staged, firsts):
            tok = int(tok)
            req.generated.append(tok)
            req.done = (tok == self.cfg.eos_id
                        or len(req.generated) >= req.max_new_tokens)
            alive.append(not req.done)
        self.last_tokens[idx] = firsts_dev
        self.live[idx] = torch.tensor(alive, dtype=torch.bool,
                                      device=self.device)
        self.remaining[idx] = budgets
        return consumed

    def _write_slot(self, slot: int, cache1) -> None:
        """Copy a batch-1 prefill cache into dense slot ``slot``, leaf by
        leaf: a ``[layers, B, ...]`` leaf takes the slot's whole slice,
        zero-padded along its sequence axes (a KV strip past the prompt, or
        a state leaf overwritten outright: a dead slot's state has drifted
        while it ticked); a ``[B, ...]`` leaf (``pos``) takes the slot's
        entry.  A leaf longer than the slot along any axis (a prompt past
        ``max_seq_len``) raises ``ValueError`` before any leaf is
        written, as the JAX engine's pad refuses it."""
        pairs = []
        for key, full in self.cache.items():
            one = cache1[key]
            if one.dim() >= 2 and full.dim() == one.dim() \
                    and full.shape[0] == one.shape[0] \
                    and full.shape[1] == len(self.slots):
                dst, src = full[:, slot], one[:, 0]
            else:
                dst, src = full[slot], one[0]
            if dst.dim() != src.dim() or any(
                    b > a for a, b in zip(dst.shape, src.shape)):
                raise ValueError(
                    f"prefill cache leaf {key!r} of shape "
                    f"{tuple(src.shape)} does not fit the slot's "
                    f"{tuple(dst.shape)} (max_seq_len "
                    f"{self.cfg.max_seq_len})")
            pairs.append((dst, src))
        for dst, src in pairs:
            if dst.shape == src.shape:
                dst.copy_(src)
                continue
            dst.zero_()
            region = tuple(slice(0, min(a, b))
                           for a, b in zip(dst.shape, src.shape))
            dst[region].copy_(src[region])

    # ---- paged slot management ----

    def _reap_done_pages(self) -> None:
        """Release every finished slot's pages and reset its table row to
        the sentinel (its later writes drop)."""
        for slot, req in enumerate(self.slots):
            if req is None or not req.done or not self._slot_pages[slot]:
                continue
            for p in self._slot_pages[slot]:
                self.pool.release(p)
            self._slot_pages[slot] = []
            self.cache["block_tables"][slot] = self.num_pages

    def _page_reserve(self, req: Request) -> int:
        """Pages ``req``'s frontier can ever reach."""
        ps = self.cfg.page_size
        total = min(len(req.prompt) + max(req.max_new_tokens, 1) - 1,
                    self.cfg.max_seq_len)
        total = max(total, len(req.prompt))
        return -(-total // ps)

    def _plan_pages(self, req: Request):
        """Reserve the pages ``req`` can reach, sharing leading full prompt
        pages (at most ``reserve - 1``: the tail page is always owned).
        Returns ``(page_ids, n_shared)``, or None when the pool cannot
        cover the reservation (nothing is mutated then)."""
        ps = self.cfg.page_size
        reserve = self._page_reserve(req)
        shared: List[int] = []
        hashes = (PagePool.prefix_hashes(req.prompt, ps)[:reserve - 1]
                  if self.cfg.prefix_sharing else [])
        for h in hashes:
            pid = self.pool.lookup_prefix(h)
            if pid is None:
                break
            shared.append(pid)
        if reserve - len(shared) > self.pool.free_pages:
            return None
        for pid in shared:
            self.pool.retain(pid)
        self.pool.shared_hits += len(shared)
        page_ids = shared + self.pool.alloc(reserve - len(shared))
        for h, pid in zip(hashes, page_ids):
            self.pool.publish_prefix(h, pid)
        return page_ids, len(shared)

    def _write_slot_paged(self, slot: int, cache1, prompt_len: int,
                          page_ids: List[int], n_shared: int) -> None:
        """Scatter a batch-1 prefill cache into the slot's fresh prompt
        pages (shared prefix pages already hold the same rows)."""
        ps = self.cfg.page_size
        self._slot_pages[slot] = page_ids
        row = np.full((self._max_pages,), self.num_pages, np.int32)
        row[:len(page_ids)] = page_ids
        self.cache["block_tables"][slot] = torch.from_numpy(row).to(
            self.device)
        self.cache["pos"][slot] = prompt_len
        n_prompt_pages = -(-prompt_len // ps)
        write_ids = page_ids[n_shared:n_prompt_pages]
        if not write_ids:
            return
        ids = torch.tensor(write_ids, dtype=torch.long, device=self.device)
        pad = n_prompt_pages * ps - prompt_len
        pairs = [("k_pages", "k"), ("v_pages", "v")]
        if "k_scale_pages" in self.cache:
            # int8 pools: the prefill's scale strips ([L,1,Hkv,plen,1])
            # scatter through the same page ids into the scale pools
            pairs += [("k_scale_pages", "k_scale"),
                      ("v_scale_pages", "v_scale")]
        for pool_name, strip_name in pairs:
            strip = cache1[strip_name][:, 0]             # [L,Hkv,plen,hd]
            if pad:
                strip = torch.nn.functional.pad(strip, (0, 0, 0, pad))
            nl, hkv, _, hd = strip.shape
            pages = strip.reshape(nl, hkv, n_prompt_pages, ps, hd
                                  ).permute(0, 2, 1, 3, 4)
            pool = self.cache[pool_name]
            pool[:, ids] = pages[:, n_shared:n_prompt_pages].to(pool.dtype)

    # ---- ticking ----

    def step(self) -> None:
        """One decode tick for all slots, with no host transfer.  Dead slots
        keep their token frozen (their cache writes land past their
        frontier or, paged, on the trash page)."""
        logits, self.cache = self.model.decode_step(
            self.params, self.last_tokens, self.cache)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        live = self.live
        nxt = torch.where(live, nxt, self.last_tokens)
        self.remaining = torch.where(live, self.remaining - 1, self.remaining)
        self.live = live & (nxt != self.cfg.eos_id) & (self.remaining > 0)
        if self._paged:
            # live slots and the pages their frontiers reached (ceil: a
            # frontier exactly on a page boundary has written k pages)
            ps = self.cfg.page_size
            frontier = torch.where(
                self.live, torch.div(self.cache["pos"] + ps - 1, ps,
                                     rounding_mode="floor"),
                torch.zeros_like(self.cache["pos"]))
            self._stats_history.append(torch.stack([
                self.live.sum(dtype=torch.int32),
                frontier.sum(dtype=torch.int32)]))
        self.last_tokens = nxt
        self._history.append(nxt)
        self.tick_count += 1

    def _pending_harvest(self) -> dict:
        """The device half of :meth:`sync`: stack the token history (and
        the paged per-tick stats) into device tensors and clear the
        buffers, with no transfer.  The caller fetches the returned dict
        (:func:`fetch_harvests`): this engine's own :meth:`sync`, or a
        :class:`~repro_torch.serve.router.CellRouter` fetching every
        cell's pending harvest at once."""
        pending: dict = {}
        if self._history:
            pending["hist"] = torch.stack(self._history)          # [T, B]
            self._history = []
        if self._stats_history:
            pending["stats"] = torch.stack(self._stats_history)   # [T, 2]
            pending["stats_base"] = self.tick_count \
                - len(self._stats_history)
            self._stats_history = []
        return pending

    def _apply_harvest(self, harvest: dict) -> None:
        """The host half of :meth:`sync`: replay a fetched harvest (numpy
        arrays) into the requests and the ``tick_stats`` rows."""
        hist = harvest.get("hist")
        if hist is not None:
            for t in range(hist.shape[0]):
                for slot, req in enumerate(self.slots):
                    if req is None or req.done:
                        continue
                    tok = int(hist[t, slot])
                    req.generated.append(tok)
                    if tok == self.cfg.eos_id or \
                            len(req.generated) >= req.max_new_tokens:
                        req.done = True
        rows = harvest.get("stats")
        if rows is not None:
            base = int(harvest["stats_base"])
            for i in range(rows.shape[0]):
                self.tick_stats.append({
                    "tick": base + i,
                    "live_slots": int(rows[i, 0]),
                    "frontier_pages": int(rows[i, 1]),
                    "pool_occupied_pages": self.pool.occupied_pages,
                    "pool_utilization":
                        self.pool.occupied_pages / max(self.num_pages, 1),
                    "shared_prefix_hits": self.pool.shared_hits,
                })

    def sync(self) -> None:
        """Drain the device-side token history (and the paged stats) into
        the requests with one stacked device->host transfer."""
        pending = self._pending_harvest()
        if pending:
            self._apply_harvest(fetch_harvests([pending])[0])

    def run(self, requests: List[Request],
            max_ticks: int = 10_000) -> List[Request]:
        """Continuous batching: admit whenever a slot frees, tick until all
        requests finish.  Host syncs happen only at admission and harvest
        boundaries."""
        pending = list(requests)
        admitted: List[Request] = []
        while self.tick_count < max_ticks:
            n = 0
            if pending:
                n = self.admit(pending)
                admitted.extend(pending[:n])
                del pending[:n]
            else:
                self.sync()
            active = [r for r in self.slots if r is not None and not r.done]
            if not pending and not active:
                break
            if pending and not active and n == 0:
                # nothing running, nothing admissible: ticking frees nothing
                break
            if pending:
                self.step()
            else:
                bound = max(r.max_new_tokens - len(r.generated)
                            for r in active)
                bound = min(bound, _SYNC_STRIDE, max_ticks - self.tick_count)
                for _ in range(max(1, bound)):
                    self.step()
        self.sync()
        return admitted
