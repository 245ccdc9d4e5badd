"""The port's CellRouter against the JAX package's, on the CPU, on the
router suite's tiny model (``tests/test_router.py``; parameters from
``PRNGKey(0)``, passed across as numpy): the same scenarios drive both
routers through the same calls, and every observation must be equal -
the tokens of each request, the cell each request landed on, the
least-loaded choice under skewed reservations, failover, fleet-wide
rejection, drain and undrain, prefix affinity on and off, and the
``cell_stats`` rows.  Then the harvest: ``CellRouter.sync`` takes each
cell's pending harvest once and fetches the whole fleet's with one
device->host copy."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import test_router as tr
from repro.models import build_model as ref_build
from repro.models.config import ParallelConfig as RefPar
from repro.serve import BatchedEngine as RefEngine
from repro.serve import CellRouter as RefRouter
from repro.serve import Request as RefRequest
from repro.serve import ServeConfig as RefServe
from repro.serve import make_cells as ref_make_cells

from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig, ParallelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import (BatchedEngine, CellRouter, Request,
                               ServeConfig, make_cells)
from repro_torch.serve import engine as engine_mod

CACHE_LEN = tr.CACHE_LEN
POLICIES = {"plain": dict(), "fused": dict(fuse_epilogues=True,
                                           use_pallas_attn=True)}


@dataclasses.dataclass
class Side:
    """One package's serving API over the tiny model."""
    Engine: type
    Router: type
    Request: type
    Serve: type
    make_cells: object
    model: object
    params: object

    def engine(self, **serve):
        return self.Engine(self.model, self.params, self.Serve(
            max_seq_len=CACHE_LEN, eos_id=-1, **serve))

    def fleet(self, n_cells, prefix_affinity=True, **serve):
        return self.Router([self.engine(**serve) for _ in range(n_cells)],
                           prefix_affinity=prefix_affinity)


@functools.lru_cache(maxsize=None)
def _sides(policy):
    cfg = tr.tiny_model()[1]
    ref = ref_build(cfg, RefPar(remat="none", **POLICIES[policy]))
    ref_params = ref.init_params(tr.KEY)
    port = build_model(ModelConfig(**dataclasses.asdict(cfg)),
                       ParallelConfig(**POLICIES[policy]), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params), "cpu")
    return (Side(RefEngine, RefRouter, RefRequest, RefServe, ref_make_cells,
                 ref, ref_params),
            Side(BatchedEngine, CellRouter, Request, ServeConfig, make_cells,
                 port, params), cfg)


def _prompts(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(2, cfg.vocab_size, 3 + i % 3)]
            for i in range(n)]


def _placements(router):
    """rid -> cell, recorded as each cell admits (a finished request may
    leave its slot to the next one before the run ends)."""
    placed = {}
    for i, cell in enumerate(router.cells):
        def admit(reqs, _i=i, _real=cell.admit):
            n = _real(reqs)
            for r in reqs[:n]:
                if not r.rejected:
                    placed[r.rid] = _i
            return n
        cell.admit = admit
    return placed


def _tokens(done):
    return {r.rid: list(r.generated) for r in done}


# ---- the scenarios: each drives one side and returns what it observed ----


def fleet_tokens(side, cfg, n_cells):
    """6 requests over n cells x 2 slots, paged at 8: admissions spread
    across the fleet mid-stream."""
    router = side.make_cells(side.model, side.params, side.Serve(
        batch_slots=2, max_seq_len=CACHE_LEN, eos_id=-1, page_size=8),
        n_cells)
    placed = _placements(router)
    done = router.run([side.Request(rid=i, prompt=p, max_new_tokens=m)
                       for i, (p, m) in enumerate(zip(
                           _prompts(cfg, 6), [4, 7, 5, 6, 4, 6]))])
    return dict(tokens=_tokens(done), placed=placed,
                rejected=[r.rejected for r in done],
                ticks=router.tick_count)


def dense_fleet_tokens(side, cfg):
    """The dense (non-paged) path: load is free slots."""
    router = side.make_cells(side.model, side.params, side.Serve(
        batch_slots=1, max_seq_len=CACHE_LEN, eos_id=-1), 2)
    placed = _placements(router)
    done = router.run([side.Request(rid=i, prompt=p, max_new_tokens=5)
                       for i, p in enumerate(_prompts(cfg, 4))])
    return dict(tokens=_tokens(done), placed=placed)


def skewed_reservations(side, cfg):
    """Alternating 3-page and 1-page reservations on 2 cells of 8 pages:
    each admission goes to the cell with the most free pages."""
    router = side.fleet(2, batch_slots=4, page_size=8, num_pages=8)
    out = []
    for i, (p, m) in enumerate(zip(_prompts(cfg, 6), [20, 4] * 3)):
        expect = min(range(router.num_cells), key=router._load_key)
        req = side.Request(rid=i, prompt=p[:3], max_new_tokens=m)
        out.append((router.admit([req]), tr._cell_of(router, req), expect,
                    [c.pool.free_pages for c in router.cells]))
    return out


def fleet_admits_more(side, cfg):
    """Three cells splitting one cell's 6-page budget admit all 6 requests,
    one 2-slot cell admits 2."""
    reqs = lambda: [side.Request(rid=i, prompt=p[:3], max_new_tokens=4)
                    for i, p in enumerate(_prompts(cfg, 6))]
    single = side.engine(batch_slots=2, page_size=8, num_pages=6)
    fleet = side.fleet(3, batch_slots=2, page_size=8, num_pages=2)
    return single.admit(reqs()), fleet.admit(reqs())


def fleet_wide_reject(side, cfg):
    """A reservation past every cell's whole pool is rejected; the next
    request is still admitted."""
    router = side.fleet(2, batch_slots=4, page_size=8, num_pages=2)
    giant = side.Request(rid=0, prompt=_prompts(cfg, 1)[0],
                         max_new_tokens=CACHE_LEN)
    after = side.Request(rid=1, prompt=_prompts(cfg, 2)[1][:3],
                         max_new_tokens=4)
    return (router.admit([giant, after]), giant.rejected, giant.done,
            giant.slot, after.rejected, tr._cell_of(router, after))


def failover(side, cfg):
    """The cell with the most free pages has no free slot: admission walks
    on to the next candidate; with both full, a FIFO stop."""
    router = side.Router([side.engine(batch_slots=1, page_size=8,
                                      num_pages=n) for n in (4, 8)])
    out = []
    for i, p in enumerate(_prompts(cfg, 3)):
        req = side.Request(rid=i, prompt=p, max_new_tokens=8)
        out.append((router.admit([req]), tr._cell_of(router, req),
                    req.rejected))
    return out


def drain_and_undrain(side, cfg):
    router = side.fleet(2, batch_slots=4, page_size=8)
    prompts = _prompts(cfg, 3)
    router.drain(0)
    r0, r1 = (side.Request(rid=i, prompt=prompts[i], max_new_tokens=4)
              for i in range(2))
    out = [router.admit([r0, r1]), tr._cell_of(router, r0),
           tr._cell_of(router, r1), sorted(router.drained)]
    router.undrain(0)
    r2 = side.Request(rid=2, prompt=prompts[2], max_new_tokens=4)
    out += [router.admit([r2]), tr._cell_of(router, r2)]
    router.drain(0)
    router.drain(1)
    held = side.Request(rid=3, prompt=prompts[0], max_new_tokens=4)
    out += [router.admit([held]), held.rejected, held.slot,
            [row["drained"] for row in router.cell_stats()]]
    return out


def prefix_affinity(side, cfg, on):
    """Two requests sharing a 2-page prompt prefix (pages of 4): with
    affinity the second follows the pages to the first one's cell, without
    it the second goes to the emptier cell; then both are served."""
    router = side.fleet(2, prefix_affinity=on, batch_slots=2, page_size=4)
    shared = [7, 11, 13, 17, 19, 23, 29, 31]
    ra, rb = (side.Request(rid=i, prompt=shared + [t], max_new_tokens=4)
              for i, t in enumerate((41, 43)))
    out = [router.admit([ra]), tr._cell_of(router, ra), router.admit([rb]),
           tr._cell_of(router, rb),
           [c.pool.shared_hits for c in router.cells]]
    router.run([])
    return out + [ra.generated, rb.generated, router.active_requests()]


def cell_stats(side, cfg):
    router = side.make_cells(side.model, side.params, side.Serve(
        batch_slots=2, max_seq_len=CACHE_LEN, eos_id=-1, page_size=8), 2)
    router.admit([side.Request(rid=0, prompt=_prompts(cfg, 1)[0],
                               max_new_tokens=8)])
    return router.cell_stats()


SCENARIOS = {
    "fleet_tokens_1": functools.partial(fleet_tokens, n_cells=1),
    "fleet_tokens_2": functools.partial(fleet_tokens, n_cells=2),
    "fleet_tokens_3": functools.partial(fleet_tokens, n_cells=3),
    "dense_fleet_tokens": dense_fleet_tokens,
    "skewed_reservations": skewed_reservations,
    "fleet_admits_more": fleet_admits_more,
    "fleet_wide_reject": fleet_wide_reject,
    "failover": failover,
    "drain_and_undrain": drain_and_undrain,
    "prefix_affinity_on": functools.partial(prefix_affinity, on=True),
    "prefix_affinity_off": functools.partial(prefix_affinity, on=False),
    "cell_stats": cell_stats,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(name):
    ref_side, side, cfg = _sides("plain")
    want = SCENARIOS[name](ref_side, cfg)
    got = SCENARIOS[name](side, cfg)
    assert got == want


@pytest.mark.parametrize("name", ["fleet_tokens_2", "prefix_affinity_on"])
def test_scenario_matches_reference_under_the_fused_policy(name):
    ref_side, side, cfg = _sides("fused")
    assert SCENARIOS[name](side, cfg) == SCENARIOS[name](ref_side, cfg)


def test_scenarios_show_what_the_router_promises():
    """The observations the equality holds are not vacuous: the fleet
    places requests on more than one cell, rejects fleet-wide, fails over,
    drains and follows a shared prefix."""
    _, side, cfg = _sides("plain")
    run = SCENARIOS["fleet_tokens_3"](side, cfg)
    assert len(set(run["placed"].values())) == 3
    assert all(len(t) == m for t, m in zip(run["tokens"].values(),
                                           [4, 7, 5, 6, 4, 6]))
    for admitted, cell, expect, _ in SCENARIOS["skewed_reservations"](
            side, cfg):
        assert admitted == 1 and cell == expect
    assert SCENARIOS["fleet_admits_more"](side, cfg) == (2, 6)
    assert SCENARIOS["fleet_wide_reject"](side, cfg) == (
        2, True, True, None, False, 0)
    assert SCENARIOS["failover"](side, cfg) == [(1, 1, False),
                                                (1, 0, False),
                                                (0, None, False)]
    assert SCENARIOS["drain_and_undrain"](side, cfg) == [
        2, 1, 1, [0], 1, 0, 0, False, None, [True, True]]
    on = SCENARIOS["prefix_affinity_on"](side, cfg)
    assert on[1] == on[3] and sorted(on[4]) == [0, 2]
    off = SCENARIOS["prefix_affinity_off"](side, cfg)
    assert off[1] != off[3] and off[4] == [0, 0]


def test_sync_fetches_the_fleet_in_one_transfer(monkeypatch):
    """Ten ticks of two paged cells, then one ``sync``: each cell's
    ``_pending_harvest`` runs once, the fleet's history and stats come to
    the host with one ``.cpu()``, every cell's buffers are drained and its
    10 tick_stats rows written; a second sync transfers nothing."""
    _, side, cfg = _sides("plain")
    router = make_cells(side.model, side.params, ServeConfig(
        batch_slots=2, max_seq_len=CACHE_LEN, eos_id=-1, page_size=8), 2)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=12)
            for i, p in enumerate(_prompts(cfg, 4))]
    assert router.admit(reqs) == 4
    for _ in range(10):
        router.step()
    harvests, copies = [], []
    for i, cell in enumerate(router.cells):
        real = cell._pending_harvest
        monkeypatch.setattr(cell, "_pending_harvest",
                            lambda _i=i, _r=real: harvests.append(_i) or _r())
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **k:
                        copies.append(tuple(t.shape))
                        or real_cpu(t, *a, **k))
    fetches = []
    real_fetch = engine_mod.fetch_harvests
    monkeypatch.setattr("repro_torch.serve.router.fetch_harvests",
                        lambda p: fetches.append(len(p)) or real_fetch(p))
    router.sync()
    assert harvests == [0, 1]
    assert fetches == [2]
    # one flat vector: 2 cells x 10 ticks x (2 slots + 2 stats)
    assert copies == [(2 * 10 * (2 + 2),)]
    for c in router.cells:
        assert c._history == [] and c._stats_history == []
        assert [row["tick"] for row in c.tick_stats] == list(range(10))
        for r in c.slots:
            assert r is not None and len(r.generated) == 11
    router.sync()
    assert harvests == [0, 1, 0, 1] and len(copies) == 1


def test_fetch_harvests_keeps_each_cells_arrays():
    """The fleet's flat copy splits back into each cell's arrays, shapes
    and host entries as they were; an empty harvest stays empty."""
    a = {"hist": torch.arange(6, dtype=torch.int32).reshape(3, 2),
         "stats": torch.tensor([[1, 2]], dtype=torch.int32), "stats_base": 2}
    b = {"hist": torch.tensor([[7, 8, 9]], dtype=torch.int32)}
    got = engine_mod.fetch_harvests([a, {}, b])
    assert got[1] == {} and got[0]["stats_base"] == 2
    for want, have in ((a, got[0]), (b, got[2])):
        for key, t in want.items():
            if isinstance(t, torch.Tensor):
                np.testing.assert_array_equal(have[key], t.numpy())
