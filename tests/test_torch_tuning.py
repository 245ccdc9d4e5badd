"""The port's tuning module against the JAX package's: candidate grids,
buckets, the ``tuned=`` plan override, table lookup and persistence, the
table sync check, the structural and measured autotune, and the committed
table: the JAX package's 117 entries verbatim, each reproduced by the
port's ranking at the JAX package's target, beside a structural Hopper
slice made at the port's."""
import dataclasses
import json
import os
import time

import pytest

from repro.core import REGISTRY as REF_REGISTRY
from repro.core import tuning as ref_tuning
from repro.core import dialect as ref_dialect
from repro.kernels import ops as _ref_ops  # noqa: F401 (registers)
from repro.kernels import ssd as ref_ssd

from repro_torch.core import (DIALECTS, NVIDIA_HOPPER_SM90, REGISTRY, TARGET,
                              TPU_V5E, UISA_UNIVERSAL10, ExecutionPolicy,
                              plan_row_pipeline, tuning, use_policy)
from repro_torch.core.pipeline import SUBLANES
from repro_torch.kernels import ops as _ops  # noqa: F401 (registers)
from repro_torch.kernels import ssd

NAMES = sorted(DIALECTS)
SHARED = sorted(ref_dialect.DIALECTS)
REF_TABLE_PATH = ref_tuning.DEFAULT_TABLE_PATH


def _ref_dialect(name):
    return ref_dialect.DIALECTS.get(name, DIALECTS[name])


def _ref_entries():
    with open(REF_TABLE_PATH) as f:
        return json.load(f)["entries"]


# ---------------------------------------------------------------------------
# Candidate grids and buckets (tests/test_tuning.py's cases)
# ---------------------------------------------------------------------------


class TestCandidates:
    def test_rowwise_candidates_all_legal(self):
        for d in (TPU_V5E, TARGET):
            cands = tuning.rowwise_candidates(4096, 4096, d,
                                              max_block_rows=64)
            assert cands
            for c in cands:
                assert c.block_rows % SUBLANES == 0
                assert d.buffer_occupancy(c.block_rows * 4096,
                                          c.n_buffers) == c.occupancy
                assert c.occupancy >= 2 or c.block_rows == SUBLANES
                assert c.block_rows <= 64 * tuning.CAP_CORRIDOR

    def test_rank_prefers_fewer_steps_then_depth(self):
        cands = tuning.rowwise_candidates(4096, 4096, TPU_V5E,
                                          max_block_rows=64)
        best = cands[0]
        assert best.grid_steps == min(c.grid_steps for c in cands)
        same = [c for c in cands if c.grid_steps == best.grid_steps]
        assert best.n_buffers == max(c.n_buffers for c in same)

    def test_tiny_budget_floor_candidate(self):
        cands = tuning.rowwise_candidates(1024, 4096, UISA_UNIVERSAL10)
        assert cands[-1].block_rows == SUBLANES or \
            all(c.block_rows == SUBLANES for c in cands)

    def test_hopper_grids_fall_to_the_floor(self):
        """227 KB admits no 128-edge GEMM or attention tile at two
        double-buffered stages, nor a 64-chunk scan step of mamba2's
        widths: each grid is its Eq. 1 floor plan."""
        assert tuning.gemm_candidates(1024, 1024, 1024, TARGET) == \
            [{"block": [128, 128, 128]}]
        assert tuning.attention_candidates(1024, 1024, 64, TARGET) == \
            [{"block_q": 128, "block_kv": 128}]
        assert tuning.ssd_candidates(1024, 64, 128, TARGET) == \
            [{"chunk": 64}]


@pytest.mark.parametrize("op", sorted(ref_tuning.CANONICAL_SHAPES))
def test_candidates_equal_reference(op):
    for shape in ref_tuning.CANONICAL_SHAPES[op]:
        bucket = ref_tuning.bucket_for(op, shape)
        for name in NAMES:
            assert tuning.candidates_for(op, bucket, DIALECTS[name]) == \
                ref_tuning.candidates_for(op, bucket, _ref_dialect(name)), \
                (bucket, name)


@pytest.mark.parametrize("op", sorted(ref_tuning.CANONICAL_SHAPES))
def test_buckets_equal_reference_at_its_target(op):
    for shape in ref_tuning.CANONICAL_SHAPES[op]:
        assert tuning.bucket_for(op, shape, TPU_V5E) == \
            ref_tuning.bucket_for(op, shape)
        hopper = tuning.bucket_for(op, shape)
        if op in ("reduction", "histogram"):
            # n folds into rows of Hopper's 32-lane waves
            rows = -(-shape["n"] // 32)
            assert hopper == tuning.rowwise_bucket(rows, 128)
        else:
            assert hopper == ref_tuning.bucket_for(op, shape)


def test_bucket_round_trip():
    assert tuning.parse_bucket(tuning.rowwise_bucket(1000, 3000)) == \
        {"rows": 1024, "rb": 4096}
    assert tuning.parse_bucket(tuning.gemm_bucket(300, 1024, 65)) == \
        {"m": 512, "n": 1024, "k": 128}
    with pytest.raises(ValueError):
        tuning.parse_bucket("rows:nonsense")
    assert tuning.OP_SPACES.keys() == ref_tuning.OP_SPACES.keys()
    for op, space in tuning.OP_SPACES.items():
        assert dataclasses.asdict(space) == \
            dataclasses.asdict(ref_tuning.OP_SPACES[op])


# ---------------------------------------------------------------------------
# The tuned plan override and the consultation API
# ---------------------------------------------------------------------------


class TestTunedPlan:
    def test_tuned_override_applies(self):
        plan = plan_row_pipeline(4096, 4096, mode="native", dialect=TPU_V5E,
                                 max_block_rows=64,
                                 tuned={"block_rows": 256, "n_buffers": 4})
        assert (plan.block_rows, plan.n_buffers) == (256, 4)

    def test_tuned_override_respects_occupancy_invariant(self):
        heur = plan_row_pipeline(4096, 4096, mode="native",
                                 max_block_rows=64)
        plan = plan_row_pipeline(4096, 4096, mode="native",
                                 max_block_rows=64,
                                 tuned={"block_rows": TARGET.S // 4096})
        assert plan.block_rows == heur.block_rows

    def test_tuned_plan_consults_table(self):
        table = tuning.TuningTable({})
        table.record("rmsnorm", "native", TPU_V5E.name,
                     tuning.rowwise_bucket(4096, 4096),
                     {"block_rows": 128, "n_buffers": 3})
        plan = tuning.tuned_plan("rmsnorm", 4096, 4096, mode="native",
                                 dialect=TPU_V5E.name, max_block_rows=64,
                                 table=table)
        assert (plan.block_rows, plan.n_buffers) == (128, 3)
        miss = tuning.tuned_plan("rmsnorm", 4096, 8192, mode="native",
                                 dialect=TPU_V5E.name, max_block_rows=64,
                                 table=table)
        assert miss.block_rows <= 64

    def test_committed_hopper_entries_change_the_plan(self):
        entry = tuning.TUNING_TABLE.lookup(
            "rmsnorm", "abstract", TARGET.name,
            tuning.rowwise_bucket(64, 1024))
        assert entry is not None
        plan = tuning.tuned_plan("rmsnorm", 64, 1024, mode="abstract",
                                 max_block_rows=64)
        assert (plan.block_rows, plan.n_buffers) == \
            (entry["block_rows"], entry["n_buffers"])

    def test_active_dialect_reads_the_ambient_policy(self):
        assert tuning.active_dialect() is TARGET
        assert tuning.active_dialect("amd-rdna3").name == "amd-rdna3"
        with use_policy(ExecutionPolicy(dialect="apple-g13")):
            assert tuning.active_dialect().name == "apple-g13"
            assert tuning.active_dialect(TPU_V5E) is TPU_V5E


def _plan_tuple(p):
    return (p.block_rows, p.n_buffers, p.occupancy, p.grid, p.padded_rows)


@pytest.mark.parametrize("name", SHARED)
def test_consultation_equals_reference(name):
    """The reference slices are the JAX file's, so every lookup of a
    reference dialect returns the JAX package's answer."""
    for mode in ("abstract", "abstract+shuffle", "native"):
        for rows, rb in ((1024, 4096), (64, 1024), (128, 8192), (777, 512)):
            got = tuning.tuned_plan("rmsnorm", rows, rb, mode=mode,
                                    dialect=name, max_block_rows=64)
            ref = ref_tuning.tuned_plan("rmsnorm", rows, rb, mode=mode,
                                        dialect=name, max_block_rows=64)
            assert _plan_tuple(got) == _plan_tuple(ref)
        for m, n, k in ((1024, 1024, 1024), (128, 1024, 1024), (8, 64, 64)):
            assert tuning.tuned_block("gemm", mode, m, n, k, name) == \
                ref_tuning.tuned_block("gemm", mode, m, n, k, name)
        for sq, skv, d in ((1024, 1024, 64), (256, 256, 64), (1, 512, 64)):
            assert tuning.tuned_attention_blocks(mode, sq, skv, d, name) == \
                ref_tuning.tuned_attention_blocks(mode, sq, skv, d, name)


@pytest.mark.parametrize("name", NAMES)
def test_ssd_resolution_equals_reference(name):
    """``chunk=None`` resolves as the JAX package resolves it, for the same
    dialect (Hopper's slice is the port's own: its answer is held to the
    port's grid)."""
    for mode in ("abstract", "abstract+shuffle", "native", "library"):
        for seq, p, n in ((1024, 64, 128), (256, 64, 64), (512, 64, 128),
                          (37, 16, 16), (12, 64, 128)):
            got = ssd.resolve_chunk(seq, None, mode=mode, p=p, n=n,
                                    plan_dialect=name)
            if name in SHARED:
                assert got == ref_ssd.resolve_chunk(mode, seq, p, n, None,
                                                    name)
            else:
                entry = tuning.tuned_entry("ssd_scan", mode,
                                           tuning.ssd_bucket(seq, p, n),
                                           name)
                want = entry["chunk"] if entry else tuning.ssd_candidates(
                    seq, p, n, TARGET)[0]["chunk"]
                assert got == min(want, seq)
            assert ssd.resolve_chunk(seq, 48, mode=mode, p=p, n=n) == \
                min(48, seq)
        for b, p, n in ((16, 64, 128), (8, 32, 32), (3, 64, 128)):
            got = ssd.resolve_decode_block(mode, b, p, n, None, name)
            if name in SHARED:
                assert got == ref_ssd.resolve_decode_block(mode, b, p, n,
                                                           None, name)
            assert 1 <= got <= b
    with pytest.raises(ValueError):
        ssd.resolve_chunk(64, None)             # a tuned chunk needs p, n


# ---------------------------------------------------------------------------
# The committed table
# ---------------------------------------------------------------------------


class TestCommittedTable:
    def test_reference_slices_equal_the_jax_file(self):
        ref = _ref_entries()
        assert len(ref) == 117
        got = {k: v for k, v in tuning.TUNING_TABLE.entries.items()
               if k.split("|")[2] in ("tpu-v5e", "uisa-universal10")}
        assert got == ref

    def test_slice_targets(self):
        table = tuning.TUNING_TABLE
        assert table.target_of("tpu-v5e") is TPU_V5E
        assert table.target_of("uisa-universal10") is TPU_V5E
        assert table.target_of(TARGET.name) is TARGET
        assert {k.split("|")[2] for k in table.entries} == {
            "tpu-v5e", "uisa-universal10", TARGET.name}

    @pytest.mark.parametrize("name", ["tpu-v5e", "uisa-universal10"])
    def test_port_ranking_reproduces_every_reference_entry(self, name):
        """Every JAX entry of the slice is the port's structural winner at
        the JAX package's target, and the port's slice has no entry the
        JAX file lacks."""
        want = {k: {p: v for p, v in e.items() if p != "source"}
                for k, e in _ref_entries().items()
                if k.split("|")[2] == name}
        got = tuning.expected_structural_entries(
            REGISTRY, DIALECTS[name], target=TPU_V5E)
        assert got == want
        ref = ref_tuning.expected_structural_entries(
            REF_REGISTRY, ref_dialect.DIALECTS[name])
        assert got == {k: v for k, v in ref.items() if "_tp|" not in k}

    def test_hopper_slice_is_the_ports_structural_slice(self):
        want = tuning.expected_structural_entries(REGISTRY,
                                                  NVIDIA_HOPPER_SM90)
        got = {k: {p: v for p, v in e.items() if p != "source"}
               for k, e in tuning.TUNING_TABLE.entries.items()
               if k.split("|")[2] == TARGET.name}
        assert got == want and len(got) == 87
        assert all(e["source"] == "structural"
                   for k, e in tuning.TUNING_TABLE.entries.items()
                   if TARGET.name in k)
        # native is legal at Hopper's own slice only
        assert any("|native|" + TARGET.name in k for k in got)

    def test_committed_table_in_sync(self):
        assert tuning.check_table(REGISTRY) == []

    def test_slice_held_to_the_wrong_target_fails(self):
        """The reference slices checked as if made for Hopper: native is
        not legal there, and the reduction's buckets move."""
        table = tuning.TuningTable(dict(tuning.TUNING_TABLE.entries))
        failures = tuning.check_table(REGISTRY, table)
        assert any("tpu-v5e" in f for f in failures)

    def test_record_structural_slice_round_trip(self, tmp_path):
        table = tuning.TuningTable({})
        n = tuning.record_structural_slice(table, REGISTRY, TARGET)
        assert n == 87 and table.targets == {TARGET.name: TARGET.name}
        path = table.save(str(tmp_path / "t.json"))
        loaded = tuning.TuningTable.load(path)
        assert loaded.entries == table.entries
        assert loaded.targets == table.targets
        assert tuning.check_table(REGISTRY, loaded) == []


class TestTableSync:
    def test_stale_op_fails(self):
        table = tuning.TuningTable({
            "no_such_op|native|tpu-v5e|rows64:rb512":
                {"block_rows": 8, "n_buffers": 2, "source": "structural"}})
        assert any("not registered" in f
                   for f in tuning.check_table(REGISTRY, table))

    def test_off_grid_params_fail(self):
        bucket = tuning.rowwise_bucket(1024, 4096)
        table = tuning.TuningTable({
            f"rmsnorm|native|{TARGET.name}|{bucket}":
                {"block_rows": 12345, "n_buffers": 2,
                 "source": "structural"}})
        assert any("outside the legal candidate grid" in f
                   for f in tuning.check_table(REGISTRY, table))

    def test_unknown_dialect_fails(self):
        table = tuning.TuningTable({
            "rmsnorm|native|no-such-dialect|rows64:rb512":
                {"block_rows": 8, "n_buffers": 2, "source": "structural"}})
        assert any("unknown dialect" in f
                   for f in tuning.check_table(REGISTRY, table))

    def test_missing_entry_fails(self):
        table = tuning.TuningTable(dict(tuning.TUNING_TABLE.entries),
                                   targets=tuning.TUNING_TABLE.targets)
        key = next(k for k in table.entries if TARGET.name in k)
        del table.entries[key]
        assert any("missing" in f for f in tuning.check_table(REGISTRY,
                                                               table))


# ---------------------------------------------------------------------------
# Autotune: structural, and re-ranked by a timer passed in
# ---------------------------------------------------------------------------


class TestAutotune:
    def test_structural_winner_recorded(self):
        table = tuning.TuningTable({})
        bucket = tuning.rowwise_bucket(1024, 4096)
        winner = tuning.autotune_entry(table, "rmsnorm", "native", bucket)
        entry = table.lookup("rmsnorm", "native", TARGET.name, bucket)
        assert entry["source"] == "structural"
        assert {k: v for k, v in entry.items() if k != "source"} == winner
        ref = ref_tuning.TuningTable({})
        assert winner == ref_tuning.autotune_entry(ref, "rmsnorm", "native",
                                                   bucket, TARGET)

    def test_measured_rerank_picks_fastest(self):
        calls = []

        def build_fn(params):
            calls.append(dict(params))
            return lambda: params["block_rows"]

        def timer(fn):
            # a fabricated clock: smaller blocks "measure" faster
            return fn() * 1e-5

        table = tuning.TuningTable({})
        bucket = tuning.rowwise_bucket(256, 4096)
        winner = tuning.autotune_entry(
            table, "rmsnorm", "native", bucket, TPU_V5E, build_fn=build_fn,
            timer=timer, iters=1, warmup=0, top_k=3)
        assert len(calls) == 3
        assert winner["block_rows"] == min(c["block_rows"] for c in calls)
        assert table.lookup("rmsnorm", "native", TPU_V5E.name,
                            bucket)["source"] == "measured"
        with pytest.raises(ValueError):
            tuning.autotune_entry(table, "rmsnorm", "native", bucket,
                                  build_fn=build_fn)

    def test_measure_candidates_with_a_wall_clock(self):
        def timer(fn):
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0

        cands = [{"block_rows": 8}, {"block_rows": 16}]
        winner, ladder = tuning.measure_candidates(
            lambda p: (lambda: sum(range(p["block_rows"]))), cands,
            timer=timer, iters=3, warmup=1)
        assert winner in cands and len(ladder) == 2
        assert [t for t, _ in ladder] == sorted(t for t, _ in ladder)

    def test_table_save_load_round_trip(self, tmp_path):
        table = tuning.TuningTable({}, targets={"tpu-v5e": "tpu-v5e"})
        table.record("rmsnorm", "native", TARGET.name, "rows64:rb512",
                     {"block_rows": 16, "n_buffers": 2})
        path = table.save(str(tmp_path / "t.json"))
        loaded = tuning.TuningTable.load(path)
        assert loaded.entries == table.entries
        assert loaded.targets == table.targets
        assert tuning.TuningTable.load(
            os.path.join(str(tmp_path), "absent.json")).entries == {}
