"""Cost-model autotuner for pipeline staging parameters (Eq. 1 driven).

The JAX package's ``core/tuning.py`` on this package's target:

1. **Candidate grids**: :func:`rowwise_candidates`, :func:`gemm_candidates`,
   :func:`attention_candidates` (and the fused and SSD grids) enumerate
   every ``(block, n_buffers)`` point that is legal under the dialect's
   Eq. 1 occupancy algebra (``Dialect.buffer_occupancy``), up to a bounded
   corridor beyond each kernel's static latency cap.
2. **Structural ranking**: fewest grid steps first, then enough resident
   pipeline stages (capped at ``OCCUPANCY_CAP``), deeper buffering
   breaking ties.  :func:`measure_candidates` re-ranks the structural top-k
   by a timer the caller passes in (on the card: CUDA events).
3. **Persistence**: winners live in a per-``(op, mode, dialect,
   shape-bucket)`` JSON table (:data:`DEFAULT_TABLE_PATH`, loaded at
   import as :data:`TUNING_TABLE`).  The cost models consult it through
   :func:`tuned_plan` / :func:`tuned_block` / :func:`tuned_attention_blocks`
   / :func:`tuned_entry`; a missing or illegal entry degrades to the
   heuristic.

The committed table holds the JAX package's 117 entries verbatim (its
``tpu-v5e`` and ``uisa-universal10`` slices, made with the TPU as the
compile target) and a structural ``nvidia-hopper-sm90`` slice made with
Hopper as the target.  A slice's target changes which modes are legal
(``native`` is pinned to the compile target) and, for the reduction and
the histogram, the bucket (:func:`bucket_for` reads the target's wave
width), so the table records each slice's target under ``"targets"`` and
:func:`check_table` holds each slice to its own.  The Hopper kernels size
their own tiles: the table feeds the structural cost models, the chunk of
``ssd_scan(chunk=None)``, and nothing else.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.core.dialect import (DIALECTS, TARGET, Dialect, dtype_bytes,
                                      get_dialect)
from repro_torch.core.pipeline import SUBLANES, plan_row_pipeline

#: resident pipeline stages beyond this hide no additional DMA latency
OCCUPANCY_CAP = 8

#: DMA buffer depths the candidate grids explore
N_BUFFER_CHOICES = (2, 3, 4)

#: how far beyond a kernel's static latency cap the tuner may explore —
#: the cap is a hand-derived tail-latency guard the structural model does
#: not capture, so the corridor is bounded rather than unbounded
CAP_CORRIDOR = 4

DEFAULT_TABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "tuning_table.json")


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (bucket edge for shape binning)."""
    if x <= 1:
        return 1
    return 1 << (x - 1).bit_length()


# ---------------------------------------------------------------------------
# Shape buckets: tuning generalizes across shapes within a pow2 bucket
# ---------------------------------------------------------------------------


def rowwise_bucket(total_rows: int, row_bytes: int) -> str:
    return f"rows{next_pow2(total_rows)}:rb{next_pow2(row_bytes)}"


def gemm_bucket(m: int, n: int, k: int) -> str:
    return f"m{next_pow2(m)}:n{next_pow2(n)}:k{next_pow2(k)}"


def attention_bucket(sq: int, skv: int, d: int) -> str:
    return f"sq{next_pow2(sq)}:skv{next_pow2(skv)}:d{next_pow2(d)}"


def swiglu_bucket(rows: int, d: int, f: int) -> str:
    """rmsnorm_swiglu: row count, feature width, per-projection width."""
    return f"rows{next_pow2(rows)}:d{next_pow2(d)}:f{next_pow2(f)}"


def attention_matmul_bucket(sq: int, skv: int, d: int, n: int) -> str:
    """flash_attention_matmul: the flash shape plus the wo output width."""
    return (f"sq{next_pow2(sq)}:skv{next_pow2(skv)}:d{next_pow2(d)}"
            f":n{next_pow2(n)}")


def ssd_bucket(seq: int, p: int, n: int) -> str:
    """ssd_scan: sequence length plus the head/state widths that size one
    chunk step's working set (batch and head count only scale the grid)."""
    return f"seq{next_pow2(seq)}:p{next_pow2(p)}:n{next_pow2(n)}"


def ssd_decode_bucket(b: int, p: int, n: int) -> str:
    """ssd_decode: serve-batch width plus the head/state widths that size
    one slot's resident [N,P] state (head count only scales the grid)."""
    return f"b{next_pow2(b)}:p{next_pow2(p)}:n{next_pow2(n)}"


def parse_bucket(bucket: str) -> Dict[str, int]:
    """Inverse of the bucket formatters: field name -> representative
    (pow2 upper-edge) value.  The representative shape is what
    :func:`check_table` validates entries against."""
    out: Dict[str, int] = {}
    for part in bucket.split(":"):
        name = part.rstrip("0123456789")
        if not name or name == part:
            raise ValueError(f"malformed bucket field {part!r} in {bucket!r}")
        out[name] = int(part[len(name):])
    return out


# ---------------------------------------------------------------------------
# Candidate grids (legality = the Eq. 1 occupancy algebra)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RowwiseCandidate:
    """One legal staging point for a rowwise (1-D grid) kernel."""

    block_rows: int
    n_buffers: int
    grid_steps: int
    occupancy: int

    def params(self) -> Dict[str, int]:
        return {"block_rows": self.block_rows, "n_buffers": self.n_buffers}


def _rank_key(c: RowwiseCandidate) -> Tuple:
    """Structural cost order: fewest DMA issues, then enough resident
    stages (capped), deeper buffering and larger blocks breaking ties."""
    return (c.grid_steps, -min(c.occupancy, OCCUPANCY_CAP), -c.n_buffers,
            -c.block_rows)


def rowwise_candidates(total_rows: int, row_bytes: int,
                       dialect: Dialect = TARGET, *,
                       max_block_rows: Optional[int] = None,
                       pow2_blocks: bool = False,
                       min_occupancy: int = 2,
                       n_buffer_choices: Sequence[int] = N_BUFFER_CHOICES
                       ) -> List[RowwiseCandidate]:
    """Every legal ``(block_rows, n_buffers)`` point, structurally ranked.

    Block rows walk the power-of-two ladder from ``SUBLANES`` up to the
    rounded problem size, allowed up to ``CAP_CORRIDOR``× beyond the
    kernel's static ``max_block_rows`` cap (the cap is the *untuned*
    heuristic's guard; a validated table entry may supersede it within the
    corridor).  Legality is ``buffer_occupancy >= min_occupancy`` — the
    same Eq. 1 algebra the heuristic planner uses.
    """
    if total_rows <= 0 or row_bytes <= 0:
        raise ValueError("total_rows and row_bytes must be positive")
    rounded_total = -(-total_rows // SUBLANES) * SUBLANES
    cap = rounded_total
    if max_block_rows is not None:
        cap = min(cap, max_block_rows * CAP_CORRIDOR)
    blocks = []
    b = SUBLANES
    while b <= cap:
        blocks.append(b)
        b *= 2
    if not pow2_blocks and blocks and cap != blocks[-1]:
        # the non-pow2 roof block (largest SUBLANES multiple under the cap)
        roof = (cap // SUBLANES) * SUBLANES
        if roof > blocks[-1]:
            blocks.append(roof)
    out = []
    for br in blocks:
        steps = -(-rounded_total // br)
        for nb in n_buffer_choices:
            occ = dialect.buffer_occupancy(br * row_bytes, nb)
            if occ >= min_occupancy:
                out.append(RowwiseCandidate(br, nb, steps, occ))
    if not out:
        # tiny scratchpad budgets: the floor plan is the only choice — the
        # planner documents that the invariant clamps at one SUBLANES block
        out.append(RowwiseCandidate(
            SUBLANES, 2, -(-rounded_total // SUBLANES),
            dialect.buffer_occupancy(SUBLANES * row_bytes, 2)))
    return sorted(out, key=_rank_key)


def gemm_candidates(m: int, n: int, k: int, dialect: Dialect = TARGET,
                    dtype=torch.float32) -> List[Dict]:
    """Legal ``(bm, bn, bk)`` tiles ranked by the tiled-GEMM traffic model.

    Working set of one step = A tile + B tile + f32 accumulator; legality
    keeps a double-buffered occupancy of at least 2 under Eq. 1.  Rank is
    the modeled HBM traffic (A re-read ``ceil(n/bn)`` times, B re-read
    ``ceil(m/bm)`` times), ties broken toward matrix-tile alignment and
    deeper k-tiles (pipeline depth).
    """
    itemsize = dtype_bytes(dtype)
    tile = dialect.matrix_unit.tile[0] if dialect.matrix_unit else 128
    edges = (128, 256, 512, 1024)
    out = []
    for bm in edges:
        for bn in edges:
            for bk in (128, 256, 512):
                working = (bm * bk + bk * bn) * itemsize + bm * bn * 4
                if dialect.buffer_occupancy(working, 2) < 2:
                    continue
                hbm = (m * k * itemsize * -(-n // bn)
                       + k * n * itemsize * -(-m // bm)
                       + m * n * 4)
                aligned = (bm % tile == 0 and bn % tile == 0
                           and bk % tile == 0)
                out.append((hbm, 0 if aligned else 1, -bk,
                            {"block": [bm, bn, bk]}))
    out.sort(key=lambda t: t[:3])
    if not out:
        # tiny scratchpad budgets (uisa-universal10's 48 KB): the minimal
        # MXU-granule tile is the floor plan — the Eq. 1 invariant clamps
        # there rather than leaving the op untunable on the dialect
        return [{"block": [128, 128, 128]}]
    return [params for *_rank, params in out]


def attention_candidates(sq: int, skv: int, d: int,
                         dialect: Dialect = TARGET) -> List[Dict]:
    """Legal ``(block_q, block_kv)`` pairs for the flash kernel.

    Working set of one step = q block + k/v blocks + f32 accumulator +
    the (bq, bkv) score tile; rank prefers fewer grid steps (larger
    blocks), kv depth breaking ties (longer sequential arbitrary axis per
    revisit)."""
    out = []
    for bq in (128, 256, 512):
        for bkv in (128, 256, 512):
            working = (bq * d + 2 * bkv * d + bq * d) * 4 + bq * bkv * 4
            if dialect.buffer_occupancy(working, 2) < 2:
                continue
            steps = -(-sq // bq) * -(-skv // bkv)
            out.append((steps, -bkv, -bq,
                        {"block_q": bq, "block_kv": bkv}))
    out.sort(key=lambda t: t[:3])
    if not out:
        return [{"block_q": 128, "block_kv": 128}]     # Eq. 1 floor plan
    return [params for *_rank, params in out]


def swiglu_candidates(rows: int, d: int, f: int, dialect: Dialect = TARGET,
                      dtype=torch.float32) -> List[Dict]:
    """Legal ``(bm, bn)`` tiles for the fused norm→swiglu lowering.

    One step's working set: the raw x block (full feature row resident —
    the moment needs it), the wi and wg tiles for the same output column
    block, and the hi/hg/out f32 tiles.  Rank is the modeled HBM traffic
    (x re-read per output-column block, both weight halves re-read per
    row block), larger tiles breaking ties."""
    itemsize = dtype_bytes(dtype)
    out = []
    for bm in (128, 256, 512, 1024):
        for bn in (128, 256, 512, 1024):
            working = (bm * d + 2 * d * bn) * itemsize + 3 * bm * bn * 4
            if dialect.buffer_occupancy(working, 2) < 2:
                continue
            hbm = (rows * d * itemsize * -(-f // bn)
                   + 2 * d * f * itemsize * -(-rows // bm)
                   + rows * f * itemsize)
            out.append((hbm, -bn, -bm, {"block": [bm, bn]}))
    out.sort(key=lambda t: t[:3])
    if not out:
        return [{"block": [128, 128]}]                 # Eq. 1 floor plan
    return [params for *_rank, params in out]


def attention_matmul_candidates(sq: int, skv: int, d: int, n: int,
                                dialect: Dialect = TARGET) -> List[Dict]:
    """Legal ``(block_q, block_kv)`` pairs for the fused flash→wo lowering.

    The flash working set plus the epilogue's residents: the head's wo
    slice (d × n) and the shared output block (block_q × n) the heads
    accumulate into.  Rank mirrors :func:`attention_candidates`."""
    out = []
    for bq in (128, 256, 512):
        for bkv in (128, 256, 512):
            working = ((bq * d + 2 * bkv * d + bq * d) * 4 + bq * bkv * 4
                       + (d * n + bq * n) * 4)
            if dialect.buffer_occupancy(working, 2) < 2:
                continue
            steps = -(-sq // bq) * -(-skv // bkv)
            out.append((steps, -bkv, -bq,
                        {"block_q": bq, "block_kv": bkv}))
    out.sort(key=lambda t: t[:3])
    if not out:
        return [{"block_q": 128, "block_kv": 128}]     # Eq. 1 floor plan
    return [params for *_rank, params in out]


def ssd_candidates(seq: int, p: int, n: int, dialect: Dialect = TARGET,
                   dtype=torch.float32) -> List[Dict]:
    """Legal chunk lengths for the fused SSD scan.

    One (batch, head, chunk) step's working set: the x block (Q×P), the
    B/C blocks (2·Q×N), the dt row, the carried [N,P] f32 state, the
    Q×Q score tile, and the y tile.  Rank prefers fewer sequential chunk
    steps (larger chunks), i.e. fewer state-carry iterations, with the
    quadratic Q² tile as the occupancy limiter."""
    itemsize = dtype_bytes(dtype)
    out = []
    for c in (64, 128, 256):
        working = ((c * p + 2 * c * n + c) * itemsize
                   + (n * p + c * c + c * p) * 4)
        if dialect.buffer_occupancy(working, 2) < 2:
            continue
        steps = -(-seq // c)
        out.append((steps, -c, {"chunk": c}))
    out.sort(key=lambda t: t[:2])
    if not out:
        return [{"chunk": 64}]                         # Eq. 1 floor plan
    return [params for *_rank, params in out]


def ssd_decode_candidates(b: int, p: int, n: int, dialect: Dialect = TARGET,
                          dtype=torch.float32) -> List[Dict]:
    """Legal batch tiles for the fused SSD decode recurrence.

    One (batch-tile, head) program's working set: ``block_b`` slots' worth
    of incoming state, updated state, x/y rows, B/C rows and dt scalars,
    plus one [N,P] f32 tree-scratch slab.  Rank prefers fewer grid steps
    along the batch axis (larger tiles), i.e. fewer program launches per
    tick, with the doubled state residency as the occupancy limiter."""
    itemsize = dtype_bytes(dtype)
    del itemsize  # state/intermediates are f32 regardless of storage dtype
    out = []
    for bb in (1, 2, 4, 8):
        working = bb * (2 * n * p + 2 * p + 2 * n + 2) * 4 + n * p * 4
        if dialect.buffer_occupancy(working, 2) < 2:
            continue
        steps = -(-b // bb)
        out.append((steps, -bb, {"block_b": bb}))
    out.sort(key=lambda t: t[:2])
    if not out:
        return [{"block_b": 1}]                        # Eq. 1 floor plan
    return [params for *_rank, params in out]


# ---------------------------------------------------------------------------
# Per-op tuning spaces: kernels register how their parameters are derived,
# so table validation and the autotune CLI share one source of truth.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OpSpace:
    """How one op's tuning candidates are enumerated from a bucket."""

    kind: str                                 # rowwise | gemm | attention
    max_block_rows: Optional[int] = None      # rowwise: static latency cap
    pow2_blocks: bool = False                 # rowwise: tree-reduce granule
    min_occupancy: int = 2


OP_SPACES: Dict[str, OpSpace] = {}


def register_op_space(op: str, kind: str, **kw) -> OpSpace:
    """Kernels call this at import so the tuner knows their constraints."""
    space = OpSpace(kind=kind, **kw)
    OP_SPACES[op] = space
    return space


def candidates_for(op: str, bucket: str,
                   dialect: Dialect = TARGET) -> List[Dict]:
    """The legal candidate params for ``op`` at a bucket's representative
    shape — the grid :func:`check_table` validates entries against."""
    space = OP_SPACES[op]
    rep = parse_bucket(bucket)
    if space.kind == "rowwise":
        cands = rowwise_candidates(
            rep["rows"], rep["rb"], dialect,
            max_block_rows=space.max_block_rows,
            pow2_blocks=space.pow2_blocks,
            min_occupancy=space.min_occupancy)
        return [c.params() for c in cands]
    if space.kind == "gemm":
        return gemm_candidates(rep["m"], rep["n"], rep["k"], dialect)
    if space.kind == "attention":
        return attention_candidates(rep["sq"], rep["skv"], rep["d"], dialect)
    if space.kind == "swiglu":
        return swiglu_candidates(rep["rows"], rep["d"], rep["f"], dialect)
    if space.kind == "attention_matmul":
        return attention_matmul_candidates(rep["sq"], rep["skv"], rep["d"],
                                           rep["n"], dialect)
    if space.kind == "ssd":
        return ssd_candidates(rep["seq"], rep["p"], rep["n"], dialect)
    if space.kind == "ssd_decode":
        return ssd_decode_candidates(rep["b"], rep["p"], rep["n"], dialect)
    raise ValueError(f"unknown tuning space kind {space.kind!r}")


# ---------------------------------------------------------------------------
# The persisted table
# ---------------------------------------------------------------------------


class TuningTable:
    """Per-``(op, mode, dialect, shape-bucket)`` winning parameters, and
    the compile target each dialect's slice was made for (``targets``:
    dialect name -> target name; a slice not listed was made for
    :data:`TARGET`)."""

    def __init__(self, entries: Optional[Dict[str, Dict]] = None,
                 path: Optional[str] = None,
                 targets: Optional[Dict[str, str]] = None):
        self.entries = dict(entries or {})
        self.path = path
        self.targets = dict(targets or {})

    def target_of(self, dialect_name: str) -> Dialect:
        """The compile target ``dialect_name``'s slice was made for."""
        return get_dialect(self.targets.get(dialect_name, TARGET.name))

    @staticmethod
    def key(op: str, mode: str, dialect: str, bucket: str) -> str:
        return f"{op}|{mode}|{dialect}|{bucket}"

    @classmethod
    def load(cls, path: str = DEFAULT_TABLE_PATH) -> "TuningTable":
        if not os.path.exists(path):
            return cls({}, path)
        with open(path) as f:
            data = json.load(f)
        return cls(data.get("entries", {}), path, data.get("targets", {}))

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path or DEFAULT_TABLE_PATH
        data = {"version": 1,
                "entries": {k: self.entries[k]
                            for k in sorted(self.entries)}}
        if self.targets:
            data["targets"] = dict(sorted(self.targets.items()))
        with open(path, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
            f.write("\n")
        return path

    def lookup(self, op: str, mode: str, dialect: str,
               bucket: str) -> Optional[Dict]:
        return self.entries.get(self.key(op, mode, dialect, bucket))

    def record(self, op: str, mode: str, dialect: str, bucket: str,
               params: Mapping, source: str = "structural") -> None:
        entry = dict(params)
        entry["source"] = source
        self.entries[self.key(op, mode, dialect, bucket)] = entry


#: the committed table the cost models consult (loaded once at import)
TUNING_TABLE = TuningTable.load()


# ---------------------------------------------------------------------------
# Kernel-facing consultation API (missing/illegal entries degrade silently)
# ---------------------------------------------------------------------------


def active_dialect(dialect=None) -> Dialect:
    """The dialect whose table slice a lookup should consult.

    Explicit (a :class:`Dialect` or its name: the cost models and the
    registry's ranking pass ``plan_dialect``) wins; otherwise the ambient
    :func:`~repro_torch.core.registry.use_policy` context's dialect, else
    :data:`TARGET`."""
    if dialect is not None:
        return get_dialect(dialect) if isinstance(dialect, str) else dialect
    from repro_torch.core.registry import current_policy
    policy = current_policy()
    return policy.resolved_dialect() if policy is not None else TARGET


def tuned_entry(op: str, mode: str, bucket: str,
                dialect=None,
                table: Optional[TuningTable] = None) -> Optional[Dict]:
    """The raw winning entry for one (op, mode, dialect, bucket), if any."""
    table = TUNING_TABLE if table is None else table
    return table.lookup(op, mode, active_dialect(dialect).name, bucket)


def tuned_plan(op: str, total_rows: int, row_bytes: int, *, mode: str,
               dialect=None,
               table: Optional[TuningTable] = None, **plan_kw):
    """``plan_row_pipeline`` with the table's winner for this bucket.

    The entry's ``block_rows`` / ``n_buffers`` ride in through the plan's
    ``tuned=`` override, which still enforces the occupancy invariant and
    the problem-size clamps — a bad entry degrades to the heuristic."""
    dialect = active_dialect(dialect)
    entry = tuned_entry(op, mode, rowwise_bucket(total_rows, row_bytes),
                        dialect, table)
    return plan_row_pipeline(total_rows, row_bytes, mode=mode,
                             dialect=dialect, tuned=entry, **plan_kw)


def tuned_block(op: str, mode: str, m: int, n: int, k: int,
                dialect=None,
                table: Optional[TuningTable] = None
                ) -> Optional[Tuple[int, int, int]]:
    """The table's ``(bm, bn, bk)`` for a GEMM-shaped op, if recorded."""
    entry = tuned_entry(op, mode, gemm_bucket(m, n, k), dialect, table)
    if entry and "block" in entry:
        bm, bn, bk = entry["block"]
        return int(bm), int(bn), int(bk)
    return None


def tuned_attention_blocks(mode: str, sq: int, skv: int, d: int,
                           dialect=None,
                           table: Optional[TuningTable] = None
                           ) -> Optional[Tuple[int, int]]:
    """The table's ``(block_q, block_kv)`` for the flash kernel, if any."""
    entry = tuned_entry("flash_attention", mode, attention_bucket(sq, skv, d),
                        dialect, table)
    if entry and "block_q" in entry and "block_kv" in entry:
        return int(entry["block_q"]), int(entry["block_kv"])
    return None


# ---------------------------------------------------------------------------
# Autotuning (structural by default; live measurement optional)
# ---------------------------------------------------------------------------


def measure_candidates(build_fn: Callable[[Mapping], Callable],
                       candidates: Sequence[Mapping], *,
                       timer: Callable[[Callable], float],
                       warmup: int = 1, iters: int = 3,
                       top_k: int = 4) -> Tuple[Dict, List[Tuple[float, Dict]]]:
    """Re-rank the structural top-``k`` by measured time.

    ``build_fn(params)`` returns a zero-arg callable that runs the op with
    those staging parameters; ``timer(fn)`` runs it once and returns its
    seconds (the caller's clock: on the card, CUDA events around the
    launch, so the time is the device's).  Returns the winner and the full
    ``(median_s, params)`` ladder."""
    timed = []
    for params in list(candidates)[:top_k]:
        fn = build_fn(params)
        for _ in range(warmup):
            fn()
        samples = sorted(timer(fn) for _ in range(iters))
        timed.append((float(samples[len(samples) // 2]), dict(params)))
    timed.sort(key=lambda t: t[0])
    return timed[0][1], timed


def autotune_entry(table: TuningTable, op: str, mode: str, bucket: str,
                   dialect: Dialect = TARGET,
                   build_fn: Optional[Callable] = None,
                   timer: Optional[Callable[[Callable], float]] = None,
                   **measure_kw) -> Optional[Dict]:
    """Pick and record the winner for one ``(op, mode, dialect, bucket)``.

    Structural ranking decides unless ``build_fn`` is given, in which case
    the structural top-k is re-ranked by ``timer``'s measurements."""
    cands = candidates_for(op, bucket, dialect)
    if not cands:
        return None
    if build_fn is not None:
        if timer is None:
            raise ValueError("a measured re-rank needs a timer")
        winner, _ = measure_candidates(build_fn, cands, timer=timer,
                                       **measure_kw)
        source = "measured"
    else:
        winner, source = cands[0], "structural"
    table.record(op, mode, dialect.name, bucket, winner, source)
    return winner


# ---------------------------------------------------------------------------
# Canonical shapes: the table rows the structural slices hold (the JAX
# package's, which match its benchmark matrix's sizings).
# ---------------------------------------------------------------------------


CANONICAL_SHAPES: Dict[str, List[Dict[str, int]]] = {
    "reduction": [dict(n=1 << 21), dict(n=1 << 15)],
    "rmsnorm": [dict(rows=1024, d=1024), dict(rows=64, d=256)],
    "histogram": [dict(n=1 << 18, num_bins=256),
                  dict(n=1 << 14, num_bins=256)],
    # the third row of the fused/gemm spaces is decode-shaped:
    # rows = the decode batch (decode_32k's 128 slots), sq = 1 against a
    # long cache — the shapes the now decode-legal fusions run per tick
    "add_rmsnorm": [dict(rows=1024, d=1024), dict(rows=64, d=256),
                    dict(rows=128, d=1024)],
    "gemm": [dict(m=1024, n=1024, k=1024), dict(m=256, n=256, k=256),
             dict(m=128, n=1024, k=1024)],
    "flash_attention": [dict(sq=1024, skv=1024, d=64),
                        dict(sq=256, skv=256, d=64)],
    "rmsnorm_swiglu": [dict(rows=1024, d=1024, f=1024),
                       dict(rows=64, d=256, f=256),
                       dict(rows=128, d=1024, f=1024)],
    "flash_attention_matmul": [dict(sq=1024, skv=1024, d=64, n=256),
                               dict(sq=256, skv=256, d=64, n=128),
                               dict(sq=1, skv=1024, d=64, n=256),
                               # paged decode frontiers: skv is
                               # page-granular capacity — small (few live
                               # pages) and large (deep block tables)
                               dict(sq=1, skv=512, d=64, n=256),
                               dict(sq=1, skv=4096, d=64, n=256)],
    # quantized twins: decode-focused — the int8 weight stream
    # matters most at small rows/sq, where weight traffic dominates; the
    # q8 rows tune their own staging (the VMEM working set differs: int8
    # weight tiles + f32 scale rows)
    "rmsnorm_swiglu_q8": [dict(rows=128, d=1024, f=1024),
                          dict(rows=64, d=256, f=256)],
    "flash_attention_matmul_q8": [dict(sq=1, skv=1024, d=64, n=256),
                                  dict(sq=1, skv=512, d=64, n=256)],
    # the fused chunked SSD scan: two seq rows landing in two
    # distinct buckets — the long-prefill shape (mamba2 defaults: P=64,
    # N=128) and a short-sequence shape whose smaller state width admits
    # a different chunk winner; matches the bench matrix's ssd rows
    "ssd_scan": [dict(seq=1024, p=64, n=128), dict(seq=256, p=64, n=64)],
    # the batched decode recurrence: b is the serve-batch width,
    # p/n the mamba2 head/state widths; the two rows match the bench
    # matrix's full and quick ssd_decode sizings
    "ssd_decode": [dict(b=16, p=64, n=128), dict(b=8, p=32, n=32)],
}


def bucket_for(op: str, shape: Dict[str, int],
               target: Dialect = TARGET) -> str:
    """Map an op's natural shape to its tuning-space bucket; the reduction
    and the histogram fold ``n`` into rows of ``target``'s wave width."""
    kind = OP_SPACES[op].kind
    lanes = target.W
    if kind == "rowwise":
        if op in ("reduction", "histogram"):
            rows = -(-shape["n"] // lanes)
            return rowwise_bucket(rows, lanes * 4)
        if op == "rmsnorm":
            return rowwise_bucket(shape["rows"], shape["d"] * 4)
        if op == "add_rmsnorm":
            return rowwise_bucket(shape["rows"], 2 * shape["d"] * 4)
        raise ValueError(f"no bucket rule for rowwise op {op!r}")
    if kind == "gemm":
        return gemm_bucket(shape["m"], shape["n"], shape["k"])
    if kind == "attention":
        return attention_bucket(shape["sq"], shape["skv"], shape["d"])
    if kind == "swiglu":
        return swiglu_bucket(shape["rows"], shape["d"], shape["f"])
    if kind == "attention_matmul":
        return attention_matmul_bucket(shape["sq"], shape["skv"],
                                       shape["d"], shape["n"])
    if kind == "ssd":
        return ssd_bucket(shape["seq"], shape["p"], shape["n"])
    if kind == "ssd_decode":
        return ssd_decode_bucket(shape["b"], shape["p"], shape["n"])
    raise ValueError(kind)


def expected_structural_entries(registry, dialect: Dialect,
                                target: Dialect = TARGET) -> Dict[str, Dict]:
    """The structural winners of ``dialect``'s slice, made for compile
    target ``target``.

    Enumerates every registered tunable op x its non-library modes legal
    on ``dialect`` (``native`` pinned to ``target``) x canonical shapes:
    the slice :func:`check_table` holds the committed table to."""
    expected: Dict[str, Dict] = {}
    for op, shapes in sorted(CANONICAL_SHAPES.items()):
        if op not in registry.ops() or op not in OP_SPACES:
            continue
        for mode in registry.modes(op):
            if mode == "library" or not registry.legal(op, mode, dialect,
                                                       target=target):
                continue          # the plain version / illegal: untuned
            for shape in shapes:
                bucket = bucket_for(op, shape, target)
                cands = candidates_for(op, bucket, dialect)
                if not cands:
                    continue
                key = TuningTable.key(op, mode, dialect.name, bucket)
                expected[key] = cands[0]
    return expected


def record_structural_slice(table: TuningTable, registry, dialect: Dialect,
                            target: Dialect = TARGET) -> int:
    """Write ``dialect``'s structural slice for compile target ``target``
    into ``table`` (its :func:`expected_structural_entries`) and record the
    slice's target; returns the entries written.  The committed Hopper
    slice is ``record_structural_slice(TUNING_TABLE, REGISTRY,
    NVIDIA_HOPPER_SM90)`` followed by ``TUNING_TABLE.save()``, with the
    kernels imported (``repro_torch.kernels.ops``)."""
    expected = expected_structural_entries(registry, dialect, target)
    for key, params in expected.items():
        entry = dict(params)
        entry["source"] = "structural"
        table.entries[key] = entry
    table.targets[dialect.name] = target.name
    return len(expected)


# ---------------------------------------------------------------------------
# CI sync check: committed entries must live inside the candidate grid
# ---------------------------------------------------------------------------


def check_table(registry, table: Optional[TuningTable] = None) -> List[str]:
    """Validate every table entry against the live registry + candidate
    grids.  Returns failure strings (empty = in sync).  Stale ops, modes,
    dialects and params outside the legal grid all fail, and every dialect
    present in the table is held to the full canonical structural slice of
    the target it was made for (``table.target_of``)."""
    table = TUNING_TABLE if table is None else table
    failures = []
    for key, entry in table.entries.items():
        parts = key.split("|")
        if len(parts) != 4:
            failures.append(f"{key}: malformed key")
            continue
        op, mode, dialect_name, bucket = parts
        if op not in registry.ops():
            failures.append(f"{key}: op {op!r} not registered")
            continue
        if mode not in registry.modes(op):
            failures.append(f"{key}: mode {mode!r} not registered for {op}")
            continue
        if dialect_name not in DIALECTS:
            failures.append(f"{key}: unknown dialect {dialect_name!r}")
            continue
        if op not in OP_SPACES:
            failures.append(f"{key}: op has no registered tuning space")
            continue
        try:
            cands = candidates_for(op, bucket, get_dialect(dialect_name))
        except (KeyError, ValueError) as e:
            failures.append(f"{key}: bad bucket ({e})")
            continue
        params = {k: v for k, v in entry.items() if k != "source"}
        if params not in cands:
            failures.append(
                f"{key}: params {params} outside the legal candidate grid "
                f"({len(cands)} candidates)")
    # per-dialect slice sync: each dialect present in the table carries the
    # full canonical structural slice, and structural entries must be the
    # *current* winners (measured entries are exempt from winner equality —
    # they intentionally override the structural ranking).
    present = sorted({parts[2] for parts in
                      (key.split("|") for key in table.entries)
                      if len(parts) == 4 and parts[2] in DIALECTS})
    for dialect_name in present:
        expected = expected_structural_entries(
            registry, get_dialect(dialect_name),
            target=table.target_of(dialect_name))
        for key, winner in expected.items():
            entry = table.entries.get(key)
            if entry is None:
                failures.append(
                    f"{key}: missing from the {dialect_name} slice "
                    f"(stale table: regenerate the slice)")
                continue
            if entry.get("source") != "structural":
                continue
            params = {k: v for k, v in entry.items() if k != "source"}
            if params != winner:
                failures.append(
                    f"{key}: stale structural entry {params} != current "
                    f"winner {winner} (regenerate the slice)")
    return failures
