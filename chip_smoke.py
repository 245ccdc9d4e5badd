#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit (``nvidia-smi``);
2. the kernels, built from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, in parallel);
3. each kernel at every granite-8b shape class the main path gives it
   (decode and prefill rows, lm_head, partial tiles), in bf16, held
   against its plain PyTorch version on the same inputs (tolerance: in
   every output row max|err| <= 2e-2 x max|plain row|, and
   ||err|| <= 1e-2 x ||plain||), timed beside its plain version, one
   PyTorch library call computing the same function, and the card's least
   time for the work (bound), the library time the median of
   ``LIBRARY_READINGS`` readings; the prefill rows of rmsnorm_matmul and
   rmsnorm_swiglu (300 and 512 rows) and the causal attention + wo rows
   (granite-8b's and granite-moe's), with bf16 weights and, for
   rmsnorm_matmul_q8, rmsnorm_swiglu_q8 and the causal attention + int8
   wo, int8 weights, take the tensor cores (the "tc" route: a bf16
   prologue, then the wgmma GEMM of csrc/tc_gemm.cuh, which widens an int8
   weight's tiles to bf16 in shared memory), as do phase 11's plain
   flash_attention rows (csrc/attention_tc.cuh's core storing O [B, H, Sq,
   D]); the decode rows (8 slots) of rmsnorm_matmul (qkv, lm_head,
   granite-moe's qkv), rmsnorm_swiglu and their int8 twins take the
   decode GEMV ("gemv": csrc/norm_gemv.cuh, the normalized rows, then the
   weight streamed once into mma.sync, K reduced in a fixed order); the
   ``pos`` and paged shapes of the attention + wo kernels (and their int8
   forms) take their decode route ("decode": csrc/attention_decode.cuh, the
   keys split across blocks, a combine into O, then wo on the decode
   GEMV); the tied f32 table read transposed takes the decode GEMV's
   transposed-table form ("gemv"); every f32 call takes the f32 FMA
   kernels ("fma"); each such row logs the route its call took and fails
   on another; then the int8 twins at the same shapes
   (int8 weights with f32 per-channel scales: qkv at 8, 300 and 512 rows,
   [wi|wg] at 8, 300 and 512 rows, causal attention + int8 wo at 512 and
   300 tokens, the ``pos`` shape + int8 wo, the paged shape over int8 pools
   with f32 per-token scales + int8 wo at pages of 64 and of 128, and
   granite-moe's q8 qkv, causal attention at D 64 and paged shape at pages
   of 128), each library time the PyTorch composition (dequantize, then the
   bf16 calls), and the two float heads the q8 op quantizes per call, each
   on the decode GEMV ("gemv": pass 1 the channel scales, the normalized
   rows, then the weight quantized in registers as it streams; each row's
   launches its head's own, one a prefill and one a tick):
   granite-8b's bf16 lm_head [4096, 49152] read [K, N] and granite-moe's
   tied f32 table [49155, 1536] read transposed, each library time
   ``quantize_weight``, dequantize, then the bf16 calls;
   then, on the same
   inputs as the native rows, the abstract and abstract+shuffle kernels
   of rmsnorm_matmul, rmsnorm_swiglu, flash_attention_matmul (causal and
   ``pos``) and paged_attention_matmul (at pages of 128, beside a native
   row at the same page size), each against the plain version of its mode
   (same tolerances) and timed, with its time as a percentage of the
   native row's;
4. a reference check on a small input: granite-8b-reduced in f32 served by
   the paged engine through the kernels on the card and through the plain
   versions on the CPU, same parameters; tokens must be equal and the
   prefill logits within rtol = atol = 2e-4; the card run logs its
   norm-GEMM and attention + wo launches by route, each norm-GEMM must
   show the decode GEMV and every paged attention + wo launch the decode
   route (its reduced widths meet both routes' predicates);
5. the main path: granite-8b at full width (random weights from seed 0,
   bf16) serving 12 requests (prompts of 128-512 tokens, two sharing a
   full-page prefix, 32 new tokens each) through the paged BatchedEngine on
   8 slots; every kernel of the path must have launched;
6. a dense-cache engine pass (reduced depth) so the per-slot ``pos`` shape
   of flash_attention_matmul launches on the engine's path, and one decode
   tick under ``torch.cuda.set_sync_debug_mode("error")``;
7. the SSD kernels at the mamba2-2.7b shapes (prefill scans of 512, 300
   and 128 tokens, one with an initial state, each on the tensor cores:
   the "tc" route of csrc/ssd_scan_tc.cu, which the row checks, timed as
   the median of ``LIBRARY_READINGS`` readings; the decode recurrence at 8
   and 5 slots, the same way), y and the f32 state each held against the
   plain version (same tolerances);
8. a reference check: mamba2-2.7b-reduced in f32 served through the
   kernels on the card and through the plain versions on the CPU; tokens
   equal, prefill logits within rtol = atol = 1e-3 (the scan carries f32
   state across chunks, so the order of its sums differs); every f32 scan
   on the "fma" route;
9. the mamba main path: mamba2-2.7b at full width and depth (random
   weights from seed 0, bf16) serving 12 requests (128-512 prompt tokens,
   32 new tokens each) through the dense-state BatchedEngine on 8 slots;
   ssd_scan must have launched once per layer per prefill, every launch on
   the "tc" route, and ssd_decode once per layer per tick; then tick
   time, a profile, and one tick under ``set_sync_debug_mode("error")``;
10. the paper's Table V: gemm {abstract, native}, reduction {abstract,
    abstract+shuffle, native} and histogram {abstract, abstract+shuffle,
    native}, each held
    against its plain version of the same mode at the paper's sizes (GEMM
    N = 4096 f32, 2^24 f32 values, 2^24 int32 values into 256 bins, and
    every value in one bin) and at ragged sizes (reduction n = 999,
    70,001 and 2^20 + 3 in every dtype and on a base off 16 bytes, the
    2-per-thread tile's persistent route bit for bit against the plain
    version, twice in a row; histogram with out-of-range values into 100 bins; GEMM 300 x
    129 @ 129 x 200 and 300 x 200 @ 200 x 129), with the tolerances of
    ``repro_torch.benchmarks.tablev`` (reduction: |sum - float64 sum| <=
    1e-5 sum|x|; histogram: exact, counts summing to n; GEMM against the
    float64 product: relative RMS <= 1e-5, in every row max|err| <= 1e-4
    max|row|); then the Table V run itself (every mode through
    ``kernels.ops``, timed), after which every (kernel, mode) must have
    launched, the 2-per-thread rows on the persistent route (their launch
    printed: grid, launches, loads, second pass);
11. the kernels at granite-moe-3b-a800m's shapes, in bf16, against their
    plain versions (the tolerances of phase 3; add_rmsnorm's sum must be
    bit-equal): add_rmsnorm and rmsnorm at 8, 300 and 512 rows of 1536
    (rmsnorm also at a ragged width and at 7 rows; each row held in
    registers, the "vector" route, the ragged width and every mode row the
    "element" route, each timed as the median of ``LIBRARY_READINGS``
    readings, as its library call), flash_attention causal
    at 512 and 300 tokens and non-causal at 300 (24 heads over 8 of 64, the
    tc route), rmsnorm_matmul at the qkv shape and against the tied f32 embedding
    [49155, 1536], flash_attention_matmul at 512 and 300 tokens and
    paged_attention_matmul at head_dim 64 (pages of 64, and of 128), each
    timed like the others; then each of these rows in the abstract and
    abstract+shuffle modes, as phase 3's mode rows (against the mode's
    plain version, timed with native just before it, % of native);
12. a reference check: granite-moe-3b-a800m-reduced in f32 served by the
    paged engine through the kernels on the card and through the plain
    versions on the CPU, once under the fused policy (P1:
    ``ParallelConfig(fuse_epilogues=True, use_pallas_attn=True)``) and once
    under the unfused kernel policy (P2: ``ParallelConfig(
    use_pallas_attn=True, isa_mode="native")``), with one parameter set;
    prompts longer than the 64-token routing group, two sharing full pages;
    tokens equal, prefill logits within rtol = atol = 2e-4; every decode
    launch of rmsnorm_matmul (the tied head too) on the GEMV;
13. granite-moe-3b-a800m at full width and ``MOE_PAGE64_LAYERS`` (8) of its
    32 layers (phase 22 serves it at full depth; random weights from seed
    0, bf16) serving 12 requests (128-512 prompt tokens, two sharing a
    full-page prefix, 32 new tokens each) through the paged engine at
    pages of 64 on 8 slots under P1: every launch count exactly as the
    path prescribes (per prefill and per tick: rmsnorm_matmul one per
    layer and one for the head, add_rmsnorm one per layer;
    flash_attention_matmul one per layer per prefill,
    paged_attention_matmul one per layer per tick; no other kernel), the
    rmsnorm_matmul launches by route exactly (each prefill's qkv on the
    tensor cores, every other one, the tied head's too, on the GEMV), and
    the row norms' (every add_rmsnorm on the "vector" route), then
    tick time, a profile, and one tick under
    ``set_sync_debug_mode("error")``;
14. the same run under P2, with the same parameters: rmsnorm two per
    layer and one for the final norm per prefill and per tick (every one
    on the "vector" route), flash_attention one per layer per prefill, no
    other kernel;
15. a reference check: granite-8b-reduced in f32 under the int8 policy
    (``ParallelConfig(fuse_epilogues=True, use_pallas_attn=True,
    weight_precision="int8", kv_cache_int8=True)`` over
    ``common.quantize_params``) served by the paged engine through the q8
    kernels on the card and through their plain versions on the CPU; tokens
    equal, prefill logits within rtol = atol = 2e-4;
16. granite-8b at full width and depth under the int8 policy (bf16 random
    weights from seed 0, wqkv/wo/wig quantized on the card leaf by leaf),
    the paged engine's pool sized by the bytes of the bf16 engine's
    dense-equivalent pool (both page counts printed), 12 requests (128-512
    prompt tokens, two sharing two pages, 32 new tokens each) on 8 slots:
    every launch count exact (per prefill and per tick: rmsnorm_matmul_q8
    37, the head's bf16 weight quantized per call by the q8 op as in the
    JAX package, inside the decode GEMV, rmsnorm_swiglu_q8 36;
    flash_attention_matmul_q8 36 per prefill, paged_attention_matmul_q8 36
    per tick; no other kernel), rmsnorm_matmul_q8 by route exactly (each
    prefill's qkv on "tc", every head and decode qkv on "gemv"), then tick
    time, a profile, and one tick under ``set_sync_debug_mode("error")``;
17. a 4-layer dense int8 pass (the int8 dense cache, its strip dequantized
    up front): flash_attention_matmul_q8_pos 4 per tick, exact counts, one
    tick with host syncs forbidden;
18. a reference check: granite-8b-reduced in f32 under
    ``ParallelConfig(isa_mode=m, fuse_epilogues=True,
    use_pallas_attn=True)`` for m in {abstract, abstract+shuffle}, served
    by the paged engine at pages of 128 through that mode's kernels on the
    card and through its plain versions on the CPU; tokens equal, prefill
    logits within rtol = atol = 2e-4;
19. granite-8b at full width and depth (random weights from seed 0, bf16,
    drawn once) serving the same 12 requests at pages of 128 under native,
    abstract and abstract+shuffle: every launch count exact, each under its
    mode's counter and none on another mode's (per prefill and per tick:
    rmsnorm_matmul 37, rmsnorm_swiglu 36; flash_attention_matmul 36 per
    prefill, paged_attention_matmul 36 per tick), then tick time, a
    profile, one tick under ``set_sync_debug_mode("error")``, and the share
    of generated tokens equal to native's (reported, not held: a bf16 sum
    order may flip a near tie);
20. the 4-layer dense pass under each of the two modes, for the ``pos``
    shape: exact counts, one tick with host syncs forbidden;
21. a reference check: granite-moe-3b-a800m-reduced in f32 under P1 and
    P2 in each mode m (``ParallelConfig(isa_mode=m, fuse_epilogues=True,
    use_pallas_attn=True)``, ``ParallelConfig(isa_mode=m,
    use_pallas_attn=True)``), served by the paged engine at pages of 128
    through that mode's kernels on the card and through its plain versions
    on the CPU, prompts longer than the 64-token routing group; tokens
    equal, prefill logits within rtol = atol = 2e-4;
22. granite-moe-3b-a800m at full width and depth (random weights from seed
    0, bf16, drawn once) serving the same 12 requests (128-512 prompt
    tokens, two sharing a full page, 32 new tokens each) at pages of 128
    under P1 and P2, each in native, abstract and abstract+shuffle: every
    launch count exact, each under its mode's counter and none on another
    mode's (P1, per prefill and per tick: rmsnorm_matmul 33, add_rmsnorm
    32; flash_attention_matmul 32 per prefill, paged_attention_matmul 32
    per tick; P2: rmsnorm 65 per prefill and per tick, flash_attention 32
    per prefill), the row norms' launches by route exactly (native on
    "vector", the modes on "element"), then tick time, a profile, one tick
    under ``set_sync_debug_mode("error")``, and the share of generated
    tokens equal to native's under the same policy (reported, not held);
23. mamba2-2.7b's kernels under the modes, on phase 7's inputs: ssd_scan
    (L = 512, 300, 128, and 300 with an initial state) and ssd_decode (8
    and 5 slots) in abstract and abstract+shuffle, and rmsnorm at its
    widths, [8, 2560], [512, 2560], [8, 5120] and [512, 5120] in bf16, in
    native, abstract and abstract+shuffle; each row against the plain
    version of its mode (phase 3's tolerances), a mode's row timed with
    native just before it on the same inputs, as a % of native (the scan
    rows on the "tc" route, medians of readings);
24. a reference check: mamba2-2.7b-reduced in f32 under
    ``ParallelConfig(isa_mode=m, fuse_epilogues=True)`` for m in
    {abstract, abstract+shuffle}, served through that mode's kernels on
    the card and through its plain versions on the CPU; tokens equal,
    prefill logits within rtol = atol = 1e-3; every f32 scan on "fma";
25. mamba2-2.7b at full width and depth (random weights from seed 0, bf16,
    drawn once) serving phase 9's 12 requests (128-512 prompt tokens, 32
    new each) through the dense-state engine on 8 slots under native,
    abstract and abstract+shuffle: every launch count exact, each under its
    mode's counter and none on another mode's (ssd_scan 64 per prefill,
    ssd_decode 64 per tick, rmsnorm 129 per prefill and per tick: each
    layer's input norm and gated norm, and the final norm; the norms by
    route exactly, as phase 22's, and every scan on "tc"), then tick time,
    a profile, one tick under ``set_sync_debug_mode("error")``, and the
    shares of generated tokens equal to native's and to phase 9's (the same
    weights, the norms in the library row: what a sum order alone moves;
    reported, not held);
26. the int8 twins under the modes, on phase 3's q8 inputs (rebuilt from
    their seeds): rmsnorm_matmul_q8 (8, 300, 512 rows; granite-moe's qkv),
    rmsnorm_swiglu_q8 (8, 300, 512 rows), flash_attention_matmul_q8
    causal (512 and 300 tokens; 24/8 x 64 at 512), its ``pos`` shape, and
    the paged shape over int8 pools at pages of 128 (D 128 and 64), each in
    abstract and abstract+shuffle against the plain version of its mode
    (phase 3's tolerances), timed with native just before it, as a % of
    native;
27. a reference check under the int8 policy in each mode
    (``ParallelConfig(isa_mode=m, fuse_epilogues=True, use_pallas_attn=True,
    weight_precision="int8", kv_cache_int8=True)`` over
    ``common.quantize_params``): granite-8b-reduced and
    granite-moe-3b-a800m-reduced in f32, paged at 128 with a shared page;
    card tokens equal to CPU tokens, prefill logits within rtol = atol =
    2e-4; each card run logs its norm-GEMM and attention + wo launches by
    route and must show the decode GEMV and the attention's decode route
    (as phase 4; so do phases 12, 15, 18 and 21);
28. granite-8b at full width and depth under the int8 policy (bf16 random
    weights from seed 0, quantized on the card), 12 requests at pages of
    128 in native, abstract and abstract+shuffle, each pool sized by the
    bytes of a bf16 pool at pages of 128 (both page counts printed): every
    launch count exact per (kernel, mode) (rmsnorm_matmul_q8 37 and
    rmsnorm_swiglu_q8 36 per prefill and per tick, flash_attention_matmul_q8
    36 per prefill, paged_attention_matmul_q8 36 per tick), tick, profile,
    a sync-free tick, tokens equal to native's, rmsnorm_matmul_q8 by route
    exactly (as phase 16); then the 4-layer dense int8 pass in each mode
    (flash_attention_matmul_q8_pos 4 per tick);
29. granite-moe-3b-a800m under P1 + int8 at full width and
    ``MOE_PAGE64_LAYERS`` (8) of its 32 layers, at pages of 128 in the three
    modes, the same way (rmsnorm_matmul_q8 9 per prefill and per tick: the
    tied f32 head quantized per call inside the GEMV's transposed form, on
    "gemv"; add_rmsnorm 8; the q8 attention kernels 8 per prefill and per
    tick);
30. the kernels at zamba2-1.2b's shapes, native, bf16, against their plain
    versions (phase 3's tolerances), timed as phase 3's rows: the shared
    block's rmsnorm_matmul (ln1 -> wqkv [2048, 6144]) and rmsnorm_swiglu
    (ln2 -> [wi|wg] [2048, 16384]) at 8 rows ("gemv") and 300 and 512 rows
    ("tc"), causal flash_attention_matmul (32/32 heads x 64, group 1, wo
    [2048, 2048]) and flash_attention at 512 and 300 tokens ("tc"),
    ssd_scan (64 heads x 64, N 64; 512, 300, 128 tokens and 300 from an
    initial state, "tc") and ssd_decode (8 and 5 slots), rmsnorm at 2048
    and 4096 (8 and 512 rows, "vector"); each row's route logged and held;
31. a reference check: zamba2-1.2b-reduced in f32, one parameter set,
    served by the dense engine through the kernels on the card and through
    the plain versions on the CPU, under the fused policy and under
    ``ParallelConfig(use_pallas_attn=True)``; tokens equal, prefill logits
    within rtol = atol = 1e-3; under the fused policy every f32 scan on
    "fma" and every decode norm-GEMM on the GEMV, under
    ``use_pallas_attn`` flash_attention alone launches;
32. zamba2-1.2b at full width and depth (random weights from seed 0, bf16,
    drawn once) serving 12 requests (128-512 prompt tokens, 32 new each)
    through the dense engine on 8 slots under ``ParallelConfig(isa_mode=m,
    fuse_epilogues=True, use_pallas_attn=True)`` for m in native, abstract
    and abstract+shuffle: every launch count exact per (kernel, mode) (per
    prefill ssd_scan 38, rmsnorm 77, and rmsnorm_matmul, rmsnorm_swiglu and
    flash_attention_matmul 6 each, one per application of the shared
    block; per tick ssd_decode 38, rmsnorm 77, rmsnorm_matmul 6 and
    rmsnorm_swiglu 6: the shared block's decode attention and wo are plain
    PyTorch, as in the JAX package), each prefill's norm-GEMMs and
    attention + wo on "tc" and each tick's norm-GEMMs on "gemv", the norms
    and the scans by route as phase 25, then tick time, a profile, one
    tick under ``set_sync_debug_mode("error")``, and the share of tokens
    equal to native's (reported, not held);
33. zamba2-1.2b at full width and depth under ``use_pallas_attn`` alone
    (the norms and the SSD plain): 8 requests, flash_attention 6 per
    prefill on "tc" and no other kernel, one tick with host syncs
    forbidden;
34. the cell router: two paged cells of granite-8b at full width and 4
    layers, 8 slots each: 12 requests (two sharing two pages) give one
    engine's tokens, each request's cell logged (the shared prefix on its
    owner's cell), exact launch counts (both cells tick every router
    tick), one router tick under ``set_sync_debug_mode("error")``, and the
    fleet's harvest one device->host copy.
35. granite-8b under ``ParallelConfig(isa_mode="auto",
    use_pallas_attn=True)`` (``fuse_epilogues`` None: auto fuses) on
    Hopper, at full width and depth, paged at 128, serving phase 9's 12
    requests beside a native run of the fused policy on the same weights:
    before the auto run the script asks ``REGISTRY.select`` for every (op,
    shape) the run makes (each prompt's prefill shapes, the tick's) and
    logs the picks; after it the launches by (kernel, mode) and by route
    equal that prediction exactly, no other lowering launched; tick, busy
    and idle of both runs, one tick under ``set_sync_debug_mode("error")``,
    the share of tokens equal to native's (reported);
36. granite-8b under auto at 4 layers, full width, paged at 128, on a
    foreign dialect: ``isa_dialect="uisa-universal10"`` (every launch the
    abstract kernels: no abstract+shuffle and no native launch), then
    ``"nvidia-ada-sm89"`` (every launch abstract+shuffle, as the picks
    say), counts and routes exact against the host's prediction;
37. mamba2-2.7b under auto at full depth through the dense-state engine
    (phase 25's prompts and weights) beside its native run: the norms, the
    scans and the decode recurrence in the picked mode, counts and routes
    exact against the prediction; then the kernel case
    ``ssd_scan(chunk=None)`` at 512 tokens under auto (the chunk resolved
    from the tuning table or the first candidate, logged with the entry
    that chose it), checked against its plain version at phase 3's
    tolerances and timed; then Table V's structural half
    (``tablev.structural_tables``) is logged, and each measured reduction
    and histogram row carries the modelled scratch round trips a block.

Prints a JSON line of per-kernel numbers (one row per kernel, shape and
mode, or per Table V kernel, mode and case; ``launches`` is the main-path count
of the kernel the shape belongs to, ``max_abs_err`` beside the
row-relative and RMS errors and their tolerances; a kernel with two
outputs reports its worst and each output's errors; a Table V row adds its
launch parameters and its time as a percentage of native), then the card
line, then
``{"ok": true, "device": {...}}`` as the last line.  Imports nothing of JAX
or of the JAX package.
"""
import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS_BF16 = 989e12           # dense tensor-core bf16
L2_FLUSH_BYTES = 128 << 20
TOL_ROW = 2e-2                     # max|err row| / max|plain row|
TOL_RMS = 1e-2                     # ||err|| / ||plain||
#: readings (each a time_ms) whose median is a row's library time: one
#: reading of a library call can stray several times from the rest
LIBRARY_READINGS = 5

PAGE, MAX_LEN, SLOTS, NEW_TOKENS = 64, 576, 8, 32
#: depth of the granite-moe paths at pages of 64 (phases 13-14), cut to keep
#: the run's time; phase 22 serves granite-moe at its full 32 layers
MOE_PAGE64_LAYERS = 8
#: the model-path kernels' other lowerings, and the page size they need
MODES, MODE_PAGE = ("abstract", "abstract+shuffle"), 128
#: the label of mamba2-2.7b's runs under each mode (phase 25)
MAMBA_GROUP = "mamba"
#: the labels of the int8 runs at pages of 128 in each mode: granite-8b at
#: full depth (phase 28) and granite-moe under P1 (phase 29)
INT8_GROUP, MOE_INT8_GROUP = f"granite int8@{MODE_PAGE}", \
    f"moe int8@{MODE_PAGE} P1"


def log(*args):
    print(*args, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, flush=None) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events around
    each call; the L2 cache is flushed between calls, as a decode tick
    finds each layer's weights cold).  The flush reads a buffer larger
    than L2: a flush that wrote it would leave dirty lines, and the timed
    kernel would pay for writing them back.  A short device sleep before
    each call lets the host enqueue the call before the device reaches
    it, so a kernel shorter than its wrapper's host time is timed alone."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        if flush is not None:
            flush.amax()
        torch.cuda._sleep(200_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def library_ms(fn, flush=None) -> float:
    """The median of ``LIBRARY_READINGS`` readings of ``time_ms(fn)``."""
    return statistics.median(time_ms(fn, flush=flush)
                             for _ in range(LIBRARY_READINGS))


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS_BF16 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------------
# phase 3: the kernels at main-path shapes
# --------------------------------------------------------------------------


def kernel_cases(fused, dev, cfg):
    """One dict per (kernel, main-path shape): entry name, the counter of
    the kernel it launches, kernel / plain / library fns, bytes, flops,
    source, replaces.  The shapes are granite-8b's serving shapes and take
    every path the main path takes: the decode GEMV with K split across
    blocks (qkv, [wi|wg]) and with K in two splits (lm_head, N = 49152),
    the qkv prefill on the
    tensor cores at 300 and 512 rows, [wi|wg]'s prefill on the tensor
    cores at 300 and 512 rows (ragged and full row tiles), and the causal
    attention (tensor cores) with full (512) and partial (300) query and
    key tiles; ``route`` names the route each case of a kernel with two
    routes must take."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    bf = torch.bfloat16
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    f, eps, vocab = cfg.d_ff, cfg.norm_eps, cfg.vocab_size
    qkv_n = (h + 2 * hkv) * hd

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    w = rand(d)
    cases = []
    # rmsnorm -> [wq|wk|wv] (decode and prefill rows), final norm -> lm_head
    W_qkv = rand(d, qkv_n, scale=d ** -0.5)
    W_head = rand(d, vocab, scale=d ** -0.5)
    for name, rows, W in (("rmsnorm_matmul", SLOTS, W_qkv),
                          ("rmsnorm_matmul_lm_head", SLOTS, W_head),
                          ("rmsnorm_matmul_prefill300", 300, W_qkv),
                          ("rmsnorm_matmul_prefill512", 512, W_qkv)):
        x, n = rand(rows, d), W.shape[1]
        cases.append(dict(
            name=name, counter="rmsnorm_matmul",
            route="gemv" if rows <= SLOTS else "tc",
            shape=f"x [{rows},{d}] @ W [{d},{n}] bf16",
            kernel=lambda x=x, W=W: fused.rmsnorm_matmul(x, w, W),
            plain=lambda x=x, W=W: fused.rmsnorm_matmul_plain(x, w, W),
            mode_kernel=lambda m, x=x, W=W: fused.rmsnorm_matmul(
                x, w, W, mode=m),
            mode_plain=lambda m, x=x, W=W: fused.rmsnorm_matmul_plain(
                x, w, W, mode=m),
            library=lambda x=x, W=W: F.rms_norm(x, (d,), w, eps) @ W,
            bytes=2 * (rows * d + d + d * n + rows * n),
            flops=2 * rows * d * n,
            source="src/repro_torch/csrc/rmsnorm_matmul.cu",
            replaces="src/repro/kernels/fused.py:296"))
    # rmsnorm -> [wi|wg] swiglu (decode and prefill rows)
    w_cat = rand(d, 2 * f, scale=d ** -0.5)
    for name, rows in (("rmsnorm_swiglu", SLOTS),
                       ("rmsnorm_swiglu_prefill300", 300),
                       ("rmsnorm_swiglu_prefill512", 512)):
        x = rand(rows, d)

        def swiglu_library(x=x):
            hcat = F.rms_norm(x, (d,), w, eps) @ w_cat
            return F.silu(hcat[:, f:]) * hcat[:, :f]
        cases.append(dict(
            name=name, counter="rmsnorm_swiglu",
            route="gemv" if rows <= SLOTS else "tc",
            shape=f"x [{rows},{d}] @ w_cat [{d},{2 * f}] bf16",
            kernel=lambda x=x: fused.rmsnorm_swiglu(x, w, w_cat),
            plain=lambda x=x: fused.rmsnorm_swiglu_plain(x, w, w_cat),
            mode_kernel=lambda m, x=x: fused.rmsnorm_swiglu(x, w, w_cat,
                                                            mode=m),
            mode_plain=lambda m, x=x: fused.rmsnorm_swiglu_plain(
                x, w, w_cat, mode=m),
            library=swiglu_library,
            bytes=2 * (rows * d + d + d * 2 * f + rows * f),
            flops=2 * rows * d * 2 * f,
            source="src/repro_torch/csrc/rmsnorm_swiglu.cu",
            replaces="src/repro/kernels/fused.py:1212"))
    # causal prefill attention + wo (one prompt)
    wo = rand(h * hd, d, scale=(h * hd) ** -0.5)
    for name, sq in (("flash_attention_matmul", 512),
                     ("flash_attention_matmul_prefill300", 300)):
        q, k, v = rand(1, h, sq, hd), rand(1, hkv, sq, hd), rand(1, hkv, sq, hd)

        def causal_library(q=q, k=k, v=v, sq=sq):
            o = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True)
            return o.transpose(1, 2).reshape(1, sq, h * hd) @ wo
        pairs = sq * (sq + 1) // 2
        cases.append(dict(
            name=name, counter="flash_attention_matmul", route="tc",
            shape=f"causal B=1, {h}/{hkv} heads x {hd}, {sq} tokens, "
                  f"wo [{h * hd},{d}] bf16",
            kernel=lambda q=q, k=k, v=v: fused.flash_attention_matmul(
                q, k, v, wo),
            plain=lambda q=q, k=k, v=v: fused.flash_attention_matmul_plain(
                q, k, v, wo),
            mode_kernel=lambda m, q=q, k=k, v=v: fused.flash_attention_matmul(
                q, k, v, wo, mode=m),
            mode_plain=lambda m, q=q, k=k, v=v:
                fused.flash_attention_matmul_plain(q, k, v, wo, mode=m),
            library=causal_library,
            bytes=2 * (q.numel() + k.numel() + v.numel() + wo.numel()
                       + sq * d),
            flops=h * pairs * 4 * hd + 2 * sq * h * hd * d,
            source="src/repro_torch/csrc/flash_attention_matmul.cu",
            replaces="src/repro/kernels/fused.py:702"))
    # dense decode attention + wo, per-slot frontiers
    rng = np.random.default_rng(0)
    pos_np = rng.integers(128, MAX_LEN - NEW_TOKENS, SLOTS).astype(np.int32)
    pos = torch.from_numpy(pos_np).to(dev)
    qd = rand(SLOTS, h, 1, hd)
    kd, vd = rand(SLOTS, hkv, MAX_LEN, hd), rand(SLOTS, hkv, MAX_LEN, hd)
    mask = (torch.arange(MAX_LEN, device=dev)[None] <= pos[:, None]
            )[:, None, None, :]

    def pos_library():
        o = F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                           enable_gqa=True)
        return o.transpose(1, 2).reshape(SLOTS, 1, h * hd) @ wo
    visible = int((pos_np + 1).sum())
    dec_flops = h * visible * 4 * hd + 2 * SLOTS * h * hd * d
    dec_bytes = 2 * (qd.numel() + 2 * hkv * hd * visible + wo.numel()
                     + SLOTS * d) + 4 * SLOTS
    cases.append(dict(
        name="flash_attention_matmul_pos",
        counter="flash_attention_matmul_pos", route="decode",
        shape=f"{SLOTS} slots x {MAX_LEN}-key cache, frontiers "
              f"{int(pos_np.min())}-{int(pos_np.max())} bf16",
        kernel=lambda: fused.flash_attention_matmul(qd, kd, vd, wo, pos=pos),
        plain=lambda: fused.flash_attention_matmul_plain(qd, kd, vd, wo,
                                                         pos=pos),
        mode_kernel=lambda m: fused.flash_attention_matmul(qd, kd, vd, wo,
                                                           pos=pos, mode=m),
        mode_plain=lambda m: fused.flash_attention_matmul_plain(
            qd, kd, vd, wo, pos=pos, mode=m),
        library=pos_library, bytes=dec_bytes, flops=dec_flops,
        source="src/repro_torch/csrc/flash_attention_matmul.cu",
        replaces="src/repro/kernels/fused.py:702"))
    # paged decode attention + wo
    maxp = MAX_LEN // PAGE
    num_pages = SLOTS * maxp
    kp = rand(num_pages, hkv, PAGE, hd)
    vp = rand(num_pages, hkv, PAGE, hd)
    tables = torch.from_numpy(rng.permutation(num_pages).astype(np.int32)
                              .reshape(SLOTS, maxp)).to(dev)
    cases.append(dict(
        name="paged_attention_matmul", counter="paged_attention_matmul",
        route="decode",
        shape=f"{SLOTS} slots, {num_pages} pages of {PAGE}, same frontiers "
              f"bf16",
        kernel=lambda: fused.paged_attention_matmul(
            qd, kp, vp, wo, block_tables=tables, pos=pos),
        plain=lambda: fused.paged_attention_matmul_plain(
            qd, kp, vp, wo, block_tables=tables, pos=pos),
        library=None, bytes=dec_bytes + 4 * SLOTS * maxp, flops=dec_flops,
        source="src/repro_torch/csrc/paged_attention_matmul.cu",
        replaces="src/repro/kernels/fused.py:854"))
    # the same frontiers over pages of 128 keys, the page size the abstract
    # modes need: native here is the yardstick of their rows
    maxp = -(-MAX_LEN // MODE_PAGE)
    num_pages = SLOTS * maxp
    kp = rand(num_pages, hkv, MODE_PAGE, hd)
    vp = rand(num_pages, hkv, MODE_PAGE, hd)
    tables128 = torch.from_numpy(rng.permutation(num_pages).astype(np.int32)
                                 .reshape(SLOTS, maxp)).to(dev)
    cases.append(dict(
        name="paged_attention_matmul_page128",
        counter="paged_attention_matmul", path="granite@128 native",
        route="decode",
        shape=f"{SLOTS} slots, {num_pages} pages of {MODE_PAGE}, same "
              f"frontiers bf16",
        kernel=lambda: fused.paged_attention_matmul(
            qd, kp, vp, wo, block_tables=tables128, pos=pos),
        plain=lambda: fused.paged_attention_matmul_plain(
            qd, kp, vp, wo, block_tables=tables128, pos=pos),
        mode_kernel=lambda m: fused.paged_attention_matmul(
            qd, kp, vp, wo, block_tables=tables128, pos=pos, mode=m),
        mode_plain=lambda m: fused.paged_attention_matmul_plain(
            qd, kp, vp, wo, block_tables=tables128, pos=pos, mode=m),
        library=None, bytes=dec_bytes + 4 * SLOTS * maxp, flops=dec_flops,
        source="src/repro_torch/csrc/paged_attention_matmul.cu",
        replaces="src/repro/kernels/fused.py:854"))
    return cases


def mode_kernel_cases(cases):
    """Each native case that has abstract and abstract+shuffle lowerings,
    once per mode, on the same inputs: the kernel of that mode against the
    plain version of that mode, with the native row's bytes, operations
    (the bound) and library call.  Each row reports its time as a
    percentage of native's (native ms / mode ms, the paper's measure), the
    native kernel timed again on the same inputs just before it."""
    from repro_torch.kernels._launch import count_name
    out = []
    for mode in MODES:
        for case in cases:
            if "mode_kernel" not in case:
                continue
            pos = case["counter"] == "flash_attention_matmul_pos"
            path = case.get("mode_path", "dense" if pos else "granite@128")
            route = ({"route": case["mode_route"]} if "mode_route" in case
                     else {})
            out.append(dict(
                case, name=f"{case['name']}_{mode}", mode=mode,
                counter=count_name(case["counter"], mode),
                native_kernel=case["kernel"], path=f"{path} {mode}",
                kernel=lambda c=case, m=mode: c["mode_kernel"](m),
                plain=lambda c=case, m=mode: c["mode_plain"](m), **route))
    return out


def q8_rand(dev, seed: int):
    """bf16 normal draws from one seeded card generator."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev)
                * scale).to(torch.bfloat16)
    return rand


def q8_qkv_cases(fused, rand, cfg, w, named_rows, mode_path, path=None):
    """ln1 -> wqkv through rmsnorm_matmul_q8 at ``cfg``'s widths: an int8
    [d, qkv] weight with f32 scales, then one bf16 x per (name, rows)."""
    import torch.nn.functional as F
    d, eps = cfg.d_model, cfg.norm_eps
    qkv_n = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.resolved_head_dim
    Wq, Ws = fused.quantize_weight(rand(d, qkv_n, scale=d ** -0.5))
    cases = []
    for name, rows in named_rows:
        x = rand(rows, d)
        cases.append(dict(
            name=name, counter="rmsnorm_matmul_q8", path=path,
            mode_path=mode_path, route="gemv" if rows <= SLOTS else "tc",
            shape=f"x [{rows},{d}] bf16 @ int8 W [{d},{qkv_n}], f32 scales",
            kernel=lambda x=x: fused.rmsnorm_matmul_q8(x, w, Wq, w_scale=Ws,
                                                       eps=eps),
            plain=lambda x=x: fused.rmsnorm_matmul_q8_plain(x, w, Wq, Ws,
                                                            eps=eps),
            mode_kernel=lambda m, x=x: fused.rmsnorm_matmul_q8(
                x, w, Wq, w_scale=Ws, eps=eps, mode=m),
            mode_plain=lambda m, x=x: fused.rmsnorm_matmul_q8_plain(
                x, w, Wq, Ws, eps=eps, mode=m),
            library=lambda x=x: F.rms_norm(x, (d,), w, eps)
            @ fused.dequantize_weight(Wq, Ws, torch.bfloat16),
            library_note="dequantize, then the bf16 composition",
            bytes=2 * (rows * d + d + rows * qkv_n) + d * qkv_n + 4 * qkv_n,
            flops=2 * rows * d * qkv_n,
            source="src/repro_torch/csrc/rmsnorm_matmul.cu",
            replaces="src/repro/kernels/fused.py:1440"))
    return cases


def q8_causal_cases(fused, rand, cfg, woq, wos, named_lens, mode_path,
                    path=None):
    """Causal prefill attention + int8 wo through flash_attention_matmul_q8
    at ``cfg``'s heads: one bf16 q, k, v per (name, tokens)."""
    import torch.nn.functional as F
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    cases = []
    for name, sq in named_lens:
        q, k, v = rand(1, h, sq, hd), rand(1, hkv, sq, hd), rand(1, hkv, sq, hd)

        def causal_library(q=q, k=k, v=v, sq=sq):
            o = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True)
            return o.transpose(1, 2).reshape(1, sq, h * hd) \
                @ fused.dequantize_weight(woq, wos, torch.bfloat16)
        pairs = sq * (sq + 1) // 2
        cases.append(dict(
            name=name, counter="flash_attention_matmul_q8", path=path,
            mode_path=mode_path, route="tc",
            shape=f"causal B=1, {h}/{hkv} heads x {hd}, {sq} tokens bf16, "
                  f"int8 wo [{h * hd},{d}]",
            kernel=lambda q=q, k=k, v=v: fused.flash_attention_matmul_q8(
                q, k, v, woq, w_scale=wos),
            plain=lambda q=q, k=k, v=v:
                fused.flash_attention_matmul_q8_plain(q, k, v, woq, wos),
            mode_kernel=lambda m, q=q, k=k, v=v:
                fused.flash_attention_matmul_q8(q, k, v, woq, w_scale=wos,
                                                mode=m),
            mode_plain=lambda m, q=q, k=k, v=v:
                fused.flash_attention_matmul_q8_plain(q, k, v, woq, wos,
                                                      mode=m),
            library=causal_library,
            library_note="dequantize wo, SDPA, matmul",
            bytes=2 * (q.numel() + k.numel() + v.numel() + sq * d)
            + woq.numel() + 4 * woq.shape[1],
            flops=h * pairs * 4 * hd + 2 * sq * h * hd * d,
            source="src/repro_torch/csrc/flash_attention_matmul.cu",
            replaces="src/repro/kernels/fused.py:1470"))
    return cases


def q8_kernel_cases(fused, quantize_kv, dev, cfg):
    """The int8 twins at granite-8b's serving shapes, in bf16 with int8
    weights (per-channel f32 scales): the qkv decode (the decode GEMV) and
    its prefill at 300 and 512 rows (tensor cores), the [wi|wg] decode
    (the decode GEMV) and its prefill at 300 and 512 rows (tensor cores),
    the causal prefill
    attention + int8 wo (tensor cores) at 512 and 300 tokens,
    the dense ``pos`` shape + int8 wo at 8 slots x 576 keys, and the paged
    shape over int8 pools (f32 per-token scales) + int8 wo at 8 slots, 72
    pages of 64 and 40 pages of 128.  Bytes count int8 weights at 1 byte,
    scales at 4.  The library time is the PyTorch composition: dequantize,
    then the bf16 calls of the f32 rows.  ``mode_kernel`` / ``mode_plain``
    give every case but the pages of 64 its abstract and abstract+shuffle
    rows, counted on the int8 runs at pages of 128 (``mode_path``) and the
    dense int8 passes per mode."""
    import torch.nn.functional as F
    rand = q8_rand(dev, 3)
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    f, eps = cfg.d_ff, cfg.norm_eps
    w = rand(d)
    cases = q8_qkv_cases(fused, rand, cfg, w,
                         (("rmsnorm_matmul_q8", SLOTS),
                          ("rmsnorm_matmul_q8_prefill300", 300),
                          ("rmsnorm_matmul_q8_prefill512", 512)),
                         INT8_GROUP, path="granite int8")
    Wc, Wcs = fused.quantize_weight(rand(d, 2 * f, scale=d ** -0.5))
    for name, rows in (("rmsnorm_swiglu_q8", SLOTS),
                       ("rmsnorm_swiglu_q8_prefill300", 300),
                       ("rmsnorm_swiglu_q8_prefill512", 512)):
        x = rand(rows, d)

        def swiglu_library(x=x):
            hcat = F.rms_norm(x, (d,), w, eps) @ fused.dequantize_weight(
                Wc, Wcs, torch.bfloat16)
            return F.silu(hcat[:, f:]) * hcat[:, :f]
        cases.append(dict(
            name=name, counter="rmsnorm_swiglu_q8", path="granite int8",
            mode_path=INT8_GROUP, route="gemv" if rows <= SLOTS else "tc",
            shape=f"x [{rows},{d}] bf16 @ int8 w_cat [{d},{2 * f}], f32 "
                  f"scales",
            kernel=lambda x=x: fused.rmsnorm_swiglu_q8(x, w, Wc,
                                                       w_scale=Wcs),
            plain=lambda x=x: fused.rmsnorm_swiglu_q8_plain(x, w, Wc, Wcs),
            mode_kernel=lambda m, x=x: fused.rmsnorm_swiglu_q8(
                x, w, Wc, w_scale=Wcs, mode=m),
            mode_plain=lambda m, x=x: fused.rmsnorm_swiglu_q8_plain(
                x, w, Wc, Wcs, mode=m),
            library=swiglu_library,
            library_note="dequantize, then the bf16 composition",
            bytes=2 * (rows * d + d + rows * f) + d * 2 * f + 4 * 2 * f,
            flops=2 * rows * d * 2 * f,
            source="src/repro_torch/csrc/rmsnorm_swiglu.cu",
            replaces="src/repro/kernels/fused.py:1454"))
    woq, wos = fused.quantize_weight(rand(h * hd, d, scale=(h * hd) ** -0.5))
    wo_bytes = woq.numel() + 4 * d
    cases += q8_causal_cases(fused, rand, cfg, woq, wos,
                             (("flash_attention_matmul_q8", 512),
                              ("flash_attention_matmul_q8_prefill300", 300)),
                             INT8_GROUP, path="granite int8")
    rng = np.random.default_rng(4)
    pos_np = rng.integers(128, MAX_LEN - NEW_TOKENS, SLOTS).astype(np.int32)
    pos = torch.from_numpy(pos_np).to(dev)
    qd = rand(SLOTS, h, 1, hd)
    kd, vd = rand(SLOTS, hkv, MAX_LEN, hd), rand(SLOTS, hkv, MAX_LEN, hd)
    mask = (torch.arange(MAX_LEN, device=dev)[None] <= pos[:, None]
            )[:, None, None, :]

    def pos_library():
        o = F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask,
                                           enable_gqa=True)
        return o.transpose(1, 2).reshape(SLOTS, 1, h * hd) \
            @ fused.dequantize_weight(woq, wos, torch.bfloat16)
    visible = int((pos_np + 1).sum())
    dec_flops = h * visible * 4 * hd + 2 * SLOTS * h * hd * d
    cases.append(dict(
        name="flash_attention_matmul_q8_pos",
        counter="flash_attention_matmul_q8_pos", path="dense int8",
        mode_path="dense int8", route="decode",
        shape=f"{SLOTS} slots x {MAX_LEN}-key bf16 cache, frontiers "
              f"{int(pos_np.min())}-{int(pos_np.max())}, int8 wo",
        kernel=lambda: fused.flash_attention_matmul_q8(qd, kd, vd, woq,
                                                       w_scale=wos, pos=pos),
        plain=lambda: fused.flash_attention_matmul_q8_plain(
            qd, kd, vd, woq, wos, pos=pos),
        mode_kernel=lambda m: fused.flash_attention_matmul_q8(
            qd, kd, vd, woq, w_scale=wos, pos=pos, mode=m),
        mode_plain=lambda m: fused.flash_attention_matmul_q8_plain(
            qd, kd, vd, woq, wos, pos=pos, mode=m),
        library=pos_library, library_note="dequantize wo, SDPA, matmul",
        bytes=2 * (qd.numel() + 2 * hkv * hd * visible + SLOTS * d)
        + wo_bytes + 4 * SLOTS,
        flops=dec_flops,
        source="src/repro_torch/csrc/flash_attention_matmul.cu",
        replaces="src/repro/kernels/fused.py:1470"))
    maxp = MAX_LEN // PAGE
    num_pages = SLOTS * maxp
    kp, ksc = quantize_kv(rand(num_pages, hkv, PAGE, hd))
    vp, vsc = quantize_kv(rand(num_pages, hkv, PAGE, hd))
    tables = torch.from_numpy(rng.permutation(num_pages).astype(np.int32)
                              .reshape(SLOTS, maxp)).to(dev)
    cases.append(dict(
        name="paged_attention_matmul_q8", counter="paged_attention_matmul_q8",
        path="granite int8", route="decode",
        shape=f"{SLOTS} slots, {num_pages} int8 pages of {PAGE} (f32 "
              f"per-token scales), same frontiers, int8 wo",
        kernel=lambda: fused.flash_attention_matmul_q8(
            qd, kp, vp, woq, w_scale=wos, k_scale=ksc, v_scale=vsc,
            block_tables=tables, pos=pos),
        plain=lambda: fused.flash_attention_matmul_q8_plain(
            qd, kp, vp, woq, wos, block_tables=tables, pos=pos,
            k_scale=ksc, v_scale=vsc),
        library=None, library_note="no single PyTorch call",
        bytes=2 * (qd.numel() + SLOTS * d) + 2 * hkv * visible * (hd + 4)
        + wo_bytes + 4 * SLOTS * (1 + maxp),
        flops=dec_flops,
        source="src/repro_torch/csrc/paged_attention_matmul.cu",
        replaces="src/repro/kernels/fused.py:854"))
    cases.append(paged_q8_case(fused, quantize_kv, rand, rng, qd, woq, wos,
                               pos, pos_np, cfg,
                               "paged_attention_matmul_q8_page128",
                               INT8_GROUP))
    # drawn last: the rows above keep their inputs
    cases.append(float_head_case(fused, rand(d, cfg.vocab_size,
                                             scale=d ** -0.5),
                                 rand(SLOTS, d), w, eps,
                                 "rmsnorm_matmul_q8_granite_int8_head",
                                 INT8_GROUP, path="granite int8"))
    return cases


def float_head_case(fused, head, x, w, eps, name, group, path=None):
    """A float head the q8 op quantizes per call (``w_scale=None``, as the
    JAX package's rmsnorm_matmul_q8 does): granite-8b's bf16 lm_head read
    [K, N], or granite-moe's tied f32 table given as its transposed view.
    On the decode GEMV in every mode; its launches are the head's own on
    ``group``'s runs (one a prefill, one a tick).  Bytes: the float head
    read once; the library time ``quantize_weight``, dequantize, then the
    bf16 calls."""
    import torch.nn.functional as F
    d, n = head.shape
    table = not head.is_contiguous()
    what = (f"tied table [{n},{d}] f32 read transposed" if table
            else f"W [{d},{n}] {str(head.dtype).split('.')[-1]}")

    def library():
        wq, ws = fused.quantize_weight(head)
        return F.rms_norm(x, (d,), w, eps) @ fused.dequantize_weight(
            wq, ws, torch.bfloat16)
    return dict(
        name=name, counter="rmsnorm_matmul_q8", head=True, path=path,
        mode_path=group, route="gemv",
        shape=f"x [{x.shape[0]},{d}] bf16 @ {what}, quantized per call in "
              f"the GEMV's stream",
        kernel=lambda: fused.rmsnorm_matmul_q8(x, w, head, eps=eps),
        plain=lambda: fused.rmsnorm_matmul_q8_plain(
            x, w, *fused.quantize_weight(head), eps=eps),
        mode_kernel=lambda m: fused.rmsnorm_matmul_q8(x, w, head, eps=eps,
                                                      mode=m),
        mode_plain=lambda m: fused.rmsnorm_matmul_q8_plain(
            x, w, *fused.quantize_weight(head), eps=eps, mode=m),
        library=library,
        library_note="quantize, dequantize, then the bf16 composition",
        bytes=2 * (x.numel() + d + x.shape[0] * n)
        + head.element_size() * d * n,
        flops=2 * x.shape[0] * d * n,
        source="src/repro_torch/csrc/rmsnorm_matmul.cu",
        replaces="src/repro/kernels/fused.py:1440")


def paged_q8_case(fused, quantize_kv, rand, rng, qd, woq, wos, pos, pos_np,
                  cfg, name, group):
    """The paged q8 shape over int8 pools at pages of 128 keys (the page
    size the modes need; native here is the yardstick of their rows),
    counted on ``group``'s runs."""
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    maxp = -(-MAX_LEN // MODE_PAGE)
    num_pages = SLOTS * maxp
    kp, ksc = quantize_kv(rand(num_pages, hkv, MODE_PAGE, hd))
    vp, vsc = quantize_kv(rand(num_pages, hkv, MODE_PAGE, hd))
    tables = torch.from_numpy(rng.permutation(num_pages).astype(np.int32)
                              .reshape(SLOTS, maxp)).to(qd.device)
    visible = int((pos_np + 1).sum())
    kw = dict(w_scale=wos, k_scale=ksc, v_scale=vsc, block_tables=tables,
              pos=pos)
    return dict(
        name=name, counter="paged_attention_matmul_q8", mode_path=group,
        route="decode",
        shape=f"{SLOTS} slots, {num_pages} int8 pages of {MODE_PAGE} (f32 "
              f"per-token scales), {h}/{hkv} heads x {hd}, frontiers "
              f"{int(pos_np.min())}-{int(pos_np.max())}, int8 wo",
        kernel=lambda: fused.flash_attention_matmul_q8(qd, kp, vp, woq, **kw),
        plain=lambda: fused.flash_attention_matmul_q8_plain(
            qd, kp, vp, woq, **kw),
        mode_kernel=lambda m: fused.flash_attention_matmul_q8(
            qd, kp, vp, woq, mode=m, **kw),
        mode_plain=lambda m: fused.flash_attention_matmul_q8_plain(
            qd, kp, vp, woq, mode=m, **kw),
        library=None, library_note="no single PyTorch call",
        bytes=2 * (qd.numel() + SLOTS * d) + 2 * hkv * visible * (hd + 4)
        + woq.numel() + 4 * woq.shape[1] + 4 * SLOTS * (1 + maxp),
        flops=h * visible * 4 * hd + 2 * SLOTS * h * hd * d,
        source="src/repro_torch/csrc/paged_attention_matmul.cu",
        replaces="src/repro/kernels/fused.py:854")


def moe_q8_cases(fused, quantize_kv, dev, cfg):
    """The int8 twins at granite-moe-3b-a800m's shapes under P1 + int8,
    through granite-8b's case functions: qkv [8,1536] @ int8 [1536,2560]
    (the decode GEMV), the tied head (the f32 [49155, 1536] table quantized
    per call inside the decode GEMV's transposed form, as the path does),
    causal attention 24/8 heads x 64 + int8 wo [1536,1536] at 512
    tokens (group 3 at D 64), and the paged decode shape at D 64 over int8
    pages of 128; counted on the granite-moe int8 runs
    (``MOE_INT8_GROUP``)."""
    rand = q8_rand(dev, 4)
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.resolved_head_dim
    eps, vocab = cfg.norm_eps, cfg.vocab_size
    w = 1.0 + rand(d, scale=0.1)
    cases = q8_qkv_cases(fused, rand, cfg, w,
                         (("rmsnorm_matmul_q8_moe_qkv", SLOTS),),
                         MOE_INT8_GROUP)
    woq, wos = fused.quantize_weight(rand(h * hd, d, scale=(h * hd) ** -0.5))
    cases += q8_causal_cases(fused, rand, cfg, woq, wos,
                             (("flash_attention_matmul_q8_moe512", 512),),
                             MOE_INT8_GROUP)
    rng = np.random.default_rng(5)
    pos_np = rng.integers(128, MAX_LEN - NEW_TOKENS, SLOTS).astype(np.int32)
    pos = torch.from_numpy(pos_np).to(dev)
    cases.append(paged_q8_case(fused, quantize_kv, rand, rng,
                               rand(SLOTS, h, 1, hd), woq, wos, pos, pos_np,
                               cfg, "paged_attention_matmul_q8_moe_page128",
                               MOE_INT8_GROUP))
    # drawn last: the rows above keep their inputs
    table = rand(vocab, d, scale=0.02).float()
    cases.append(float_head_case(fused, table.t(), rand(SLOTS, d), w, eps,
                                 "rmsnorm_matmul_q8_moe_tied_head",
                                 MOE_INT8_GROUP))
    return cases


def ssd_kernel_cases(ssd, dev, cfg, suffix="", path="mamba"):
    """The SSD kernels at mamba2-2.7b's serving shapes (at zamba2-1.2b's
    with ``cfg`` its config, each name ending in ``suffix``, counted on
    ``path``'s run): the prefill scan
    over one prompt of 512 tokens (two full chunks of 256), 300 tokens (a
    partial last chunk), 128 tokens (one chunk, clamped to the prompt) and
    300 tokens seeded from a nonzero initial state, each on the tensor
    cores (the "tc" route, median of readings; ``operands`` holds x, dt,
    A, B, C, h0 for scripts/ssd_scan_variants.py); the decode recurrence
    at 8 slots and at an odd 5 (``operands``: state, x, dt, A, B, C for
    scripts/ssd_decode_variants.py).  Inputs have the model's magnitudes: dt =
    softplus(. + dt_bias) with the model's dt_bias, A = -linspace(1, 16),
    B and C scaled so that C.B is O(1).  Each kernel has two outputs, y
    and the f32 state, both compared.  No single PyTorch call computes
    either function, so library_ms is null.  ``mode_kernel`` /
    ``mode_plain`` give each case its abstract and abstract+shuffle rows
    (phase 23), counted on phase 25's run in that mode."""
    s = cfg.ssm
    h = s.expand * cfg.d_model // s.head_dim
    p, n, g, q = s.head_dim, s.state_dim, s.n_groups, s.chunk_size
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    bf = torch.bfloat16
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    dt_bias = torch.log(torch.expm1(torch.linspace(s.dt_min, s.dt_max, h,
                                                   device=dev)))

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def dts(*lead):
        return torch.nn.functional.softplus(rand(*lead, h) + dt_bias)

    itemsize = 2
    no_library = "no single PyTorch call computes this function"
    cases = []
    for name, l, init in (("ssd_scan", 512, False),
                          ("ssd_scan_prefill300", 300, False),
                          ("ssd_scan_prefill128", 128, False),
                          ("ssd_scan_h0", 300, True)):
        x = rand(1, l, h, p).to(bf)
        dt = dts(1, l)
        B = rand(1, l, g, n, scale=n ** -0.25).to(bf)
        C = rand(1, l, g, n, scale=n ** -0.25).to(bf)
        h0 = rand(1, g, h // g, n, p, scale=0.5) if init else None
        qq = min(q, l)
        flops = 0
        for c0 in range(0, l, qq):
            m = min(qq, l - c0)
            pairs = m * (m + 1) // 2
            # C.B^T once per group, decay-weighted w.x and the state update
            # per head, and the carried state's C.h where it is not zero;
            # the tc route runs w.x, the update and C.h as two products
            # each (an f32 operand split into bf16 hi + lo)
            flops += 2 * g * pairs * n + 2 * (2 * h * pairs * p) \
                + 2 * (2 * h * m * n * p) * (2 if (c0 > 0 or init) else 1)
        nbytes = (itemsize * (2 * l * h * p + 2 * l * g * n)
                  + 4 * (l * h + h + h * n * p * (2 if init else 1)))
        cases.append(dict(
            name=name + suffix, counter="ssd_scan", outputs=("y", "state"),
            route="tc", mode_route="tc", median=True,
            operands=(x, dt, A, B, C, h0),
            shape=f"B=1, L={l}, {h} heads x {p}, N={n}, G={g}, chunk {qq}"
                  f"{', initial state' if init else ''}, bf16 (state f32)",
            kernel=lambda x=x, dt=dt, B=B, C=C, h0=h0: ssd.ssd_scan(
                x, dt, A, B, C, h0, chunk=q),
            plain=lambda x=x, dt=dt, B=B, C=C, h0=h0: ssd.ssd_scan_plain(
                x, dt, A, B, C, h0, chunk=q),
            mode_kernel=lambda m, x=x, dt=dt, B=B, C=C, h0=h0: ssd.ssd_scan(
                x, dt, A, B, C, h0, chunk=q, mode=m),
            mode_plain=lambda m, x=x, dt=dt, B=B, C=C, h0=h0:
                ssd.ssd_scan_plain(x, dt, A, B, C, h0, chunk=q, mode=m),
            path=path, mode_path=MAMBA_GROUP,
            library=None, library_note=no_library, bytes=nbytes,
            flops=flops, source="src/repro_torch/csrc/ssd_scan_tc.cu",
            replaces="src/repro/kernels/ssd.py:289"))
    for name, b in (("ssd_decode", SLOTS), ("ssd_decode_b5", 5)):
        state = rand(b, g, h // g, n, p, scale=0.5)
        x = rand(b, h, p).to(bf)
        dt = dts(b)
        B = rand(b, g, n, scale=n ** -0.25).to(bf)
        C = rand(b, g, n, scale=n ** -0.25).to(bf)
        cases.append(dict(
            name=name + suffix, counter="ssd_decode", outputs=("state", "y"),
            operands=(state, x, dt, A, B, C), median=True,
            shape=f"{b} slots x {h} heads, state [{n},{p}] f32, bf16",
            kernel=lambda state=state, x=x, dt=dt, B=B, C=C: ssd.ssd_decode(
                state, x, dt, A, B, C),
            plain=lambda state=state, x=x, dt=dt, B=B, C=C:
                ssd.ssd_decode_plain(state, x, dt, A, B, C),
            mode_kernel=lambda m, state=state, x=x, dt=dt, B=B, C=C:
                ssd.ssd_decode(state, x, dt, A, B, C, mode=m),
            mode_plain=lambda m, state=state, x=x, dt=dt, B=B, C=C:
                ssd.ssd_decode_plain(state, x, dt, A, B, C, mode=m),
            path=path, mode_path=MAMBA_GROUP,
            library=None, library_note=no_library,
            bytes=4 * 2 * b * h * n * p + itemsize * (2 * b * h * p
                                                      + 2 * b * g * n)
            + 4 * (b * h + h),
            flops=5 * b * h * n * p,
            source="src/repro_torch/csrc/ssd_decode.cu",
            replaces="src/repro/kernels/ssd.py:437"))
    return cases


def mamba_norm_cases(rmsnorm, dev, cfg, tag="mamba", path=None):
    """rmsnorm at mamba2-2.7b's two widths (at zamba2-1.2b's with ``cfg``
    its config, ``tag`` in each name, counted on ``path``'s run), d_model
    (each layer's input norm, the final norm) and d_inner (the gated norm),
    at a decode tick (8 rows) and a 512-token prefill, in bf16, native;
    ``mode_kernel`` / ``mode_plain`` give each its abstract and
    abstract+shuffle rows.  Under ``isa_mode=m`` the mamba path runs every
    norm through this kernel in mode m, so each row counts on phase 25's
    run in its mode."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    bf, eps = torch.bfloat16, cfg.norm_eps
    cases = []
    for d in (cfg.d_model, cfg.ssm.expand * cfg.d_model):
        w = (1.0 + torch.randn(d, generator=g, device=dev) * 0.1).to(bf)
        for rows in (SLOTS, 512):
            x = torch.randn(rows, d, generator=g, device=dev).to(bf)
            sfx = "" if rows == SLOTS else f"_prefill{rows}"
            cases.append(dict(
                name=f"rmsnorm_{tag}_d{d}{sfx}", counter="rmsnorm",
                mode_path=MAMBA_GROUP, path=path,
                shape=f"x [{rows},{d}] bf16",
                kernel=lambda x=x, w=w: rmsnorm.rmsnorm(x, w, eps=eps),
                plain=lambda x=x, w=w: rmsnorm.rmsnorm_plain(x, w, eps=eps),
                mode_kernel=lambda m, x=x, w=w: rmsnorm.rmsnorm(
                    x, w, eps=eps, mode=m),
                mode_plain=lambda m, x=x, w=w: rmsnorm.rmsnorm_plain(
                    x, w, eps=eps, mode=m),
                library=lambda x=x, w=w, d=d: F.rms_norm(x, (d,), w, eps),
                route="vector", mode_route="element", median=True,
                bytes=2 * (2 * rows * d + d), flops=4 * rows * d,
                source="src/repro_torch/csrc/rmsnorm.cu",
                replaces="src/repro/kernels/rmsnorm.py:105"))
    return cases


MOE_POLICIES = {"P1": dict(fuse_epilogues=True, use_pallas_attn=True),
                "P2": dict(use_pallas_attn=True, isa_mode="native")}


def moe_kernel_cases(fused, rmsnorm, attention, dev, cfg):
    """The kernels at granite-moe-3b-a800m's serving shapes: the row norms
    at a decode tick (8 rows) and a prefill (300, 512 rows) of d_model
    1536, rmsnorm also at a width off the 16-byte vector (scalar loads)
    and at 7 rows (a block's last warp without a row); plain flash
    attention on the tensor cores, causal over one 512- and one 300-token
    prompt and non-causal over 300 keys (a partial last key tile), 24 query
    heads over 8 kv heads of 64 (GQA group 3, 21 queries x 3 heads per
    block);
    rmsnorm_matmul at the qkv shape (the decode GEMV) and against the tied
    f32 embedding read as its transposed view (odd N, the GEMV's
    transposed-table form); the
    attention + wo kernels at head_dim
    64, paged at 64 and at 128 keys a page.  ``path`` names the run whose
    launch counts the row reports; ``mode_kernel`` / ``mode_plain`` give a
    case its abstract and abstract+shuffle rows (mode_kernel_cases), whose
    counts come from ``mode_path``'s run under that mode."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    bf = torch.bfloat16
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    eps, vocab = cfg.norm_eps, cfg.vocab_size
    qkv_n = (h + 2 * hkv) * hd

    def rand(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    w = 1.0 + rand(d, scale=0.1)
    cases = []
    for rows in (SLOTS, 300, 512):
        x, r = rand(rows, d), rand(rows, d, scale=0.5)
        sfx = "" if rows == SLOTS else f"_prefill{rows}"

        def add_library(x=x, r=r):
            return F.rms_norm(x + r, (d,), w, eps)
        cases.append(dict(
            name="add_rmsnorm" + sfx, counter="add_rmsnorm", path="moe P1",
            mode_path="moe@128 P1",
            outputs=("normed", "sum"), exact=("sum",),
            shape=f"x, r [{rows},{d}] bf16",
            kernel=lambda x=x, r=r: fused.add_rmsnorm(x, r, w, eps=eps),
            plain=lambda x=x, r=r: fused.add_rmsnorm_plain(x, r, w, eps=eps),
            mode_kernel=lambda m, x=x, r=r: fused.add_rmsnorm(
                x, r, w, eps=eps, mode=m),
            mode_plain=lambda m, x=x, r=r: fused.add_rmsnorm_plain(
                x, r, w, eps=eps, mode=m),
            library=add_library,
            library_note="two calls: x + r, then F.rms_norm",
            route="vector", mode_route="element", median=True,
            bytes=2 * (4 * rows * d + d), flops=5 * rows * d,
            source="src/repro_torch/csrc/add_rmsnorm.cu",
            replaces="src/repro/kernels/fused.py:486"))
    for rows, dd in ((SLOTS, d), (300, d), (512, d), (300, d + 3), (7, d)):
        x, wr = rand(rows, dd), 1.0 + rand(dd, scale=0.1)
        sfx = ("_ragged_d" if dd != d else "" if rows == SLOTS
               else f"_rows{rows}" if rows < SLOTS else f"_prefill{rows}")
        cases.append(dict(
            name="rmsnorm" + sfx, counter="rmsnorm", path="moe P2",
            mode_path="moe@128 P2", shape=f"x [{rows},{dd}] bf16",
            kernel=lambda x=x, wr=wr: rmsnorm.rmsnorm(x, wr, eps=eps),
            plain=lambda x=x, wr=wr: rmsnorm.rmsnorm_plain(x, wr, eps=eps),
            mode_kernel=lambda m, x=x, wr=wr: rmsnorm.rmsnorm(
                x, wr, eps=eps, mode=m),
            mode_plain=lambda m, x=x, wr=wr: rmsnorm.rmsnorm_plain(
                x, wr, eps=eps, mode=m),
            library=lambda x=x, wr=wr, dd=dd: F.rms_norm(x, (dd,), wr, eps),
            route="vector" if dd % 8 == 0 else "element",
            mode_route="element", median=True,
            bytes=2 * (2 * rows * dd + dd), flops=4 * rows * dd,
            source="src/repro_torch/csrc/rmsnorm.cu",
            replaces="src/repro/kernels/rmsnorm.py:105"))
    for name, sq, causal in (("flash_attention", 512, True),
                             ("flash_attention_prefill300", 300, True),
                             ("flash_attention_noncausal300", 300, False)):
        q, k, v = rand(1, h, sq, hd), rand(1, hkv, sq, hd), rand(1, hkv, sq, hd)
        pairs = sq * (sq + 1) // 2 if causal else sq * sq
        cases.append(dict(
            name=name, counter="flash_attention", path="moe P2",
            mode_path="moe@128 P2", route="tc",
            shape=f"{'causal' if causal else 'non-causal'} B=1, {h}/{hkv} "
                  f"heads x {hd}, {sq} tokens bf16",
            kernel=lambda q=q, k=k, v=v, c=causal: attention.flash_attention(
                q, k, v, causal=c),
            plain=lambda q=q, k=k, v=v, c=causal:
                attention.flash_attention_plain(q, k, v, causal=c),
            mode_kernel=lambda m, q=q, k=k, v=v, c=causal:
                attention.flash_attention(q, k, v, causal=c, mode=m),
            mode_plain=lambda m, q=q, k=k, v=v, c=causal:
                attention.flash_attention_plain(q, k, v, causal=c, mode=m),
            library=lambda q=q, k=k, v=v, c=causal:
                F.scaled_dot_product_attention(q, k, v, is_causal=c,
                                               enable_gqa=True),
            bytes=2 * (2 * q.numel() + k.numel() + v.numel()),
            flops=h * pairs * 4 * hd,
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/attention.py:222"))
    W_qkv = rand(d, qkv_n, scale=d ** -0.5)
    table = rand(vocab, d, scale=0.02, dtype=torch.float32)
    for name, W, n, wbytes, route in (
            ("rmsnorm_matmul_moe_qkv", W_qkv, qkv_n, 2, "gemv"),
            ("rmsnorm_matmul_tied_head", table.t(), vocab, 4, "gemv")):
        x = rand(SLOTS, d)
        cases.append(dict(
            name=name, counter="rmsnorm_matmul", path="moe P1",
            mode_path="moe@128 P1", route=route,
            shape=(f"x [{SLOTS},{d}] @ W [{d},{n}] bf16" if wbytes == 2 else
                   f"x [{SLOTS},{d}] bf16 @ tied table [{n},{d}] f32, "
                   f"transposed read"),
            kernel=lambda x=x, W=W: fused.rmsnorm_matmul(x, w, W, eps=eps),
            plain=lambda x=x, W=W: fused.rmsnorm_matmul_plain(x, w, W,
                                                              eps=eps),
            mode_kernel=lambda m, x=x, W=W: fused.rmsnorm_matmul(
                x, w, W, eps=eps, mode=m),
            mode_plain=lambda m, x=x, W=W: fused.rmsnorm_matmul_plain(
                x, w, W, eps=eps, mode=m),
            library=lambda x=x, W=W: F.rms_norm(x, (d,), w, eps).to(W.dtype)
            @ W,
            bytes=2 * (SLOTS * d + d + SLOTS * n) + wbytes * d * n,
            flops=2 * SLOTS * d * n,
            source="src/repro_torch/csrc/rmsnorm_matmul.cu",
            replaces="src/repro/kernels/fused.py:296"))
    wo = rand(h * hd, d, scale=(h * hd) ** -0.5)
    for sq in (512, 300):
        q, k, v = rand(1, h, sq, hd), rand(1, hkv, sq, hd), rand(1, hkv, sq, hd)

        def causal_library(q=q, k=k, v=v, sq=sq):
            o = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True)
            return o.transpose(1, 2).reshape(1, sq, h * hd) @ wo
        pairs = sq * (sq + 1) // 2
        cases.append(dict(
            name=f"flash_attention_matmul_moe{sq}",
            counter="flash_attention_matmul", path="moe P1",
            mode_path="moe@128 P1", route="tc",
            shape=f"causal B=1, {h}/{hkv} heads x {hd}, {sq} tokens, wo "
                  f"[{h * hd},{d}] bf16",
            kernel=lambda q=q, k=k, v=v: fused.flash_attention_matmul(
                q, k, v, wo),
            plain=lambda q=q, k=k, v=v: fused.flash_attention_matmul_plain(
                q, k, v, wo),
            mode_kernel=lambda m, q=q, k=k, v=v: fused.flash_attention_matmul(
                q, k, v, wo, mode=m),
            mode_plain=lambda m, q=q, k=k, v=v:
                fused.flash_attention_matmul_plain(q, k, v, wo, mode=m),
            library=causal_library,
            bytes=2 * (q.numel() + k.numel() + v.numel() + wo.numel()
                       + sq * d),
            flops=h * pairs * 4 * hd + 2 * sq * h * hd * d,
            source="src/repro_torch/csrc/flash_attention_matmul.cu",
            replaces="src/repro/kernels/fused.py:702"))
    rng = np.random.default_rng(1)
    pos_np = rng.integers(128, MAX_LEN - NEW_TOKENS, SLOTS).astype(np.int32)
    pos = torch.from_numpy(pos_np).to(dev)
    maxp = MAX_LEN // PAGE
    num_pages = SLOTS * maxp
    qd = rand(SLOTS, h, 1, hd)
    kp, vp = rand(num_pages, hkv, PAGE, hd), rand(num_pages, hkv, PAGE, hd)
    tables = torch.from_numpy(rng.permutation(num_pages).astype(np.int32)
                              .reshape(SLOTS, maxp)).to(dev)
    visible = int((pos_np + 1).sum())
    cases.append(dict(
        name="paged_attention_matmul_moe", counter="paged_attention_matmul",
        path="moe P1", route="decode",
        shape=f"{SLOTS} slots, {num_pages} pages of {PAGE}, {h}/{hkv} heads "
              f"x {hd}, frontiers {int(pos_np.min())}-{int(pos_np.max())} "
              f"bf16",
        kernel=lambda: fused.paged_attention_matmul(
            qd, kp, vp, wo, block_tables=tables, pos=pos),
        plain=lambda: fused.paged_attention_matmul_plain(
            qd, kp, vp, wo, block_tables=tables, pos=pos),
        library=None,
        bytes=2 * (qd.numel() + 2 * hkv * hd * visible + wo.numel()
                   + SLOTS * d) + 4 * SLOTS * (1 + maxp),
        flops=h * visible * 4 * hd + 2 * SLOTS * h * hd * d,
        source="src/repro_torch/csrc/paged_attention_matmul.cu",
        replaces="src/repro/kernels/fused.py:854"))
    # the same frontiers over pages of 128 keys, the page size the modes
    # need: native here is the yardstick of their rows
    maxp = -(-MAX_LEN // MODE_PAGE)
    num_pages = SLOTS * maxp
    kp = rand(num_pages, hkv, MODE_PAGE, hd)
    vp = rand(num_pages, hkv, MODE_PAGE, hd)
    tables128 = torch.from_numpy(rng.permutation(num_pages).astype(np.int32)
                                 .reshape(SLOTS, maxp)).to(dev)
    cases.append(dict(
        name="paged_attention_matmul_moe_page128",
        counter="paged_attention_matmul", mode_path="moe@128 P1",
        route="decode",
        shape=f"{SLOTS} slots, {num_pages} pages of {MODE_PAGE}, {h}/{hkv} "
              f"heads x {hd}, same frontiers bf16",
        kernel=lambda: fused.paged_attention_matmul(
            qd, kp, vp, wo, block_tables=tables128, pos=pos),
        plain=lambda: fused.paged_attention_matmul_plain(
            qd, kp, vp, wo, block_tables=tables128, pos=pos),
        mode_kernel=lambda m: fused.paged_attention_matmul(
            qd, kp, vp, wo, block_tables=tables128, pos=pos, mode=m),
        mode_plain=lambda m: fused.paged_attention_matmul_plain(
            qd, kp, vp, wo, block_tables=tables128, pos=pos, mode=m),
        library=None,
        bytes=2 * (qd.numel() + 2 * hkv * hd * visible + wo.numel()
                   + SLOTS * d) + 4 * SLOTS * (1 + maxp),
        flops=h * visible * 4 * hd + 2 * SLOTS * h * hd * d,
        source="src/repro_torch/csrc/paged_attention_matmul.cu",
        replaces="src/repro/kernels/fused.py:854"))
    return cases


def compare(out, ref):
    """(max abs error, max over output rows of max|err row| / max|plain
    row|, ||err|| / ||plain||): the row-scaled bound keeps a row of small
    values (late causal queries) from hiding under a large row's tolerance,
    the relative RMS bounds the error of the tensor as a whole."""
    o = out.float().reshape(-1, out.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    diff = (o - r).abs()
    row = diff.amax(dim=1) / r.abs().amax(dim=1).clamp_min(1e-30)
    return (float(diff.max()), float(row.max()),
            float(torch.linalg.vector_norm(o - r)
                  / torch.linalg.vector_norm(r).clamp_min(1e-30)))


def native_path(case):
    """The run that counts a native case's launches when it names none: a
    case with mode rows is counted on its mode group's native run."""
    return f"{case['mode_path']} native" if "mode_path" in case else None


def run_kernels(cases, dev):
    """Check, time and bound each case.  A case of a kernel with several
    routes (the tensor cores, "tc", the norm-GEMMs' decode GEMV, "gemv", or
    the f32 FMA kernel, "fma"; the C library decides) logs the route its
    call took, and fails if it names another (``route``)."""
    from repro_torch.kernels._launch import LAST_ROUTE
    flush = torch.zeros(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    rows = []
    # half a second of the first kernel brings the card to its clocks under
    # load before the first case is timed
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        cases[0]["kernel"]()
        torch.cuda.synchronize()
    for case in cases:
        LAST_ROUTE.clear()
        outs = case["kernel"]()
        route = LAST_ROUTE.get(case["counter"])
        check(route == case.get("route", route), f"{case['name']}: the "
              f"{route} route, not {case.get('route')}")
        refs = case["plain"]()
        torch.cuda.synchronize()
        names = case.get("outputs", ("out",))
        if len(names) == 1:
            outs, refs = (outs,), (refs,)
        parts = {}
        for part, out, ref in zip(names, outs, refs):
            check(out.shape == ref.shape, f"{case['name']} {part}: shape "
                  f"{tuple(out.shape)} != {tuple(ref.shape)}")
            check(torch.isfinite(out.float()).all().item(),
                  f"{case['name']} {part}: non-finite output")
            parts[part] = compare(out, ref)
            if part in case.get("exact", ()):
                check(torch.equal(out, ref), f"{case['name']} {part}: not "
                      f"bit-equal to the plain version")
        del outs, refs
        err, row_err, rms_err = (max(v[i] for v in parts.values())
                                 for i in range(3))
        # a mode's row: native first, then the mode, on the same inputs; a
        # row of a few microseconds (the row norms) times the kernel as the
        # median of readings, as its library call
        timer = library_ms if case.get("median") else time_ms
        native_ms = (timer(case["native_kernel"], flush=flush)
                     if "native_kernel" in case else None)
        ms = timer(case["kernel"], flush=flush)
        plain_ms = time_ms(case["plain"], flush=flush)
        lib_ms = (library_ms(case["library"], flush=flush)
                  if case["library"] is not None else None)
        bms, by = bound_ms(case["bytes"], case["flops"])
        each = "".join(f"; {part}: max_abs_err {v[0]:.4g}, row-relative "
                       f"{v[1]:.4g}, relative RMS {v[2]:.4g}"
                       for part, v in parts.items()) if len(parts) > 1 else ""
        log(f"kernel {case['name']} ({case['shape']}): max_abs_err {err:.4g}"
            f", row-relative {row_err:.4g} (tol {TOL_ROW}), relative RMS "
            f"{rms_err:.4g} (tol {TOL_RMS}){each}; ms {ms:.4f}"
            f"{' (median of readings)' if case.get('median') else ''} "
            f"plain_ms "
            f"{plain_ms:.4f} library_ms "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} bound_ms "
            f"{bms:.4f} ({by}){'' if route is None else f'; route {route}'}")
        check(row_err <= TOL_ROW, f"{case['name']}: row-relative error "
              f"{row_err} > {TOL_ROW}")
        check(rms_err <= TOL_RMS, f"{case['name']}: relative RMS error "
              f"{rms_err} > {TOL_RMS}")
        row = dict(name=case["name"], route="cuda", source=case["source"],
                   replaces=case["replaces"], launches=0, max_abs_err=err,
                   ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   library_ms=lib_ms, counter=case["counter"],
                   head=case.get("head", False),
                   path=case.get("path") or native_path(case),
                   mode=case.get("mode", "native"),
                   shape=case["shape"], row_rel_err=row_err,
                   tol_row_rel=TOL_ROW, rel_rms_err=rms_err,
                   tol_rel_rms=TOL_RMS)
        if route is not None:
            row["math"] = route
        if native_ms is not None:
            row.update(native_ms=native_ms,
                       pct_of_native=100.0 * native_ms / ms)
            log(f"kernel {case['name']}: {row['pct_of_native']:.1f}% of "
                f"native ({native_ms:.4f} ms native, then {ms:.4f} ms "
                f"{case['mode']}, on the same inputs)")
        if len(parts) > 1:
            row["outputs"] = {part: dict(max_abs_err=v[0], row_rel_err=v[1],
                                         rel_rms_err=v[2])
                              for part, v in parts.items()}
        if "library_note" in case:
            row["library_note"] = case["library_note"]
        rows.append(row)
    del flush
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------
# phases 4-6: the engine
# --------------------------------------------------------------------------


def main_path_policy(ParallelConfig):
    return ParallelConfig(fuse_epilogues=True, use_pallas_attn=True)


def _route_tally(before, prefixes):
    """{counter: {route: launches}} of the counters starting with
    ``prefixes`` since ``before`` (a copy of ``ROUTE_LAUNCHES``)."""
    from repro_torch.kernels._launch import ROUTE_LAUNCHES
    tally = {}
    for (counter, route), n in ROUTE_LAUNCHES.items():
        if counter.startswith(prefixes) \
                and n > before.get((counter, route), 0):
            tally.setdefault(counter, {})[route] = \
                n - before.get((counter, route), 0)
    return tally


def norm_gemm_routes(before, label: str):
    """Log a card run's norm-GEMM launches by route (``ROUTE_LAUNCHES``
    less ``before``, its copy from before the run) and the route of each
    one's last launch (the run's last decode tick).  A norm-GEMM that
    launched must show the decode GEMV, and its last launch must have taken
    it (behind an f32 tied head too: the GEMV's transposed-table form)."""
    from repro_torch.kernels._launch import LAST_ROUTE
    tally = _route_tally(before, ("rmsnorm_matmul", "rmsnorm_swiglu"))
    if not tally:
        log(f"{label}: no norm-GEMM on this path")
    for counter, routes in sorted(tally.items()):
        last = LAST_ROUTE.get(counter)
        log(f"{label}: {counter} launches by route "
            f"{json.dumps(dict(sorted(routes.items())))}, the last tick's "
            f"{last}")
        check(routes.get("gemv", 0) > 0, f"{label}: {counter} never took "
              f"the decode GEMV")
        check(last == "gemv", f"{label}: {counter}'s last decode launch "
              f"took {last}, not the decode GEMV")


def tied_head_routes(mode: str, layers: int, prefills: int, ticks: int,
                     what: str, kernel: str = "rmsnorm_matmul"):
    """On a path whose ``kernel`` (rmsnorm_matmul, or rmsnorm_matmul_q8
    under the int8 policy) carries the head (the tied f32 table, P1 in
    bf16; under int8 granite-8b's bf16 lm_head too, each quantized per call
    inside the GEMV; ``ROUTE_LAUNCHES`` holds the run alone): every decode
    launch (each tick's qkv and head, each prefill's one-row head) took the
    GEMV, each prefill's qkv the tensor cores, none the FMA kernel."""
    from repro_torch.kernels._launch import ROUTE_LAUNCHES, count_name
    counter = count_name(kernel, mode)
    routes = {r: n for (c, r), n in ROUTE_LAUNCHES.items() if c == counter}
    if not routes:
        return
    want = {"tc": layers * prefills, "gemv": (layers + 1) * ticks + prefills}
    log(f"{what}: {counter} launches by route "
        f"{json.dumps(dict(sorted(routes.items())))} (the head on the "
        f"GEMV)")
    check(routes == want, f"{what}: {counter} routes {routes}, not {want}")


def head_key(counter: str) -> str:
    """The key under which a run's counts hold its head's own launches of
    ``counter`` (one a prefill, one a tick)."""
    return f"{counter} head"


def attention_routes(before, label: str):
    """Log a card run's attention + wo launches by route, as
    norm_gemm_routes; every launch of a ``pos`` or paged shape must have
    taken the decode route."""
    tally = _route_tally(before, ("flash_attention_matmul",
                                  "paged_attention_matmul"))
    if not tally:
        log(f"{label}: no attention + wo on this path")
    for counter, routes in sorted(tally.items()):
        log(f"{label}: {counter} launches by route "
            f"{json.dumps(dict(sorted(routes.items())))}")
        if counter.startswith("paged") or "_pos" in counter:
            check(set(routes) == {"decode"}, f"{label}: {counter} took "
                  f"{sorted(routes)}, not the decode route alone")


def row_norm_routes(counts, what: str) -> None:
    """Tally a card run's row-norm launches by route (``ROUTE_LAUNCHES``
    holds the run alone) and hold them exactly: every launch of rmsnorm and
    add_rmsnorm at the served widths (1536, 2560, 5120, 16-byte aligned)
    on the one-pass routes, native's ``vector``, the modes' ``element``."""
    from repro_torch.kernels._launch import ROUTE_LAUNCHES, count_name
    for kernel in ("rmsnorm", "add_rmsnorm"):
        for mode in ("native",) + MODES:
            counter = count_name(kernel, mode)
            if not counts.get(counter):
                continue
            routes = {r: n for (c, r), n in ROUTE_LAUNCHES.items()
                      if c == counter}
            want = {"vector" if mode == "native" else "element":
                    counts[counter]}
            log(f"{what}: {counter} launches by route "
                f"{json.dumps(dict(sorted(routes.items())))}")
            check(routes == want, f"{what}: {counter} routes {routes}, not "
                  f"{want}")


def ssd_scan_routes(want_route: str, what: str, counts=None,
                    before=None) -> None:
    """Tally a card run's ssd_scan launches by route (``ROUTE_LAUNCHES``
    less ``before``, or all of it) and hold them: every launch of each
    mode's counter on ``want_route``, and, with ``counts``, as many as the
    run counted (mamba2-2.7b's bf16 prefill scans: "tc"; the reduced f32
    checks: "fma")."""
    tally = _route_tally(before or {}, ("ssd_scan",))
    check(tally, f"{what}: no ssd_scan launch reported a route")
    for counter, routes in sorted(tally.items()):
        log(f"{what}: {counter} launches by route "
            f"{json.dumps(dict(sorted(routes.items())))}")
        want = {want_route: counts[counter] if counts is not None
                else sum(routes.values())}
        check(routes == want, f"{what}: {counter} routes {routes}, not "
              f"{want}")


def reference_check(build_model, ParallelConfig, get_reduced, Engine,
                    Request, ServeConfig, dev):
    """granite-8b-reduced (f32): kernels on the card vs plain on the CPU."""
    cfg = get_reduced("granite-8b")
    par = main_path_policy(ParallelConfig)
    cpu_model = build_model(cfg, par, device="cpu")
    params_cpu = cpu_model.init_params(0)
    gpu_model = build_model(cfg, par, device=dev)
    params_gpu = _to_device(params_cpu, dev)
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, n)]
               for n in (9, 17, 5, 12)]
    prompts[1][:8] = prompts[0][:8]                    # one shared page
    toks = torch.tensor([prompts[0]], dtype=torch.int32)
    want, _ = cpu_model.prefill(params_cpu, {"tokens": toks})
    got, _ = gpu_model.prefill(params_gpu, {"tokens": toks.to(dev)})
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               rtol=2e-4, atol=2e-4)
    from repro_torch.kernels._launch import ROUTE_LAUNCHES
    before = dict(ROUTE_LAUNCHES)
    runs = []
    for model, params in ((cpu_model, params_cpu), (gpu_model, params_gpu)):
        eng = Engine(model, params, ServeConfig(
            batch_slots=2, max_seq_len=32, eos_id=-1, page_size=8))
        done = eng.run([Request(rid=i, prompt=list(p), max_new_tokens=8)
                        for i, p in enumerate(prompts)])
        runs.append({r.rid: r.generated for r in done})
    check(runs[0] == runs[1], f"reduced engine tokens differ: {runs}")
    norm_gemm_routes(before, "reference check")
    attention_routes(before, "reference check")
    log(f"reference check: granite-8b-reduced f32, {len(prompts)} requests, "
        f"card tokens == CPU tokens, prefill logits within 2e-4")


def _to_device(tree, dev):
    return {k: _to_device(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def profile_ticks(eng, ticks: int):
    """Device busy ms per tick over ``ticks`` decode ticks (torch.profiler),
    by kernel, and the host operators' self time; None when the profiler
    recorded no device time.  The profiler slows the host, so the wall
    time it prints is not the tick's."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, host = [], []
    for e in prof.key_averages():
        # kernels only: an operator (aten::mm) repeats its kernels' time
        if e.device_type != torch.autograd.DeviceType.CUDA:
            if e.self_cpu_time_total > 0:
                host.append((e.self_cpu_time_total / 1e3 / ticks,
                             e.count // ticks, e.key))
            continue
        self_us = getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0))
        if self_us > 0:
            rows.append((self_us / 1e3 / ticks, e.count // ticks, e.key))
    # where the host's time goes (inflated by the profiler: compare
    # shares, not times)
    for ms, count, key in sorted(host, reverse=True)[:8]:
        log(f"profile host: {ms:8.3f} ms/tick {count:5d} calls/tick  "
            f"{key[:70]}")
    busy = sum(r[0] for r in rows)
    if not rows:
        log("profile: the profiler recorded no device time")
        return None
    log(f"profile ({ticks} ticks): device busy {busy:.3f} ms/tick "
        f"(wall {wall_ms / ticks:.3f} ms/tick with the profiler on)")
    ranked = sorted(rows, reverse=True)
    # the top 12, then every hand-written kernel below them
    for i, (ms, count, key) in enumerate(ranked):
        if i < 12 or "uisa::" in key:
            log(f"profile: {ms:8.3f} ms/tick {count:5d} launches/tick  "
                f"{key[:90]}")
    return busy


def measure_tick(eng, Request, prompts, label: str):
    """The steady decode tick at 8 live slots, after a run: admit 8 fresh
    requests (128-token prompts), warm up one tick, time 16 on the host
    clock, then profile 3 and print the device's idle share.  Returns (tick
    ms, profiled device busy ms per tick or None)."""
    more = [Request(rid=100 + i, prompt=prompts[i][:128], max_new_tokens=64)
            for i in range(SLOTS)]
    check(eng.admit(more) == SLOTS, f"{label}: tick probe admission failed")
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(16):
        eng.step()
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) / 16 * 1e3
    log(f"{label} decode tick: {tick_ms:.3f} ms at {SLOTS} live slots "
        f"(host clock, 16 ticks)")
    busy = profile_ticks(eng, ticks=3)
    if busy is not None:
        log(f"{label} idle share: {max(0.0, 1 - busy / tick_ms):.3f} "
            f"(1 - profiled device busy / unprofiled tick)")
    torch.cuda.synchronize()
    return tick_ms, busy


def serve_main_path(fused, build_model, ParallelConfig, cfg, Engine, Request,
                    ServeConfig, dev):
    t0 = time.perf_counter()
    model = build_model(cfg, main_path_policy(ParallelConfig), device=dev)
    params = model.init_params(0)
    torch.cuda.synchronize()
    log(f"main path: {cfg.name} at full width, {cfg.num_layers} layers, "
        f"bf16, random weights from seed 0, init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(2)
    lens = rng.integers(128, 513, 12)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, n)]
               for n in lens]
    prompts[1][:2 * PAGE] = prompts[0][:2 * PAGE]      # two shared pages
    eng = Engine(model, params, ServeConfig(
        batch_slots=SLOTS, max_seq_len=MAX_LEN, eos_id=-1, page_size=PAGE,
        max_new_tokens=NEW_TOKENS))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    fused.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fused.LAUNCHES)
    check(len(done) == 12 and all(r.done and not r.rejected for r in done),
          "not every request finished")
    check(all(len(r.generated) == NEW_TOKENS and
              all(0 <= t < cfg.vocab_size for t in r.generated)
              for r in done), "wrong generated tokens")
    check(eng.pool.shared_hits >= 2, "the shared prefix was not shared")
    n_gen = sum(len(r.generated) for r in done)
    stats = eng.tick_stats
    log(f"main path: 12 requests, prompts {int(lens.min())}-{int(lens.max())}"
        f" tokens ({int(lens.sum())} total), {n_gen} tokens generated in "
        f"{wall:.3f} s = {n_gen / wall:.1f} tokens/s (prefill included), "
        f"{eng.tick_count} ticks")
    log(f"main path tick_stats: ticks {len(stats)}, max live_slots "
        f"{max(s['live_slots'] for s in stats)}, max frontier_pages "
        f"{max(s['frontier_pages'] for s in stats)}, max pool_utilization "
        f"{max(s['pool_utilization'] for s in stats):.3f}, "
        f"shared_prefix_hits {eng.pool.shared_hits}")
    log(f"main path launches: {json.dumps(counts)}")
    for name in ("rmsnorm_matmul", "rmsnorm_swiglu", "flash_attention_matmul",
                 "paged_attention_matmul"):
        check(counts[name] > 0, f"{name} never launched on the main path")
    tick_ms, _ = measure_tick(eng, Request, prompts, "main path")
    logits, _ = model.prefill(params, {"tokens": torch.tensor(
        [prompts[0]], dtype=torch.int32, device=dev)})
    check(logits.shape == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "non-finite logits")
    del eng, params, model
    torch.cuda.empty_cache()
    return counts, n_gen / wall, tick_ms


def serve_dense_pass(fused, build_model, ParallelConfig, cfg, Engine,
                     Request, ServeConfig, dev, layers: int = 4, common=None,
                     mode=None):
    """A dense-cache engine pass at reduced depth; with ``common`` under the
    int8 policy (quantized weights, the int8 dense cache), with ``mode``
    under that mode's policy (both: the int8 policy in that mode), with
    exact launch counts."""
    int8 = common is not None
    what = ("dense int8 pass" if int8 else "dense pass") + (
        f" [{mode}]" if mode else "")
    cfg = dataclasses.replace(cfg, num_layers=layers)
    par = (ParallelConfig(**(int8_mode_policy(mode) if mode
                             else INT8_POLICY)) if int8
           else ParallelConfig(**mode_policy(mode)) if mode
           else main_path_policy(ParallelConfig))
    model = build_model(cfg, par, device=dev)
    params = model.init_params(1)
    if int8:
        quantize_in_place(params, common)
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=[int(t) for t in rng.integers(
        2, cfg.vocab_size, int(n))], max_new_tokens=8)
        for i, n in enumerate(rng.integers(128, 257, SLOTS))]
    eng = Engine(model, params, ServeConfig(
        batch_slots=SLOTS, max_seq_len=MAX_LEN, eos_id=-1))
    fused.reset_launch_counts()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    counts = dict(fused.LAUNCHES)
    check(all(r.done and len(r.generated) == 8 for r in done),
          f"{what}: not every request finished")
    log(f"{what}: {layers} layers at full width, {len(done)} requests, "
        f"launches {json.dumps(counts)}")
    if int8:
        check_launches(counts, int8_expected_launches(
            layers, len(done), eng.tick_count, paged=False,
            mode=mode or "native"), what)
    elif mode:
        check_launches(counts, mode_expected_launches(
            mode, layers, len(done), eng.tick_count, paged=False), what)
    else:
        for name in ("rmsnorm_matmul", "rmsnorm_swiglu",
                     "flash_attention_matmul", "flash_attention_matmul_pos"):
            check(counts[name] > 0, f"{name} never launched on the {what}")
    # one tick with host syncs forbidden (after a warm-up tick)
    check(eng.admit([Request(rid=99, prompt=[5, 6, 7], max_new_tokens=16)])
          == 1, "sync probe admission failed")
    eng.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"{what}: one decode tick under set_sync_debug_mode('error'): no "
        f"host sync")
    return counts


# --------------------------------------------------------------------------
# phases 15-17: granite-8b's int8 path
# --------------------------------------------------------------------------

#: int8 weights and the int8 KV cache beside the fused policy
INT8_POLICY = dict(fuse_epilogues=True, use_pallas_attn=True,
                   weight_precision="int8", kv_cache_int8=True)


def int8_mode_policy(mode: str) -> dict:
    """The int8 policy with every kernel in ``mode``."""
    return dict(INT8_POLICY, isa_mode=mode)


def int8_expected_launches(layers: int, prefills: int, ticks: int,
                           paged: bool = True, mode: str = "native"):
    """Every kernel's launches on the int8 path: ln1 -> wqkv and the head
    (a bf16 weight the q8 op quantizes, as the JAX package's head under the
    int8 policy) through rmsnorm_matmul_q8, ln2 -> [wi|wg] through
    rmsnorm_swiglu_q8, causal prefill attention + wo through
    flash_attention_matmul_q8, decode attention + wo through the paged
    (or, dense, the ``pos``) shape of the q8 attention kernel; under a
    mode each counts under its mode's name."""
    from repro_torch.kernels._launch import count_name
    c = functools.partial(count_name, mode=mode)
    decode = ("paged_attention_matmul_q8" if paged
              else "flash_attention_matmul_q8_pos")
    return {c("rmsnorm_matmul_q8"): (layers + 1) * (prefills + ticks),
            c("rmsnorm_swiglu_q8"): layers * (prefills + ticks),
            c("flash_attention_matmul_q8"): layers * prefills,
            c(decode): layers * ticks}


def check_launches(counts, want, what: str) -> None:
    """Every kernel launched exactly as ``want`` says, and no other."""
    for name, n in counts.items():
        check(n == want.get(name, 0), f"{what}: {name} launched {n} times, "
              f"expected {want.get(name, 0)}")
    log(f"{what} launch counts as expected: {json.dumps(want)}")


def quantize_in_place(params, common) -> None:
    """``common.quantize_params``' tree, one leaf at a time: each bf16 leaf
    is dropped as soon as its int8 form and scales exist, so the peak is
    the bf16 tree plus one leaf's temporaries."""
    blocks = params["blocks"]
    for group, keys in common.QUANT_GROUPS:
        for key in keys:
            if key not in blocks.get(group, {}):
                continue                   # granite-moe: no dense MLP
            leaf = blocks[group].pop(key)
            blocks[group][key], blocks[group][key + "_scale"] = \
                common.quantize_weight(leaf)
            del leaf


def int8_reference_check(build_model, ParallelConfig, get_reduced, common,
                         Engine, Request, ServeConfig, dev):
    """granite-8b-reduced (f32) under the int8 policy, one quantized tree:
    the q8 kernels on the card vs the plain versions on the CPU."""
    cfg = get_reduced("granite-8b")
    par = ParallelConfig(**INT8_POLICY)
    cpu_model = build_model(cfg, par, device="cpu")
    params_cpu = common.quantize_params(cpu_model.init_params(0))
    gpu_model = build_model(cfg, par, device=dev)
    params_gpu = _to_device(params_cpu, dev)
    rng = np.random.default_rng(8)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, n)]
               for n in (9, 17, 5, 12)]
    prompts[1][:8] = prompts[0][:8]                    # one shared page
    toks = torch.tensor([prompts[0]], dtype=torch.int32)
    want, _ = cpu_model.prefill(params_cpu, {"tokens": toks})
    got, _ = gpu_model.prefill(params_gpu, {"tokens": toks.to(dev)})
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               rtol=2e-4, atol=2e-4)
    from repro_torch.kernels._launch import ROUTE_LAUNCHES
    before = dict(ROUTE_LAUNCHES)
    runs = []
    for model, params in ((cpu_model, params_cpu), (gpu_model, params_gpu)):
        eng = Engine(model, params, ServeConfig(
            batch_slots=2, max_seq_len=32, eos_id=-1, page_size=8))
        done = eng.run([Request(rid=i, prompt=list(p), max_new_tokens=8)
                        for i, p in enumerate(prompts)])
        runs.append({r.rid: r.generated for r in done})
    check(runs[0] == runs[1], f"reduced int8 engine tokens differ: {runs}")
    attention_routes(before, "int8 reference check")
    log(f"int8 reference check: granite-8b-reduced f32 under the int8 "
        f"policy, {len(prompts)} requests, card tokens == CPU tokens, "
        f"prefill logits within 2e-4")


def serve_int8_path(fused, common, build_model, ParallelConfig, cfg, Engine,
                    Request, ServeConfig, dev):
    """granite-8b at full width and depth under the int8 policy: bf16
    random weights from seed 0 quantized on the card, the paged engine
    with its pool sized by the bytes of the bf16 engine's dense-equivalent
    pool, 12 requests with exact launch counts, then the tick at 8 live
    slots, a profile, and one tick with host syncs forbidden."""
    t0 = time.perf_counter()
    model = build_model(cfg, ParallelConfig(**INT8_POLICY), device=dev)
    params = model.init_params(0)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    quantize_in_place(params, common)
    torch.cuda.synchronize()
    log(f"int8 path: {cfg.name} at full width, {cfg.num_layers} layers, bf16 "
        f"random weights from seed 0 (init {t_init:.1f} s), wqkv/wo/wig "
        f"quantized to int8 on the card in "
        f"{time.perf_counter() - t0 - t_init:.1f} s; "
        f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB allocated")
    serve = dict(batch_slots=SLOTS, max_seq_len=MAX_LEN, eos_id=-1,
                 page_size=PAGE, max_new_tokens=NEW_TOKENS)
    bf16 = Engine(build_model(cfg, main_path_policy(ParallelConfig),
                              device=dev), params, ServeConfig(**serve))
    budget = bf16.num_pages * bf16.page_footprint_bytes()
    bf16_pages, bf16_page_bytes = bf16.num_pages, bf16.page_footprint_bytes()
    del bf16
    torch.cuda.empty_cache()
    eng = Engine(model, params, ServeConfig(kv_pool_bytes=budget, **serve))
    ratio = eng.num_pages / bf16_pages
    log(f"int8 path pages from one kv_pool_bytes budget of {budget} bytes: "
        f"bf16 {bf16_pages} pages of {bf16_page_bytes} bytes, int8 "
        f"{eng.num_pages} pages of {eng.page_footprint_bytes()} bytes, "
        f"ratio {ratio:.3f} (bytes per token and head: 2 x "
        f"{cfg.resolved_head_dim} against {cfg.resolved_head_dim} + 4)")
    check(eng.num_pages == budget // eng.page_footprint_bytes(),
          "int8 pool not sized by the byte budget")
    rng = np.random.default_rng(9)
    lens = rng.integers(128, 513, 12)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, n)]
               for n in lens]
    prompts[1][:2 * PAGE] = prompts[0][:2 * PAGE]      # two shared pages
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    fused.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fused.LAUNCHES)
    check(len(done) == 12 and all(r.done and not r.rejected for r in done),
          "int8 path: not every request finished")
    check(all(len(r.generated) == NEW_TOKENS and
              all(0 <= t < cfg.vocab_size for t in r.generated)
              for r in done), "int8 path: wrong generated tokens")
    check(eng.pool.shared_hits >= 2, "int8 path: the shared prefix was not "
          "shared")
    n_gen = sum(len(r.generated) for r in done)
    log(f"int8 path: 12 requests, prompts {int(lens.min())}-"
        f"{int(lens.max())} tokens ({int(lens.sum())} total), {n_gen} tokens "
        f"generated in {wall:.3f} s = {n_gen / wall:.1f} tokens/s (prefill "
        f"included), {eng.tick_count} ticks, shared_prefix_hits "
        f"{eng.pool.shared_hits}")
    log(f"int8 path launches: {json.dumps(counts)}")
    check_launches(counts, int8_expected_launches(
        cfg.num_layers, len(done), eng.tick_count), "int8 path")
    tied_head_routes("native", cfg.num_layers, len(done), eng.tick_count,
                     "int8 path", kernel="rmsnorm_matmul_q8")
    counts[head_key("rmsnorm_matmul_q8")] = len(done) + eng.tick_count
    measure_tick(eng, Request, prompts, "int8 path")
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("int8 path: one decode tick under set_sync_debug_mode('error'): no "
        "host sync")
    logits, cache = model.prefill(params, {"tokens": torch.tensor(
        [prompts[0]], dtype=torch.int32, device=dev)})
    check(logits.shape == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all())
          and cache["k"].dtype == torch.int8
          and bool(torch.isfinite(cache["k_scale"]).all()),
          "int8 path: non-finite logits or a wrong cache")
    del eng, params, model, cache
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------------
# phases 18-20: granite-8b under the abstract and abstract+shuffle modes
# --------------------------------------------------------------------------


def mode_policy(mode: str) -> dict:
    """The fused policy with every kernel in ``mode``."""
    return dict(isa_mode=mode, fuse_epilogues=True, use_pallas_attn=True)


def mode_expected_launches(mode: str, layers: int, prefills: int, ticks: int,
                           paged: bool = True):
    """Every kernel's launches on granite-8b's path under ``mode``: the same
    four kernel shapes as the fused policy's (ln1 -> wqkv and the head,
    ln2 -> [wi|wg], causal prefill attention + wo, paged or ``pos`` decode
    attention + wo), each counted under its mode's name."""
    from repro_torch.kernels._launch import count_name
    c = functools.partial(count_name, mode=mode)
    decode = "paged_attention_matmul" if paged else \
        "flash_attention_matmul_pos"
    return {c("rmsnorm_matmul"): (layers + 1) * (prefills + ticks),
            c("rmsnorm_swiglu"): layers * (prefills + ticks),
            c("flash_attention_matmul"): layers * prefills,
            c(decode): layers * ticks}


def granite_mode_groups():
    """granite-8b's mode runs: one group, the fused policy."""
    return {f"granite@{MODE_PAGE}": (mode_policy, mode_expected_launches)}


def mode_reference_check(build_model, ParallelConfig, get_reduced, Engine,
                         Request, ServeConfig, dev, arch="granite-8b",
                         groups=None, lens=(140, 150, 9, 20), seed=10,
                         common=None):
    """``arch``-reduced (f32) under each mode of each policy group (label
    -> (mode -> policy, launches); granite-8b's fused policy by default),
    one parameter set (with ``common``, ``common.quantize_params``' tree,
    for an int8 group): the mode's kernels on the card vs its plain
    versions on the CPU, paged at 128 keys a page (prompts of ``lens``
    tokens, the first two sharing a full first page); tokens equal,
    prefill logits within 2e-4; the card run's norm-GEMM and attention + wo
    routes are logged and held (norm_gemm_routes, attention_routes)."""
    from repro_torch.kernels._launch import ROUTE_LAUNCHES
    groups = groups or granite_mode_groups()
    cfg = get_reduced(arch)
    policy = next(iter(groups.values()))[0]
    params_cpu = build_model(cfg, ParallelConfig(**policy("native")),
                             device="cpu").init_params(0)
    if common is not None:
        params_cpu = common.quantize_params(params_cpu)
    params_gpu = _to_device(params_cpu, dev)
    rng = np.random.default_rng(seed)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, n)]
               for n in lens]
    prompts[1][:MODE_PAGE] = prompts[0][:MODE_PAGE]    # one shared page
    toks = torch.tensor([prompts[0]], dtype=torch.int32)
    for group, (policy, _) in groups.items():
        for mode in MODES:
            par = ParallelConfig(**policy(mode))
            cpu_model = build_model(cfg, par, device="cpu")
            gpu_model = build_model(cfg, par, device=dev)
            want, _ = cpu_model.prefill(params_cpu, {"tokens": toks})
            got, _ = gpu_model.prefill(params_gpu, {"tokens": toks.to(dev)})
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                       rtol=2e-4, atol=2e-4)
            before = dict(ROUTE_LAUNCHES)
            runs = []
            for model, params in ((cpu_model, params_cpu),
                                  (gpu_model, params_gpu)):
                eng = Engine(model, params, ServeConfig(
                    batch_slots=2, max_seq_len=2 * MODE_PAGE, eos_id=-1,
                    page_size=MODE_PAGE))
                done = eng.run([Request(rid=i, prompt=list(p),
                                        max_new_tokens=8)
                                for i, p in enumerate(prompts)])
                runs.append({r.rid: r.generated for r in done})
                check(eng.pool.shared_hits >= 1, f"reduced {arch} {group} "
                      f"[{mode}]: the shared page was not shared")
            check(runs[0] == runs[1], f"reduced {arch} engine tokens differ "
                  f"under {group} [{mode}]: {runs}")
            norm_gemm_routes(before, f"mode reference check ({group}, "
                             f"{mode})")
            attention_routes(before, f"mode reference check ({group}, "
                             f"{mode})")
            log(f"mode reference check ({group}, {mode}): {cfg.name} f32, "
                f"{len(prompts)} requests paged at {MODE_PAGE}, card tokens "
                f"== CPU tokens, prefill logits within 2e-4")


def serve_mode_paths(fused, build_model, ParallelConfig, cfg, Engine,
                     Request, ServeConfig, dev, groups=None, seed=2,
                     page_size=MODE_PAGE, baseline=None, common=None,
                     routes=None, modes=MODES):
    """``cfg`` at full width and depth, one parameter draw (seed 0, bf16,
    the first group's layout), serving the same 12 requests at pages of
    ``page_size`` (two sharing a full first page; None: the dense-state
    engine, no sharing) under each policy group (label -> (mode -> policy,
    launches); granite-8b's fused policy by default) in native, abstract
    and abstract+shuffle: exact launch counts per (kernel, mode), then the
    tick at 8 live slots, a profile, one tick with host syncs forbidden,
    and the share of generated tokens equal to native's under the same
    group (reported: a bf16 sum order may flip a near tie), and, with
    ``baseline`` ((label, tokens by request) of another run of the same
    prompts and weights), the share equal to that run's.  With ``common``
    the groups run the int8 policy: the bf16 weights are quantized on the
    card leaf by leaf (``quantize_in_place``), and each engine's pool is
    sized by the bytes of a bf16 engine's pool at the same page size (both
    page counts reported), and each path's counts also hold its head's own
    q8 launches (``head_key``).  ``routes`` (mode, prefills, ticks, label),
    where given, holds each run's launches by route.  ``modes`` are the
    modes run after native; a group may carry a third element, a
    prediction (``auto_prediction``) made before each run from the built
    model and the prompts, which then replaces its launch counts and holds
    the routes too.  Returns the launch counts per path ("<group> <mode>")
    and one summary per path."""
    from repro_torch.kernels._launch import count_name
    groups = groups or granite_mode_groups()
    t0 = time.perf_counter()
    policy = next(iter(groups.values()))[0]
    params = build_model(cfg, ParallelConfig(**policy("native")),
                         device=dev).init_params(0)
    torch.cuda.synchronize()
    log(f"mode paths: {cfg.name} at full width, {cfg.num_layers} layers, "
        f"bf16, random weights from seed 0, init "
        f"{time.perf_counter() - t0:.1f} s")
    pool = {}
    if common is not None:
        quantize_in_place(params, common)
        bf16_policy = {k: v for k, v in policy("native").items()
                       if k not in ("weight_precision", "kv_cache_int8")}
        bf16 = Engine(build_model(cfg, ParallelConfig(**bf16_policy),
                                  device=dev), params, ServeConfig(
            batch_slots=SLOTS, max_seq_len=MAX_LEN, eos_id=-1,
            page_size=page_size))
        pool = dict(kv_pool_bytes=bf16.num_pages * bf16.page_footprint_bytes())
        bf16_pages = bf16.num_pages
        del bf16
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        log(f"mode paths: wqkv/wo/wig quantized to int8 on the card; "
            f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB "
            f"allocated; pools sized by a bf16 pool of {bf16_pages} pages "
            f"of {page_size} ({pool['kv_pool_bytes']} bytes)")
    rng = np.random.default_rng(seed)
    lens = rng.integers(128, 513, 12)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, n)]
               for n in lens]
    if page_size is not None:
        prompts[1][:page_size] = prompts[0][:page_size]  # one shared page
    paths, summary = {}, {}
    first = torch.tensor([prompts[0]], dtype=torch.int32, device=dev)
    for group, spec in groups.items():
        policy, launches = spec[:2]
        predict = spec[2] if len(spec) > 2 else None
        native_tokens = native_logits = None
        for mode in ("native",) + tuple(modes):
            what = f"{group} {mode}"
            model = build_model(cfg, ParallelConfig(**policy(mode)),
                                device=dev)
            expect = (predict(mode, model, prompts, page_size, what)
                      if predict else None)
            eng = Engine(model, params, ServeConfig(
                batch_slots=SLOTS, max_seq_len=MAX_LEN, eos_id=-1,
                page_size=page_size, max_new_tokens=NEW_TOKENS, **pool))
            if pool:
                check(eng.num_pages == pool["kv_pool_bytes"]
                      // eng.page_footprint_bytes(),
                      f"{what}: int8 pool not sized by the byte budget")
                log(f"{what} pages from the budget: int8 {eng.num_pages} "
                    f"pages of {eng.page_footprint_bytes()} bytes against "
                    f"bf16 {bf16_pages}, ratio "
                    f"{eng.num_pages / bf16_pages:.3f}")
            reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
                    for i, p in enumerate(prompts)]
            fused.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = eng.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(fused.LAUNCHES)
            check(len(done) == 12 and all(r.done and not r.rejected
                                          for r in done),
                  f"{what}: not every request finished")
            check(all(len(r.generated) == NEW_TOKENS and
                      all(0 <= t < cfg.vocab_size for t in r.generated)
                      for r in done), f"{what}: wrong generated tokens")
            hits = None if page_size is None else eng.pool.shared_hits
            check(hits is None or hits >= 1, f"{what}: the shared prefix "
                  f"was not shared")
            n_gen = sum(len(r.generated) for r in done)
            log(f"{what}: 12 requests, {n_gen} tokens generated in "
                f"{wall:.3f} s = {n_gen / wall:.1f} tokens/s (prefill "
                f"included), {eng.tick_count} ticks, shared_prefix_hits "
                f"{hits}")
            log(f"{what} launches: {json.dumps(counts)}")
            if expect is not None:
                check_prediction(counts, expect(eng.tick_count), what)
            else:
                check_launches(counts, launches(
                    mode, cfg.num_layers, len(done), eng.tick_count), what)
            if routes is not None:
                routes(mode, len(done), eng.tick_count, what)
            row_norm_routes(counts, what)
            if any(v for k, v in counts.items() if k.startswith("ssd_scan")):
                ssd_scan_routes("tc", what, counts)
            if common is not None:
                tied_head_routes(mode, cfg.num_layers, len(done),
                                 eng.tick_count, what,
                                 kernel="rmsnorm_matmul_q8")
                counts[head_key(count_name("rmsnorm_matmul_q8", mode))] = \
                    len(done) + eng.tick_count
            elif cfg.tie_embeddings:
                tied_head_routes(mode, cfg.num_layers, len(done),
                                 eng.tick_count, what)
            tokens = {r.rid: list(r.generated) for r in done}
            logits, _ = model.prefill(params, {"tokens": first})
            check(logits.shape == (1, cfg.vocab_size)
                  and bool(torch.isfinite(logits).all()), f"{what}: "
                  f"non-finite logits")
            if native_tokens is None:
                native_tokens, native_logits = tokens, logits
            same = sum(a == b for rid, gen in tokens.items()
                       for a, b in zip(gen, native_tokens[rid]))
            # where each request first leaves native's tokens (NEW_TOKENS:
            # never)
            diverge = [next((i for i, (a, b) in enumerate(zip(
                gen, native_tokens[rid])) if a != b), NEW_TOKENS)
                for rid, gen in tokens.items()]
            top2 = native_logits[0].topk(2).values
            logit_rms = float(torch.linalg.vector_norm(logits - native_logits)
                              / torch.linalg.vector_norm(native_logits))
            tick_ms, busy = measure_tick(eng, Request, prompts, what)
            torch.cuda.set_sync_debug_mode("error")
            try:
                eng.step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            log(f"{what}: one decode tick under set_sync_debug_mode('error')"
                f": no host sync")
            paths[what] = counts
            summary[what] = dict(
                tick_ms=tick_ms, busy_ms=busy,
                idle_share=None if busy is None
                else max(0.0, 1 - busy / tick_ms),
                tokens_per_s=n_gen / wall, prefill_and_run_s=wall,
                tokens_equal_to_native=same / n_gen,
                first_divergence=sorted(diverge),
                prefill_logits_rel_rms_vs_native=logit_rms)
            if pool:
                summary[what].update(int8_pages=eng.num_pages,
                                     bf16_pages=bf16_pages)
            log(f"{what}: tokens equal to native's at {same} of {n_gen} "
                f"positions ({same / n_gen:.3f}); each request first differs "
                f"at token {sorted(diverge)} ({NEW_TOKENS}: never); prefill "
                f"logits of request 0 within relative RMS {logit_rms:.3g} of "
                f"native's (native's top-2 gap "
                f"{float(top2[0] - top2[1]):.4g})")
            if baseline is not None:
                label, base = baseline
                same_b = sum(a == b for rid, gen in tokens.items()
                             for a, b in zip(gen, base[rid]))
                summary[what]["tokens_equal_to_baseline"] = same_b / n_gen
                log(f"{what}: tokens equal to {label}'s at {same_b} of "
                    f"{n_gen} positions ({same_b / n_gen:.3f})")
            del eng, model
            torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    log(f"mode paths summary: {json.dumps(summary)}")
    return paths, summary


# --------------------------------------------------------------------------
# phases 8-9: the mamba path
# --------------------------------------------------------------------------


def mamba_reference_check(build_model, ParallelConfig, get_reduced, Engine,
                          Request, ServeConfig, dev, policies=None):
    """mamba2-2.7b-reduced (f32) under each of ``policies`` (label ->
    ParallelConfig fields; the fused policy by default), one parameter set:
    the SSD kernels (and, under a mode, the norms) on the card vs the plain
    versions on the CPU; tokens equal, prefill logits within 1e-3."""
    policies = policies or {"fused": dict(fuse_epilogues=True)}
    cfg = get_reduced("mamba2-2.7b")
    params_cpu = build_model(cfg, ParallelConfig(fuse_epilogues=True),
                             device="cpu").init_params(0)
    params_gpu = _to_device(params_cpu, dev)
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, n)]
               for n in (9, 40, 5, 23)]
    toks = torch.tensor([prompts[1]], dtype=torch.int32)
    from repro_torch.kernels._launch import ROUTE_LAUNCHES
    for label, pol in policies.items():
        before = dict(ROUTE_LAUNCHES)
        par = ParallelConfig(**pol)
        cpu_model = build_model(cfg, par, device="cpu")
        gpu_model = build_model(cfg, par, device=dev)
        want, _ = cpu_model.prefill(params_cpu, {"tokens": toks})
        got, _ = gpu_model.prefill(params_gpu, {"tokens": toks.to(dev)})
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-3, atol=1e-3)
        runs = []
        for model, params in ((cpu_model, params_cpu),
                              (gpu_model, params_gpu)):
            eng = Engine(model, params, ServeConfig(
                batch_slots=2, max_seq_len=64, eos_id=-1))
            done = eng.run([Request(rid=i, prompt=list(p), max_new_tokens=8)
                            for i, p in enumerate(prompts)])
            runs.append({r.rid: r.generated for r in done})
        check(runs[0] == runs[1], f"reduced mamba engine tokens differ "
              f"under {label}: {runs}")
        ssd_scan_routes("fma", f"mamba reference check ({label})",
                        before=before)
        log(f"mamba reference check ({label}): {cfg.name} f32, "
            f"{len(prompts)} requests, card tokens == CPU tokens, prefill "
            f"logits within 1e-3")


def serve_mamba_path(fused, build_model, ParallelConfig, cfg, Engine,
                     Request, ServeConfig, dev):
    """mamba2-2.7b at full width and depth through the dense-state engine:
    12 requests, then the tick at 8 live slots, a profile, and one tick
    with host syncs forbidden.  Returns the launch counts and the generated
    tokens by request (phase 25 serves the same prompts)."""
    t0 = time.perf_counter()
    model = build_model(cfg, ParallelConfig(fuse_epilogues=True), device=dev)
    params = model.init_params(0)
    torch.cuda.synchronize()
    log(f"mamba path: {cfg.name} at full width, {cfg.num_layers} layers, "
        f"bf16, random weights from seed 0, init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(5)
    lens = rng.integers(128, 513, 12)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, n)]
               for n in lens]
    eng = Engine(model, params, ServeConfig(
        batch_slots=SLOTS, max_seq_len=MAX_LEN, eos_id=-1,
        max_new_tokens=NEW_TOKENS))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    fused.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fused.LAUNCHES)
    check(len(done) == 12 and all(r.done and not r.rejected for r in done),
          "mamba path: not every request finished")
    check(all(len(r.generated) == NEW_TOKENS and
              all(0 <= t < cfg.vocab_size for t in r.generated)
              for r in done), "mamba path: wrong generated tokens")
    n_gen = sum(len(r.generated) for r in done)
    log(f"mamba path: 12 requests, prompts {int(lens.min())}-"
        f"{int(lens.max())} tokens ({int(lens.sum())} total), {n_gen} tokens "
        f"generated in {wall:.3f} s = {n_gen / wall:.1f} tokens/s (prefill "
        f"included), {eng.tick_count} ticks")
    log(f"mamba path launches: {json.dumps(counts)}")
    want = {"ssd_scan": cfg.num_layers * len(done),
            "ssd_decode": cfg.num_layers * eng.tick_count}
    for name, n in want.items():
        check(counts[name] > 0, f"{name} never launched on the mamba path")
        check(counts[name] == n, f"{name}: {counts[name]} launches, "
              f"expected {n} (one per layer per "
              f"{'prefill' if name == 'ssd_scan' else 'tick'})")
    log(f"mamba path launch counts as expected: ssd_scan = {cfg.num_layers}"
        f" x {len(done)} prefills, ssd_decode = {cfg.num_layers} x "
        f"{eng.tick_count} ticks")
    ssd_scan_routes("tc", "mamba path", counts)
    measure_tick(eng, Request, prompts, "mamba path")
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("mamba path: one decode tick under set_sync_debug_mode('error'): "
        "no host sync")
    logits, cache = model.prefill(params, {"tokens": torch.tensor(
        [prompts[0]], dtype=torch.int32, device=dev)})
    check(logits.shape == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all())
          and bool(torch.isfinite(cache["h"]).all()),
          "mamba path: non-finite logits or state")
    tokens = {r.rid: list(r.generated) for r in done}
    del eng, params, model, cache
    torch.cuda.empty_cache()
    return counts, tokens


# --------------------------------------------------------------------------
# phases 12-14: granite-moe-3b-a800m under P1 and P2
# --------------------------------------------------------------------------


def moe_reference_check(build_model, ParallelConfig, get_reduced, Engine,
                        Request, ServeConfig, dev):
    """granite-moe-3b-a800m-reduced (f32): the kernels on the card vs the
    plain versions on the CPU, under P1 and under P2, with one parameter
    set (drawn under P1's layout)."""
    cfg = get_reduced("granite-moe-3b-a800m")
    params_cpu = build_model(cfg, ParallelConfig(**MOE_POLICIES["P1"]),
                             device="cpu").init_params(0)
    params_gpu = _to_device(params_cpu, dev)
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, n)]
               for n in (70, 83, 9, 66)]
    prompts[1][:16] = prompts[0][:16]                  # two shared pages
    toks = torch.tensor([prompts[0]], dtype=torch.int32)
    for label, pol in MOE_POLICIES.items():
        par = ParallelConfig(**pol)
        cpu_model = build_model(cfg, par, device="cpu")
        gpu_model = build_model(cfg, par, device=dev)
        want, _ = cpu_model.prefill(params_cpu, {"tokens": toks})
        got, _ = gpu_model.prefill(params_gpu, {"tokens": toks.to(dev)})
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=2e-4, atol=2e-4)
        from repro_torch.kernels._launch import ROUTE_LAUNCHES
        before = dict(ROUTE_LAUNCHES)
        runs = []
        for model, params in ((cpu_model, params_cpu),
                              (gpu_model, params_gpu)):
            eng = Engine(model, params, ServeConfig(
                batch_slots=2, max_seq_len=112, eos_id=-1, page_size=8))
            done = eng.run([Request(rid=i, prompt=list(p), max_new_tokens=8)
                            for i, p in enumerate(prompts)])
            runs.append({r.rid: r.generated for r in done})
        check(runs[0] == runs[1],
              f"reduced granite-moe engine tokens differ under {label}: {runs}")
        norm_gemm_routes(before, f"granite-moe reference check ({label})")
        attention_routes(before, f"granite-moe reference check ({label})")
        log(f"granite-moe reference check ({label}): granite-moe-3b-a800m-"
            f"reduced f32, {len(prompts)} requests, card tokens == CPU "
            f"tokens, prefill logits within 2e-4")


def moe_expected_launches(label: str, layers: int, prefills: int,
                          ticks: int, mode: str = "native"):
    """Every kernel's launches on the granite-moe path, per policy: P1
    fuses ln1 and the head into rmsnorm_matmul, ln2 into add_rmsnorm (the
    router-only MoE has no [wi|wg]), attention into the attention + wo
    kernels; P2 runs every norm through rmsnorm (ln1, ln2, the final
    norm) and prefill attention through flash_attention.  Under a mode
    each counts under its mode's name."""
    from repro_torch.kernels._launch import count_name
    c = functools.partial(count_name, mode=mode)
    if label == "P1":
        return {c("rmsnorm_matmul"): (layers + 1) * (prefills + ticks),
                c("add_rmsnorm"): layers * (prefills + ticks),
                c("flash_attention_matmul"): layers * prefills,
                c("paged_attention_matmul"): layers * ticks}
    return {c("rmsnorm"): (2 * layers + 1) * (prefills + ticks),
            c("flash_attention"): layers * prefills}


def serve_moe_path(fused, build_model, ParallelConfig, cfg, params, label,
                   Engine, Request, ServeConfig, dev):
    """granite-moe-3b-a800m at full width and depth through the paged
    engine under ``label``'s policy: 12 requests, exact launch counts,
    then the tick at 8 live slots, a profile, and one tick with host syncs
    forbidden."""
    model = build_model(cfg, ParallelConfig(**MOE_POLICIES[label]),
                        device=dev)
    rng = np.random.default_rng(6)
    lens = rng.integers(128, 513, 12)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, n)]
               for n in lens]
    prompts[1][:PAGE] = prompts[0][:PAGE]              # one shared page
    eng = Engine(model, params, ServeConfig(
        batch_slots=SLOTS, max_seq_len=MAX_LEN, eos_id=-1, page_size=PAGE,
        max_new_tokens=NEW_TOKENS))
    reqs = [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS)
            for i, p in enumerate(prompts)]
    what = f"granite-moe {label}"
    fused.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fused.LAUNCHES)
    check(len(done) == 12 and all(r.done and not r.rejected for r in done),
          f"{what}: not every request finished")
    check(all(len(r.generated) == NEW_TOKENS and
              all(0 <= t < cfg.vocab_size for t in r.generated)
              for r in done), f"{what}: wrong generated tokens")
    check(eng.pool.shared_hits >= 1, f"{what}: the shared prefix was not "
          f"shared")
    n_gen = sum(len(r.generated) for r in done)
    log(f"{what}: 12 requests, prompts {int(lens.min())}-{int(lens.max())} "
        f"tokens ({int(lens.sum())} total), {n_gen} tokens generated in "
        f"{wall:.3f} s = {n_gen / wall:.1f} tokens/s (prefill included), "
        f"{eng.tick_count} ticks, shared_prefix_hits {eng.pool.shared_hits}")
    log(f"{what} launches: {json.dumps(counts)}")
    check_launches(counts, moe_expected_launches(
        label, cfg.num_layers, len(done), eng.tick_count), what)
    row_norm_routes(counts, what)
    tied_head_routes("native", cfg.num_layers, len(done), eng.tick_count,
                     what)
    measure_tick(eng, Request, prompts, what)
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"{what}: one decode tick under set_sync_debug_mode('error'): no "
        f"host sync")
    logits, _ = model.prefill(params, {"tokens": torch.tensor(
        [prompts[0]], dtype=torch.int32, device=dev)})
    check(logits.shape == (1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), f"{what}: non-finite "
          f"logits")
    del eng, model
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------------
# phases 21-22: granite-moe-3b-a800m under the abstract and abstract+shuffle
# modes, fused (P1) and unfused (P2)
# --------------------------------------------------------------------------


def moe_mode_groups():
    """granite-moe's mode runs: P1 and P2, each with every kernel in the
    run's mode (phases 21-22)."""
    return {f"moe@{MODE_PAGE} {label}": (
        lambda mode, label=label: dict(MOE_POLICIES[label], isa_mode=mode),
        lambda mode, *counts, label=label: moe_expected_launches(
            label, *counts, mode=mode)) for label in MOE_POLICIES}


# --------------------------------------------------------------------------
# phases 23-25: mamba2-2.7b under the abstract and abstract+shuffle modes
# --------------------------------------------------------------------------


def mamba_mode_policy(mode: str) -> dict:
    """The fused policy with every kernel of the mamba path in ``mode``."""
    return dict(isa_mode=mode, fuse_epilogues=True)


def mamba_expected_launches(mode: str, layers: int, prefills: int,
                            ticks: int):
    """Every kernel's launches on the mamba path under ``mode``: the scan
    once per layer per prefill, the decode recurrence once per layer per
    tick, and rmsnorm for each layer's input norm and gated norm and for the
    final norm, per prefill and per tick, each under its mode's name."""
    from repro_torch.kernels._launch import count_name
    c = functools.partial(count_name, mode=mode)
    return {c("ssd_scan"): layers * prefills,
            c("ssd_decode"): layers * ticks,
            c("rmsnorm"): (2 * layers + 1) * (prefills + ticks)}


def mamba_mode_groups():
    """mamba2-2.7b's mode runs: one group, the fused policy."""
    return {MAMBA_GROUP: (mamba_mode_policy, mamba_expected_launches)}


# --------------------------------------------------------------------------
# phases 26-29: the int8 path under the abstract and abstract+shuffle modes
# --------------------------------------------------------------------------


def int8_mode_groups():
    """granite-8b's int8 runs in each mode: one group, the int8 policy."""
    return {INT8_GROUP: (int8_mode_policy, lambda mode, *counts:
                         int8_expected_launches(*counts, mode=mode))}


def moe_int8_expected_launches(mode: str, layers: int, prefills: int,
                               ticks: int):
    """Every kernel's launches on granite-moe's path under P1 + int8 in
    ``mode``: P1's kernels, with ln1 -> wqkv and the tied head (the f32
    table quantized per call) through rmsnorm_matmul_q8 and attention + wo
    through the q8 attention kernel; add_rmsnorm has no int8 twin."""
    from repro_torch.kernels._launch import count_name
    c = functools.partial(count_name, mode=mode)
    return {c("rmsnorm_matmul_q8"): (layers + 1) * (prefills + ticks),
            c("add_rmsnorm"): layers * (prefills + ticks),
            c("flash_attention_matmul_q8"): layers * prefills,
            c("paged_attention_matmul_q8"): layers * ticks}


def moe_int8_mode_groups():
    """granite-moe's int8 runs in each mode: P1 with int8 weights and the
    int8 KV cache."""
    return {MOE_INT8_GROUP: (
        lambda mode: dict(MOE_POLICIES["P1"], isa_mode=mode,
                          weight_precision="int8", kv_cache_int8=True),
        moe_int8_expected_launches)}


# --------------------------------------------------------------------------
# phases 30-34: the hybrid family (zamba2-1.2b) and the cell router
# --------------------------------------------------------------------------

#: zamba2-1.2b's runs under each mode (phase 32) and its pass under
#: ``use_pallas_attn`` alone (phase 33)
HYBRID_GROUP, HYBRID_ATTN = "hybrid", "hybrid attn"
HYBRID_POLICIES = {"fused": dict(fuse_epilogues=True, use_pallas_attn=True),
                   "pallas_attn": dict(use_pallas_attn=True)}


def hybrid_kernel_cases(fused, rmsnorm, attention, ssd, dev, cfg):
    """The kernels at zamba2-1.2b's serving shapes, native, bf16: the shared
    block's norm-GEMMs (ln1 -> wqkv [2048, 6144], ln2 -> [wi|wg] [2048,
    16384]) at a decode tick (8 rows, the GEMV) and prefills of 300 and 512
    rows (the tensor cores), its causal attention + wo (32/32 heads x 64,
    group 1, wo [2048, 2048]) at 512 and 300 tokens and the same attention
    without wo (flash_attention, the prefill under ``use_pallas_attn``
    alone), all on the tensor cores; the SSD scan (64 heads x 64, N 64) and
    decode recurrence as phase 7 takes mamba2's; rmsnorm at d_model 2048 and
    d_inner 4096 as phase 23 takes mamba2's.  Each row counts on the
    hybrid's native run (phase 32), flash_attention on phase 33's pass."""
    import torch.nn.functional as F
    native = f"{HYBRID_GROUP} native"
    keep = {f"{op}{sfx}" for op in ("rmsnorm_matmul", "rmsnorm_swiglu")
            for sfx in ("", "_prefill300", "_prefill512")}
    keep |= {"flash_attention_matmul", "flash_attention_matmul_prefill300"}
    cases = [dict(c, name=f"{c['name']}_zamba2", path=native)
             for c in kernel_cases(fused, dev, cfg) if c["name"] in keep]
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    for name, sq in (("flash_attention_zamba2", 512),
                     ("flash_attention_prefill300_zamba2", 300)):
        q, k, v = (torch.randn(1, n, sq, hd, generator=g, device=dev
                               ).to(torch.bfloat16) for n in (h, hkv, hkv))
        cases.append(dict(
            name=name, counter="flash_attention", path=HYBRID_ATTN,
            route="tc",
            shape=f"causal B=1, {h}/{hkv} heads x {hd}, {sq} tokens bf16",
            kernel=lambda q=q, k=k, v=v: attention.flash_attention(
                q, k, v, causal=True),
            plain=lambda q=q, k=k, v=v: attention.flash_attention_plain(
                q, k, v, causal=True),
            library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True),
            bytes=2 * (2 * q.numel() + k.numel() + v.numel()),
            flops=h * (sq * (sq + 1) // 2) * 4 * hd,
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/attention.py:222"))
    return (cases
            + ssd_kernel_cases(ssd, dev, cfg, suffix="_zamba2", path=native)
            + mamba_norm_cases(rmsnorm, dev, cfg, tag="zamba2", path=native))


def hybrid_reference_check(build_model, ParallelConfig, get_reduced, Engine,
                           Request, ServeConfig, dev):
    """zamba2-1.2b-reduced (f32), one parameter set (drawn under the fused
    policy's layout), under the fused policy and under ``use_pallas_attn``
    alone: the kernels on the card vs the plain versions on the CPU, served
    by the dense engine; tokens equal, prefill logits within 1e-3 (the scan
    carries f32 state across chunks); under the fused policy every f32 scan
    on "fma" and every decode norm-GEMM on the GEMV; under
    ``use_pallas_attn`` flash_attention alone launches."""
    from repro_torch.kernels._launch import LAUNCHES, ROUTE_LAUNCHES
    cfg = get_reduced("zamba2-1.2b")
    params_cpu = build_model(cfg, ParallelConfig(**HYBRID_POLICIES["fused"]),
                             device="cpu").init_params(0)
    params_gpu = _to_device(params_cpu, dev)
    rng = np.random.default_rng(16)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, n)]
               for n in (9, 40, 5, 23)]
    toks = torch.tensor([prompts[1]], dtype=torch.int32)
    for label, pol in HYBRID_POLICIES.items():
        what = f"hybrid reference check ({label})"
        before, launched = dict(ROUTE_LAUNCHES), dict(LAUNCHES)
        par = ParallelConfig(**pol)
        cpu_model = build_model(cfg, par, device="cpu")
        gpu_model = build_model(cfg, par, device=dev)
        want, _ = cpu_model.prefill(params_cpu, {"tokens": toks})
        got, _ = gpu_model.prefill(params_gpu, {"tokens": toks.to(dev)})
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-3, atol=1e-3)
        runs = []
        for model, params in ((cpu_model, params_cpu),
                              (gpu_model, params_gpu)):
            eng = Engine(model, params, ServeConfig(
                batch_slots=2, max_seq_len=64, eos_id=-1))
            done = eng.run([Request(rid=i, prompt=list(p), max_new_tokens=8)
                            for i, p in enumerate(prompts)])
            runs.append({r.rid: r.generated for r in done})
        check(runs[0] == runs[1], f"{what}: engine tokens differ: {runs}")
        ran = {k: n - launched.get(k, 0) for k, n in LAUNCHES.items()
               if n > launched.get(k, 0)}
        log(f"{what}: card launches {json.dumps(ran)}")
        if label == "fused":
            ssd_scan_routes("fma", what, before=before)
            norm_gemm_routes(before, what)
        else:
            check(set(ran) == {"flash_attention"}, f"{what}: launched "
                  f"{sorted(ran)}, not flash_attention alone")
        log(f"{what}: {cfg.name} f32, {len(prompts)} requests, card tokens "
            f"== CPU tokens, prefill logits within 1e-3")


def hybrid_expected_launches(mode: str, layers: int, prefills: int,
                             ticks: int, apps: int):
    """Every kernel's launches on the hybrid path under ``mode``: the mamba
    layers' as on the mamba path (the scan and the decode recurrence a
    layer, rmsnorm for each layer's input norm and gated norm and for the
    final norm), and per application of the shared block ln1 -> wqkv and
    ln2 -> [wi|wg] in a prefill and a tick and the causal attention + wo in
    a prefill (its decode attention is plain PyTorch)."""
    from repro_torch.kernels._launch import count_name
    c = functools.partial(count_name, mode=mode)
    return {c("ssd_scan"): layers * prefills,
            c("ssd_decode"): layers * ticks,
            c("rmsnorm"): (2 * layers + 1) * (prefills + ticks),
            c("rmsnorm_matmul"): apps * (prefills + ticks),
            c("rmsnorm_swiglu"): apps * (prefills + ticks),
            c("flash_attention_matmul"): apps * prefills}


def hybrid_mode_groups(cfg):
    """zamba2-1.2b's mode runs: one group, the fused policy in each mode."""
    apps = cfg.num_layers // cfg.hybrid.attn_every
    return {HYBRID_GROUP: (mode_policy, lambda mode, *counts:
                           hybrid_expected_launches(mode, *counts,
                                                    apps=apps))}


def hybrid_routes(cfg):
    """The check of a hybrid run's launches by route (``ROUTE_LAUNCHES``
    holds the run alone): each prefill's norm-GEMMs and attention + wo on
    the tensor cores, each tick's norm-GEMMs on the decode GEMV."""
    from repro_torch.kernels._launch import ROUTE_LAUNCHES, count_name
    apps = cfg.num_layers // cfg.hybrid.attn_every

    def hold(mode, prefills, ticks, what):
        c = functools.partial(count_name, mode=mode)
        gemm = {"tc": apps * prefills, "gemv": apps * ticks}
        for counter, want in ((c("rmsnorm_matmul"), gemm),
                              (c("rmsnorm_swiglu"), gemm),
                              (c("flash_attention_matmul"),
                               {"tc": apps * prefills})):
            routes = {r: n for (k, r), n in ROUTE_LAUNCHES.items()
                      if k == counter}
            log(f"{what}: {counter} launches by route "
                f"{json.dumps(dict(sorted(routes.items())))}")
            check(routes == want, f"{what}: {counter} routes {routes}, not "
                  f"{want}")
    return hold


def serve_hybrid_attn_pass(fused, build_model, ParallelConfig, cfg, Engine,
                           Request, ServeConfig, dev):
    """zamba2-1.2b at full width and depth under ``use_pallas_attn`` alone
    (random weights from seed 0, bf16; the norms and the SSD in plain
    PyTorch, each prefill's attention on the flash_attention kernel): 8
    requests of 128-256 prompt tokens, 8 new each, on 8 slots;
    flash_attention once an application a prefill, each on the tensor
    cores, and no other kernel; one tick with host syncs forbidden."""
    from repro_torch.kernels._launch import ROUTE_LAUNCHES
    what = "hybrid pallas_attn pass"
    model = build_model(cfg, ParallelConfig(**HYBRID_POLICIES["pallas_attn"]),
                        device=dev)
    params = model.init_params(0)
    rng = np.random.default_rng(17)
    reqs = [Request(rid=i, prompt=[int(t) for t in rng.integers(
        2, cfg.vocab_size, int(n))], max_new_tokens=8)
        for i, n in enumerate(rng.integers(128, 257, SLOTS))]
    eng = Engine(model, params, ServeConfig(
        batch_slots=SLOTS, max_seq_len=MAX_LEN, eos_id=-1))
    fused.reset_launch_counts()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    counts = dict(fused.LAUNCHES)
    check(all(r.done and len(r.generated) == 8 for r in done),
          f"{what}: not every request finished")
    n = model.n_apps * len(done)
    check_launches(counts, {"flash_attention": n}, what)
    routes = {r: k for (c, r), k in ROUTE_LAUNCHES.items()
              if c == "flash_attention"}
    log(f"{what}: flash_attention launches by route {json.dumps(routes)}")
    check(routes == {"tc": n}, f"{what}: flash_attention routes {routes}, "
          f"not {{'tc': {n}}}")
    check(eng.admit([Request(rid=99, prompt=[5, 6, 7], max_new_tokens=16)])
          == 1, f"{what}: sync probe admission failed")
    eng.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"{what}: one decode tick under set_sync_debug_mode('error'): no "
        f"host sync")
    del eng, params, model
    torch.cuda.empty_cache()
    return counts


def serve_router(fused, build_model, ParallelConfig, cfg, Engine, Request,
                 ServeConfig, make_cells, dev, layers: int = 4):
    """Two cells of granite-8b at full width and ``layers`` layers (the
    dense pass's depth; random weights from seed 1, bf16), each paged at
    64 keys a page on 8 slots, behind a CellRouter: 12 requests (128-512
    prompt tokens, two sharing two pages, 16 new each) must give the tokens
    of one engine of 8 slots serving them alone (each cell's batch has that
    engine's shapes, so each row's sums run in its order); each request's
    cell logged; exact launch counts (every cell ticks on every router
    tick); one router tick under ``set_sync_debug_mode("error")``; the
    fleet's harvest one device->host copy.  Returns the launch counts."""
    what = "router"
    cut = dataclasses.replace(cfg, num_layers=layers)
    model = build_model(cut, main_path_policy(ParallelConfig), device=dev)
    params = model.init_params(1)
    rng = np.random.default_rng(18)
    lens = rng.integers(128, 513, 12)
    prompts = [[int(t) for t in rng.integers(2, cfg.vocab_size, n)]
               for n in lens]
    prompts[1][:2 * PAGE] = prompts[0][:2 * PAGE]      # two shared pages
    serve = ServeConfig(batch_slots=SLOTS, max_seq_len=MAX_LEN, eos_id=-1,
                        page_size=PAGE, max_new_tokens=16)

    def requests():
        return [Request(rid=i, prompt=list(p), max_new_tokens=16)
                for i, p in enumerate(prompts)]
    want = {r.rid: r.generated for r in Engine(model, params, serve).run(
        requests())}
    router = make_cells(model, params, serve, 2)
    placed = {}
    for i, cell in enumerate(router.cells):
        def admit(batch, _i=i, _real=cell.admit):
            n = _real(batch)
            placed.update({r.rid: _i for r in batch[:n] if not r.rejected})
            return n
        cell.admit = admit
    fused.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = router.run(requests())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fused.LAUNCHES)
    check(len(done) == 12 and all(r.done and not r.rejected for r in done),
          f"{what}: not every request finished")
    got = {r.rid: r.generated for r in done}
    check(got == want, f"{what}: tokens differ from one engine's: {got} "
          f"against {want}")
    n_gen = sum(len(g) for g in got.values())
    log(f"{what}: 2 cells x {SLOTS} slots, {cut.name} at {layers} layers, "
        f"12 requests, {n_gen} tokens in {wall:.3f} s = {n_gen / wall:.1f} "
        f"tokens/s (prefill included), {router.tick_count} router ticks; "
        f"tokens == one engine's")
    log(f"{what}: cell of each request {json.dumps(placed)}; cell_stats "
        f"{json.dumps(router.cell_stats())}")
    check(set(placed.values()) == {0, 1}, f"{what}: one cell took every "
          f"request")
    check(placed[1] == placed[0], f"{what}: the shared prefix left its cell")
    check_launches(counts, mode_expected_launches(
        "native", layers, len(done), 2 * router.tick_count), what)
    more = [Request(rid=100 + i, prompt=prompts[i][:128], max_new_tokens=16)
            for i in range(4)]
    check(router.admit(more) == 4, f"{what}: sync probe admission failed")
    router.step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        router.step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    copies, real_cpu = [], torch.Tensor.cpu
    torch.Tensor.cpu = lambda t, *a, **k: (copies.append(tuple(t.shape))
                                           or real_cpu(t, *a, **k))
    try:
        router.sync()
    finally:
        torch.Tensor.cpu = real_cpu
    check(len(copies) == 1, f"{what}: the harvest made {len(copies)} "
          f"copies to the host, not one")
    log(f"{what}: one router tick under set_sync_debug_mode('error'): no "
        f"host sync; the fleet's harvest one copy of {copies[0]} int32")
    del router, params, model
    torch.cuda.empty_cache()
    return counts


# --------------------------------------------------------------------------
# phases 35-37: auto, on Hopper and on foreign dialects
# --------------------------------------------------------------------------

#: the labels of the auto runs: granite-8b at full depth (phase 35), at 4
#: layers on each foreign dialect (phase 36), mamba2-2.7b (phase 37)
AUTO_GROUP, AUTO_MAMBA_GROUP = f"granite auto@{MODE_PAGE}", "mamba auto"
AUTO_FOREIGN = ("uisa-universal10", "nvidia-ada-sm89")
AUTO_FOREIGN_LAYERS = 4


def auto_policy(dialect=None, fused=True):
    """mode -> policy of an auto group: ``ParallelConfig(isa_mode="auto",
    ...)`` under ``dialect`` with ``fuse_epilogues`` left None (auto
    fuses); its native run is the fused policy on Hopper.  ``fused``: the
    granite-8b policy (with ``use_pallas_attn``), else mamba's."""
    def policy(mode):
        if mode == "auto":
            return dict(isa_mode="auto", isa_dialect=dialect,
                        **({"use_pallas_attn": True} if fused else {}))
        return mode_policy(mode) if fused else mamba_mode_policy(mode)
    return policy


def _norm_route(mode: str) -> str:
    return "vector" if mode == "native" else "element"


def model_calls(cfg, rows: int, prefill: bool, page_size):
    """Every registry dispatch one prefill of ``rows`` tokens (or one tick
    of ``SLOTS`` slots) makes on ``cfg``'s fused path: (op, the shape
    ``kernels/ops.py`` hands the registry, the kernel's counter, its route
    (or a function of the mode; None: the kernel reports none), calls)."""
    n_layers, d = cfg.num_layers, cfg.d_model
    if cfg.family == "ssm":
        s = cfg.ssm
        di = s.expand * d
        heads = di // s.head_dim
        rows = rows if prefill else SLOTS
        calls = [("rmsnorm", dict(rows=rows, d=d), "rmsnorm", _norm_route,
                  n_layers),
                 ("rmsnorm", dict(rows=rows, d=di), "rmsnorm", _norm_route,
                  n_layers),
                 ("rmsnorm", dict(rows=1 if prefill else SLOTS, d=d),
                  "rmsnorm", _norm_route, 1)]
        if prefill:
            return calls + [("ssd_scan", dict(
                b=1, seq=rows, h=heads, p=s.head_dim, g=s.n_groups,
                n=s.state_dim, chunk=s.chunk_size), "ssd_scan", "tc",
                n_layers)]
        return calls + [("ssd_decode", dict(
            b=SLOTS, h=heads, p=s.head_dim, g=s.n_groups, n=s.state_dim,
            block_b=None), "ssd_decode", None, n_layers)]
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rows = rows if prefill else SLOTS
    route = "gemv" if rows <= 16 else "tc"
    calls = [("rmsnorm_matmul", dict(rows=rows, d=d, n=(h + 2 * hkv) * hd),
              "rmsnorm_matmul", route, n_layers),
             ("rmsnorm_swiglu", dict(rows=rows, d=d, f=cfg.d_ff),
              "rmsnorm_swiglu", route, n_layers),
             ("rmsnorm_matmul", dict(rows=1 if prefill else SLOTS, d=d,
                                     n=cfg.vocab_size),
              "rmsnorm_matmul", "gemv", 1)]
    if prefill:
        return calls + [("flash_attention_matmul", dict(
            b=1, h=h, sq=rows, skv=rows, d=hd, n=d, causal=True,
            block_q=None, block_kv=None), "flash_attention_matmul", "tc",
            n_layers)]
    maxp = -(-MAX_LEN // page_size)
    return calls + [("flash_attention_matmul", dict(
        b=SLOTS, h=h, sq=1, skv=maxp * page_size, d=hd, n=d, causal=False,
        block_q=None, block_kv=page_size, page_size=page_size,
        pages_occupied=SLOTS * maxp), "paged_attention_matmul", "decode",
        n_layers)]


def auto_prediction(mode, model, prompts, page_size, what):
    """Before an auto run: ask ``REGISTRY.select`` (the policy the model
    threads, the card as the device) for every (op, shape) the run will
    make, log the picks, and return ``expect(ticks)`` -> {(counter,
    route): launches}.  None for a run outside auto."""
    if mode != "auto":
        return None
    from repro_torch.core import REGISTRY
    from repro_torch.kernels._launch import count_name
    pol = model.policy.kernel()
    check(pol == model.policy, f"{what}: the kernel path has a policy of "
          f"its own")
    picks = {}

    def add(table, op, shape, kernel, route, calls):
        key = (op, tuple(sorted(shape.items())))
        if key not in picks:
            picks[key] = REGISTRY.select(op, pol, shape=shape,
                                         device=model.device).mode.value
        m = picks[key]
        k = (count_name(kernel, m), route(m) if callable(route) else route)
        table[k] = table.get(k, 0) + calls

    fixed, per_tick = {}, {}
    for p in prompts:
        for call in model_calls(model.cfg, len(p), True, page_size):
            add(fixed, *call)
    for call in model_calls(model.cfg, SLOTS, False, page_size):
        add(per_tick, *call)
    by_op = {}
    for (op, shape), m in picks.items():
        by_op.setdefault(op, {}).setdefault(m, 0)
        by_op[op][m] += 1
    log(f"{what} picks (dialect {pol.dialect}, {len(picks)} (op, shape) "
        f"keys, by op and mode): {json.dumps(by_op)}")
    return lambda ticks: {k: fixed.get(k, 0) + ticks * per_tick.get(k, 0)
                          for k in set(fixed) | set(per_tick)}


def check_prediction(counts, expect, what: str) -> None:
    """The run's launches by counter equal the prediction's exactly (no
    other lowering launched), and, for the kernels that report a route,
    by (counter, route) too (``ROUTE_LAUNCHES`` holds the run alone)."""
    from repro_torch.kernels._launch import ROUTE_LAUNCHES
    want = {}
    for (counter, _), n in expect.items():
        want[counter] = want.get(counter, 0) + n
    got = {k: v for k, v in counts.items() if v}
    log(f"{what}: launches {json.dumps(got)} against the prediction "
        f"{json.dumps(want)}")
    check(got == want, f"{what}: launches {got} != predicted {want}")
    routed = {c for (c, r) in expect if r is not None}
    tally = {f"{c} {r}": n for (c, r), n in ROUTE_LAUNCHES.items()
             if c in want}
    want_routes = {f"{c} {r}": n for (c, r), n in expect.items()
                   if c in routed}
    log(f"{what}: launches by route {json.dumps(tally)}")
    check(tally == want_routes, f"{what}: routes {tally} != predicted "
          f"{want_routes}")


def auto_groups(dialect=None):
    """granite-8b's auto group under ``dialect`` (phases 35-36)."""
    label = AUTO_GROUP if dialect is None else f"granite auto {dialect}"
    return {label: (auto_policy(dialect), mode_expected_launches,
                    auto_prediction)}


def mamba_auto_groups():
    return {AUTO_MAMBA_GROUP: (auto_policy(fused=False),
                               mamba_expected_launches, auto_prediction)}


def tuned_chunk_case(ssd, ops_mod, dev, cfg):
    """Phase 37's kernel case: ``ssd_scan(chunk=None)`` at 512 tokens of
    mamba2-2.7b's widths through ``ops.fused_ssd_scan`` under auto on
    Hopper, the chunk resolved as the JAX package resolves it, against the
    plain version of the picked mode at that chunk; counted on phase 37's
    auto run."""
    from repro_torch.core import REGISTRY, ExecutionPolicy, tuning
    from repro_torch.kernels._launch import count_name
    s = cfg.ssm
    h = s.expand * cfg.d_model // s.head_dim
    p, n, g, l = s.head_dim, s.state_dim, s.n_groups, 512
    pol = ExecutionPolicy(mode="auto")
    mode = REGISTRY.select("ssd_scan", pol, shape=dict(
        b=1, seq=l, h=h, p=p, g=g, n=n, chunk=None), device=dev).mode.value
    q = ssd.resolve_chunk(l, None, mode=mode, p=p, n=n,
                          plan_dialect=pol.dialect)
    bucket = tuning.ssd_bucket(l, p, n)
    entry = tuning.tuned_entry("ssd_scan", mode, bucket, pol.dialect)
    log(f"tuned chunk: ssd_scan(chunk=None) at {l} tokens under auto on "
        f"{pol.dialect} picks [{mode}], resolves chunk {q}; table entry "
        f"ssd_scan|{mode}|{pol.dialect}|{bucket}: "
        f"{json.dumps(entry) if entry else 'none (the first candidate of '}"
        f"{'' if entry else json.dumps(tuning.ssd_candidates(l, p, n)[0])}"
        f"{'' if entry else ')'}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    bf = torch.bfloat16
    A = -torch.linspace(1.0, 16.0, h, device=dev)
    dt_bias = torch.log(torch.expm1(torch.linspace(s.dt_min, s.dt_max, h,
                                                   device=dev)))
    x = torch.randn(1, l, h, p, generator=gen, device=dev).to(bf)
    dt = torch.nn.functional.softplus(
        torch.randn(1, l, h, generator=gen, device=dev) + dt_bias)
    B = (torch.randn(1, l, g, n, generator=gen, device=dev)
         * n ** -0.25).to(bf)
    C = (torch.randn(1, l, g, n, generator=gen, device=dev)
         * n ** -0.25).to(bf)
    flops = 0
    for c0 in range(0, l, q):
        m = min(q, l - c0)
        pairs = m * (m + 1) // 2
        flops += 2 * g * pairs * n + 2 * (2 * h * pairs * p) \
            + 2 * (2 * h * m * n * p) * (2 if c0 > 0 else 1)
    return [dict(
        name="ssd_scan_tuned_chunk", counter=count_name("ssd_scan", mode),
        outputs=("y", "state"), route="tc", median=True, mode=mode,
        shape=f"B=1, L={l}, {h} heads x {p}, N={n}, G={g}, chunk=None -> "
              f"{q} [{mode}], bf16 (state f32)",
        kernel=lambda: ops_mod.fused_ssd_scan(x, dt, A, B, C, chunk=None,
                                              policy=pol),
        plain=lambda: ssd.ssd_scan_plain(x, dt, A, B, C, chunk=q, mode=mode),
        path=f"{AUTO_MAMBA_GROUP} auto", library=None,
        library_note="no single PyTorch call computes this function",
        bytes=2 * (2 * l * h * p + 2 * l * g * n) + 4 * (l * h + h
                                                         + h * n * p),
        flops=flops, source="src/repro_torch/csrc/ssd_scan_tc.cu",
        replaces="src/repro/kernels/ssd.py:289")]


# --------------------------------------------------------------------------
# phase 10: Table V
# --------------------------------------------------------------------------

TABLEV_SOURCES = {
    "gemm": ("src/repro_torch/csrc/gemm.cu", "src/repro/kernels/gemm.py:130"),
    "reduction": ("src/repro_torch/csrc/reduction.cu",
                  "src/repro/kernels/reduction.py:95"),
    "histogram": ("src/repro_torch/csrc/histogram.cu",
                  "src/repro/kernels/histogram.py:120"),
}


def tablev_plain_checks(tablev, dev):
    """Every Table V (kernel, mode) against its plain version of the same
    mode, on the same inputs: each of the benchmark's cases at the paper's
    sizes (both held to the stated tolerance, and the plain version timed),
    then ragged sizes.  Returns, per (kernel, mode, case), the max
    |kernel - plain| and the plain version's time."""
    from repro_torch.benchmarks.common import l2_flush_buffer
    from repro_torch.kernels import gemm, histogram, reduction
    inp = tablev.make_inputs(dev, seed=0)
    ref64 = inp["a"].double() @ inp["b"].double()
    flush = l2_flush_buffer(dev)
    sgemm_rms = tablev.gemm_rms(inp["a"] @ inp["b"], ref64)
    out = {}
    for case in tablev.cases(inp):
        got, want = case["fn"](), case["plain"]()
        tablev.check_output(case, got, inp, ref64)
        tablev.check_output(case, want, inp, ref64, " (plain)")
        if case["kernel"] == "gemm":
            rms = tablev.gemm_rms(got, ref64)
            log(f"gemm [{case['mode']}] {case['case']}: relative RMS against "
                f"float64 {rms:.4g}, torch.matmul (SGEMM) {sgemm_rms:.4g}, "
                f"ratio {rms / sgemm_rms:.3f}")
        if case["kernel"] == "histogram":
            check(torch.equal(got, want), f"histogram [{case['mode']}] "
                  f"{case['case']}: kernel and plain differ")
        if case["launch"].get("route") == "persistent":
            check(got.view(torch.int32).item()
                  == want.view(torch.int32).item(),
                  f"reduction [{case['mode']}] {case['case']}: kernel "
                  f"{float(got)!r} and plain {float(want)!r} differ in bits")
        out[(case["kernel"], case["mode"], case["case"])] = dict(
            max_abs_err=float((got.double() - want.double()).abs().max()),
            plain_ms=tablev.time_ms(case["plain"], flush=flush))
        del got, want
    del inp, ref64, flush
    # ragged sizes; at the 2-per-thread tile, bit for bit, twice in a row
    # (native's ticket is reset), on a base off 16 bytes too
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    for n in (999, 70001, (1 << 20) + 3):
        x = torch.randn(n + 1, generator=g, device=dev)
        for xt in (x[:n], x.bfloat16()[:n], (x * 8).to(torch.int32)[:n],
                   x[1:]):
            lim = tablev.REDUCTION_TOL * float(xt.double().abs().sum())
            for mode in reduction.MODES:
                what = f"reduction [{mode}] n={n} {xt.dtype}"
                got = reduction.reduce_sum(xt, mode=mode)
                tablev.check_reduction(got, xt, what)
                check(abs(float(got) - float(reduction.reduce_sum_plain(
                    xt, mode=mode))) <= lim, f"{what}: kernel and plain "
                    f"differ")
                small = [reduction.reduce_sum_kernel(
                    xt, mode, reduction.SMALL_TILE) for _ in range(2)]
                want = reduction.reduce_sum_plain(
                    xt, mode=mode, tile=reduction.SMALL_TILE)
                check(all(s.view(torch.int32).item()
                          == want.view(torch.int32).item() for s in small),
                      f"{what}, tile {reduction.SMALL_TILE}: kernel "
                      f"{[float(s) for s in small]} and plain {float(want)} "
                      f"differ in bits")
    wide = torch.randint(-50, 150, (70001,), generator=g, device=dev,
                         dtype=torch.int32)
    for mode in histogram.MODES:
        for bins in (100, 256):
            what = f"histogram [{mode}] n=70001, {bins} bins, out of range"
            got = histogram.histogram(wide, bins, mode=mode)
            tablev.check_histogram(got, wide, bins, what)
            check(torch.equal(got, histogram.histogram_plain(
                wide, bins, mode=mode)), f"{what}: kernel and plain differ")
    for m, k, n in ((300, 129, 200), (300, 200, 129)):
        a = torch.randn(m, k, generator=g, device=dev)
        b = torch.randn(k, n, generator=g, device=dev)
        r64 = a.double() @ b.double()
        for mode in gemm.MODES:
            what = f"gemm [{mode}] {m}x{k} @ {k}x{n}"
            tablev.check_gemm(gemm.gemm(a, b, mode=mode), r64, what)
            tablev.check_gemm(gemm.gemm_plain(a, b, mode=mode), r64,
                              what + " plain")
    torch.cuda.empty_cache()
    log("table V checks: every (kernel, mode) and its plain version within "
        "tolerance at the paper's and at ragged sizes")
    return out


def tablev_path(tablev, fused, plain, dev):
    """The Table V run with the counts set to 0 just before it and read
    just after; every (kernel, mode) must have launched.  Returns the
    kernels-line rows."""
    fused.reset_launch_counts()
    torch.cuda.synchronize()
    rows = tablev.run(dev, log=log)
    torch.cuda.synchronize()
    counts = dict(fused.LAUNCHES)
    log(f"table V launches: {json.dumps({k: v for k, v in counts.items() if v})}")
    from repro_torch.kernels._launch import ROUTE_LAUNCHES
    log(f"table V reduction launches by route: " + json.dumps(
        {f"{c} {r}": n for (c, r), n in sorted(ROUTE_LAUNCHES.items())
         if c.startswith("reduction")}))
    for r in rows:
        if "2 per thread" in r["case"]:
            launch = r["launch"]
            check(launch["route"] == "persistent"
                  and ROUTE_LAUNCHES.get((r["counter"], "persistent"), 0) > 0,
                  f"{r['counter']}: the 2-per-thread case did not take the "
                  f"persistent route")
            log(f"table V 10d [{r['mode']}]: route {launch['route']}, grid "
                f"{launch['grid']} x {launch['block']}, {launch['passes']} "
                f"launch(es), loads {launch['loads']}, second pass "
                f"{launch['second_pass']}; {r['ms']:.4f} ms, "
                f"{r['pct_of_native']:.1f}% of native, torch.sum "
                f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms")
    out = []
    for r in rows:
        counter = r["counter"]
        check(counts[counter] > 0, f"{counter} never launched in the table "
              f"V run")
        name = counter + ("_tile512" if "2 per thread" in r["case"]
                          else "_one_bin" if "one bin" in r["case"]
                          else "_off16" if "off 16 B" in r["case"] else "")
        source, replaces = TABLEV_SOURCES[r["kernel"]]
        p = plain[(r["kernel"], r["mode"], r["case"])]
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=counts[counter], max_abs_err=p["max_abs_err"],
            ms=r["ms"], plain_ms=p["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["case"], mode=r["mode"],
            pct_of_native=r["pct_of_native"], launch=r["launch"],
            max_abs_err_vs_exact=r["max_abs_err"],
            model_scratch_round_trips_per_block=r["model_round_trips"]))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(src))
    from repro_torch.benchmarks import tablev
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import _build, attention, fused, rmsnorm, ssd
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.models import build_model, common
    from repro_torch.models.attention import quantize_kv
    from repro_torch.models.config import ParallelConfig
    from repro_torch.serve import (BatchedEngine, Request, ServeConfig,
                                   make_cells)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    t_start = t0 = time.perf_counter()
    build_s = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s ({build_s:.1f} s in nvcc) "
        f"into {_build.build_dir()}")
    for name in _build.SOURCES:
        regs = [line.split("Used")[1].strip() for line in
                _build.build_log(name).splitlines() if "Used" in line]
        log(f"ptxas {name}: {'; '.join(regs)}")

    cfg = get_config("granite-8b")
    mcfg = get_config("mamba2-2.7b")
    moe_cfg = get_config("granite-moe-3b-a800m")
    granite_cases = kernel_cases(fused, dev, cfg)
    moe_cases = moe_kernel_cases(fused, rmsnorm, attention, dev, moe_cfg)
    rows = run_kernels(granite_cases
                       + q8_kernel_cases(fused, quantize_kv, dev, cfg)
                       + moe_q8_cases(fused, quantize_kv, dev, moe_cfg)
                       + ssd_kernel_cases(ssd, dev, mcfg) + moe_cases
                       + mode_kernel_cases(granite_cases + moe_cases), dev)
    del granite_cases, moe_cases
    torch.cuda.empty_cache()
    reference_check(build_model, ParallelConfig, get_reduced, BatchedEngine,
                    Request, ServeConfig, dev)
    paged_counts, _, _ = serve_main_path(fused, build_model, ParallelConfig,
                                         cfg, BatchedEngine, Request,
                                         ServeConfig, dev)
    dense_counts = serve_dense_pass(fused, build_model, ParallelConfig, cfg,
                                    BatchedEngine, Request, ServeConfig, dev)
    mamba_reference_check(build_model, ParallelConfig, get_reduced,
                          BatchedEngine, Request, ServeConfig, dev)
    mamba_counts, mamba_tokens = serve_mamba_path(
        fused, build_model, ParallelConfig, mcfg, BatchedEngine, Request,
        ServeConfig, dev)
    moe_reference_check(build_model, ParallelConfig, get_reduced,
                        BatchedEngine, Request, ServeConfig, dev)
    t0 = time.perf_counter()
    moe_cut = dataclasses.replace(moe_cfg, num_layers=MOE_PAGE64_LAYERS)
    moe_params = build_model(moe_cut, ParallelConfig(**MOE_POLICIES["P1"]),
                             device=dev).init_params(0)
    torch.cuda.synchronize()
    log(f"granite-moe path: {moe_cfg.name} at full width, "
        f"{moe_cut.num_layers} of {moe_cfg.num_layers} layers, bf16, random "
        f"weights from seed 0 "
        f"(drawn under P1's layout, served under P1 and P2), init "
        f"{time.perf_counter() - t0:.1f} s")
    paths = {"granite": paged_counts, "dense": dense_counts,
             "mamba": mamba_counts}
    for label in MOE_POLICIES:
        paths[f"moe {label}"] = serve_moe_path(
            fused, build_model, ParallelConfig, moe_cut, moe_params, label,
            BatchedEngine, Request, ServeConfig, dev)
    del moe_params
    torch.cuda.empty_cache()
    torch.set_float32_matmul_precision("highest")
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "the library GEMM must run in full f32")
    plain = tablev_plain_checks(tablev, dev)
    tablev_rows = tablev_path(tablev, fused, plain, dev)
    int8_reference_check(build_model, ParallelConfig, get_reduced, common,
                         BatchedEngine, Request, ServeConfig, dev)
    paths["granite int8"] = serve_int8_path(
        fused, common, build_model, ParallelConfig, cfg, BatchedEngine,
        Request, ServeConfig, dev)
    paths["dense int8"] = serve_dense_pass(
        fused, build_model, ParallelConfig, cfg, BatchedEngine, Request,
        ServeConfig, dev, common=common)
    mode_reference_check(build_model, ParallelConfig, get_reduced,
                         BatchedEngine, Request, ServeConfig, dev)
    mode_paths, _ = serve_mode_paths(fused, build_model, ParallelConfig, cfg,
                                     BatchedEngine, Request, ServeConfig, dev)
    paths.update(mode_paths)
    for mode in MODES:
        paths[f"dense {mode}"] = serve_dense_pass(
            fused, build_model, ParallelConfig, cfg, BatchedEngine, Request,
            ServeConfig, dev, mode=mode)
    mode_reference_check(build_model, ParallelConfig, get_reduced,
                         BatchedEngine, Request, ServeConfig, dev,
                         arch="granite-moe-3b-a800m", groups=moe_mode_groups(),
                         lens=(140, 150, 9, 70), seed=11)
    moe_mode_paths, _ = serve_mode_paths(
        fused, build_model, ParallelConfig, moe_cfg, BatchedEngine, Request,
        ServeConfig, dev, groups=moe_mode_groups(), seed=12)
    paths.update(moe_mode_paths)
    norm_cases = mamba_norm_cases(rmsnorm, dev, mcfg)
    rows += run_kernels(norm_cases + mode_kernel_cases(
        ssd_kernel_cases(ssd, dev, mcfg) + norm_cases), dev)
    del norm_cases
    mamba_reference_check(build_model, ParallelConfig, get_reduced,
                          BatchedEngine, Request, ServeConfig, dev,
                          policies={m: mamba_mode_policy(m) for m in MODES})
    # phase 9's prompts and weights: its run (the norms in the library row)
    # is the baseline that says how far a sum order alone moves the tokens
    mamba_mode_paths, _ = serve_mode_paths(
        fused, build_model, ParallelConfig, mcfg, BatchedEngine, Request,
        ServeConfig, dev, groups=mamba_mode_groups(), seed=5,
        page_size=None, baseline=("phase 9 (library norms)", mamba_tokens))
    paths.update(mamba_mode_paths)
    # phases 26-29: the int8 path in each mode (the q8 twins' abstract and
    # abstract+shuffle kernels, phase 3's inputs rebuilt from their seeds)
    rows += run_kernels(mode_kernel_cases(
        q8_kernel_cases(fused, quantize_kv, dev, cfg)
        + moe_q8_cases(fused, quantize_kv, dev, moe_cfg)), dev)
    mode_reference_check(build_model, ParallelConfig, get_reduced,
                         BatchedEngine, Request, ServeConfig, dev,
                         groups=int8_mode_groups(), seed=13, common=common)
    mode_reference_check(build_model, ParallelConfig, get_reduced,
                         BatchedEngine, Request, ServeConfig, dev,
                         arch="granite-moe-3b-a800m",
                         groups=moe_int8_mode_groups(),
                         lens=(140, 150, 9, 70), seed=14, common=common)
    int8_mode_paths, _ = serve_mode_paths(
        fused, build_model, ParallelConfig, cfg, BatchedEngine, Request,
        ServeConfig, dev, groups=int8_mode_groups(), seed=9, common=common)
    paths.update(int8_mode_paths)
    for mode in MODES:
        paths[f"dense int8 {mode}"] = serve_dense_pass(
            fused, build_model, ParallelConfig, cfg, BatchedEngine, Request,
            ServeConfig, dev, common=common, mode=mode)
    moe_int8_paths, _ = serve_mode_paths(
        fused, build_model, ParallelConfig, moe_cut, BatchedEngine, Request,
        ServeConfig, dev, groups=moe_int8_mode_groups(), seed=12,
        common=common)
    paths.update(moe_int8_paths)
    # phases 30-34: zamba2-1.2b and the cell router
    zcfg = get_config("zamba2-1.2b")
    rows += run_kernels(hybrid_kernel_cases(fused, rmsnorm, attention, ssd,
                                            dev, zcfg), dev)
    hybrid_reference_check(build_model, ParallelConfig, get_reduced,
                           BatchedEngine, Request, ServeConfig, dev)
    hybrid_paths, _ = serve_mode_paths(
        fused, build_model, ParallelConfig, zcfg, BatchedEngine, Request,
        ServeConfig, dev, groups=hybrid_mode_groups(zcfg), seed=15,
        page_size=None, routes=hybrid_routes(zcfg))
    paths.update(hybrid_paths)
    paths[HYBRID_ATTN] = serve_hybrid_attn_pass(
        fused, build_model, ParallelConfig, zcfg, BatchedEngine, Request,
        ServeConfig, dev)
    paths["router"] = serve_router(fused, build_model, ParallelConfig, cfg,
                                   BatchedEngine, Request, ServeConfig,
                                   make_cells, dev)
    # phases 35-37: auto on Hopper (granite-8b, then mamba2-2.7b) and on
    # foreign dialects (granite-8b at 4 layers), each beside native
    auto_paths, auto_summary = serve_mode_paths(
        fused, build_model, ParallelConfig, cfg, BatchedEngine, Request,
        ServeConfig, dev, groups=auto_groups(), modes=("auto",))
    paths.update(auto_paths)
    cut = dataclasses.replace(cfg, num_layers=AUTO_FOREIGN_LAYERS)
    for dialect in AUTO_FOREIGN:
        foreign, _ = serve_mode_paths(
            fused, build_model, ParallelConfig, cut, BatchedEngine, Request,
            ServeConfig, dev, groups=auto_groups(dialect), modes=("auto",))
        counts = foreign[f"granite auto {dialect} auto"]
        want = "_abstract" if dialect == "uisa-universal10" \
            else "_abstract+shuffle"
        check(all(k.endswith(want) for k, v in counts.items() if v),
              f"auto on {dialect}: a launch outside [{want[1:]}]: {counts}")
        log(f"auto on {dialect}: every launch [{want[1:]}], none native")
        paths.update(foreign)
    mamba_auto, mamba_auto_summary = serve_mode_paths(
        fused, build_model, ParallelConfig, mcfg, BatchedEngine, Request,
        ServeConfig, dev, groups=mamba_auto_groups(), seed=5,
        page_size=None, modes=("auto",),
        baseline=("phase 9 (library norms)", mamba_tokens))
    paths.update(mamba_auto)
    log(f"auto summary: {json.dumps(dict(auto_summary, **mamba_auto_summary))}")
    rows += run_kernels(tuned_chunk_case(ssd, kernel_ops, dev, mcfg), dev)
    tablev.structural_tables(log=log)
    for row in rows:
        counter = row.pop("counter")
        path = row.pop("path") or (
            "dense" if counter == "flash_attention_matmul_pos" else "granite")
        # a head row counts its head's launches, not its op's
        row["launches"] = paths[path][head_key(counter) if row.pop("head")
                                      else counter]
    log(f"run time: {time.perf_counter() - t_start:.1f} s, the build included")
    log(json.dumps({"kernels": rows + tablev_rows}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeFailure, AssertionError, RuntimeError,
            subprocess.SubprocessError) as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
