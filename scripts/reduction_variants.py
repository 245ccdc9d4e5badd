#!/usr/bin/env python3
"""Time and check the Table V reduction at 2 elements a thread (row 10d)
beside variants of its source.

    python scripts/reduction_variants.py [--turns 2] [--only NAME ...]

Builds ``src/repro_torch/csrc/reduction.cu`` as it stands and, from copies
of it edited as :data:`VARIANTS` says (each edit an exact text
replacement, which must match once), one library per variant, all with
``_build.NVCC_FLAGS`` into ``build/reduction_variants/``.  For each build
and mode, on one card and on the same 2^24 f32 values from seed 0 (the
Table V operand): whether the sum at tile 512 equals the plain version's
bit for bit, and the median time of 20 calls after 3, L2 flushed
(``tablev.time_ms``).  The builds take turns (the checkout first and
again last in every turn, then the variants), and ``torch.sum`` is timed
in every turn.  Prints one line per reading and a JSON line of medians
over the turns.  Needs one CUDA card.

The variants show what each design choice of the persistent route buys:

- ``no_second_pass``: the first pass alone (its sum is wrong: the time of
  the tiles and their trees);
- ``plain_loads``: the input loaded without the evict-first mark;
- ``ahead_4``, ``ahead_6``: the tiles in flight a thread, not two;
- ``half_the_blocks``: half the resident blocks in the first pass;
- ``fold_twice``: the second pass folding twice (the second time at 0
  weight: its cost, from L2);
- ``fold_launch_only``: that second launch without its fold (its sum is
  wrong: the launch's own cost);
- ``second_launch_plain``: that second launch an ordinary one, not a
  programmatic dependent;
- ``fold_in_rounds``: that second pass staging the partials in rounds of
  24 KB (two in flight), not all 32,768 at once (two halves of 64 KB);
- ``fold_registers``: that second pass folding from registers, 32 loads a
  thread written ahead of their adds (``__ldcg``), not staged through
  shared memory;
- ``native_ticket``: native's second pass inside its first launch, by
  the last block to finish its tiles (an integer ticket), folding from
  registers, not a launch of its own;
- ``native_vector``: native copying 4 KB slabs (2 f32 tiles) by 16-byte
  ``cp.async``, one vector for every thread, into a ring of four in
  shared memory, each thread reading its two elements back after the
  slab's barrier (on a 16-byte aligned operand).
"""
import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

#: native_vector's slab ring, put before the persistent first pass
_SLAB_RING = """
constexpr int kSlabBytes = kRedThreads * 16;
constexpr int kSlabStages = 4;

template <int MODE, typename T>
__device__ __forceinline__ void tiles_vector(
    const T* __restrict__ x, long long n, long long tiles, long long step,
    float* dst, float (*scratch)[kRedThreads]) {
  constexpr int kTiles = kSlabBytes / (kSmallTile * (int)sizeof(T));
  __shared__ __align__(16) uint8_t ring[kSlabStages][kSlabBytes];
  const long long slabs = (tiles + kTiles - 1) / kTiles;
  const long long nbytes = n * (long long)sizeof(T);
  const char* src = (const char*)x;
  auto copy = [&](long long slab, int stage) {
    if (slab < slabs) {
      const long long off = slab * kSlabBytes + threadIdx.x * 16;
      const long long left = nbytes - off;
      const int bytes = left >= 16 ? 16 : left > 0 ? (int)left : 0;
      red_cp_async((float*)(ring[stage] + threadIdx.x * 16),
                   (const float*)(src + (bytes > 0 ? off : 0)), bytes);
    }
    asm volatile("cp.async.commit_group;\\n" ::: "memory");
  };
#pragma unroll
  for (int s = 0; s < kSlabStages - 1; ++s) copy(blockIdx.x + s * step, s);
  int parity = 0;
  long long i = 0;
  for (long long slab = blockIdx.x; slab < slabs; slab += step, ++i) {
    copy(slab + (kSlabStages - 1) * step,
          (int)((i + kSlabStages - 1) % kSlabStages));
    asm volatile("cp.async.wait_group %0;\\n" ::"n"(kSlabStages - 1)
                 : "memory");
    __syncthreads();
    const T* e = (const T*)ring[i % kSlabStages];
#pragma unroll
    for (int k = 0; k < kTiles; ++k) {
      const long long tile = slab * kTiles + k;
      if (tile >= tiles) break;
      float acc = 0.f;
      acc += elem_f(e[k * kSmallTile + threadIdx.x]);
      acc += elem_f(e[k * kSmallTile + threadIdx.x + kRedThreads]);
      const float s = block_tree<MODE>(acc, scratch[parity]);
      if (threadIdx.x == 0) dst[tile] = s;
      parity ^= 1;
    }
  }
  asm volatile("cp.async.wait_group 0;\\n" ::: "memory");
}

"""

#: native_ticket: the last block to finish its tiles folds the partials
#: inside the first launch, by an integer ticket, from registers
_TICKET = """
  if constexpr (MODE == kRedNative) {
    __shared__ int last;
    if (tiles == 1) return;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicAdd(&red_ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    float racc = 0.f;
    for (long long i0 = threadIdx.x; i0 < tiles; i0 += 32 * 256) {
      float pv[32];
#pragma unroll
      for (int u = 0; u < 32; ++u)
        pv[u] = i0 + u * 256 < tiles ? __ldcg(part + i0 + u * 256) : 0.f;
#pragma unroll
      for (int u = 0; u < 32; ++u)
        if (i0 + u * 256 < tiles) racc += pv[u];
    }
    const float s = block_tree<MODE>(racc, scratch[0]);
    if (threadIdx.x == 0) {
      *out = s;
      red_ticket = 0u;
    }
  }
}
"""
_KERNEL_END = "      if (threadIdx.x == 0) dst[tile] = s;\n    }\n  }\n}\n"

#: variant -> [(text in reduction.cu, its replacement), ...]
VARIANTS = {
    "no_second_pass": [
        ("  if (err != cudaSuccess || tiles == 1) return err;\n"
         "  err = cudaFuncSetAttribute(",
         "  if (true) return err;\n"
         "  err = cudaFuncSetAttribute(")],
    "plain_loads": [("ld.global.cs.b32", "ld.global.b32"),
                    ("ld.global.cs.b16", "ld.global.b16")],
    "ahead_4": [("constexpr int kAhead = 2;", "constexpr int kAhead = 4;")],
    "ahead_6": [("constexpr int kAhead = 2;", "constexpr int kAhead = 6;")],
    "half_the_blocks": [("    resident = per_sm * sms;",
                         "    resident = per_sm / 2 * sms;")],
    "fold_twice": [
        ("  const float s = fold_partials<MODE>(part, count, red_stage, "
         "scratch);",
         "  __shared__ float scratch2[kRedThreads];\n"
         "  float s = fold_partials<MODE>(part, count, red_stage, scratch);\n"
         "  s += 0.f * fold_partials<MODE>(part, count, red_stage, "
         "scratch2);")],
    "fold_launch_only": [
        ("  const float s = fold_partials<MODE>(part, count, red_stage, "
         "scratch);", "  const float s = 0.f;")],
    "second_launch_plain": [("  cfg.numAttrs = 1;\n", "  cfg.numAttrs = 0;\n")],
    "fold_registers": [(
        "  const int tid = threadIdx.x;\n"
        "  const long long rounds = (count + kFoldStage - 1) / kFoldStage;\n",
        "  float racc = 0.f;\n"
        "  for (long long i0 = threadIdx.x; i0 < count; i0 += 32 * 256) {\n"
        "    float v[32];\n"
        "#pragma unroll\n"
        "    for (int u = 0; u < 32; ++u)\n"
        "      v[u] = i0 + u * 256 < count ? __ldcg(p + i0 + u * 256) : 0.f;\n"
        "#pragma unroll\n"
        "    for (int u = 0; u < 32; ++u)\n"
        "      if (i0 + u * 256 < count) racc += v[u];\n"
        "  }\n"
        "  if (count > 0) return block_tree<MODE>(racc, scratch);\n"
        "  const int tid = threadIdx.x;\n"
        "  const long long rounds = (count + kFoldStage - 1) / kFoldStage;\n")],
    "fold_in_rounds": [("constexpr int kFoldStage = 16384;",
                        "constexpr int kFoldStage = 6144;")],
    "native_ticket": [
        ("__device__ __forceinline__ void red_cp_async(",
         "__device__ unsigned red_ticket;\n\n"
         "__device__ __forceinline__ void red_cp_async("),
        (_KERNEL_END,
         "      if (threadIdx.x == 0) dst[tile] = s;\n    }\n  }\n" + _TICKET),
        ("  if (err != cudaSuccess || tiles == 1) return err;\n"
         "  err = cudaFuncSetAttribute(",
         "  if (err != cudaSuccess || tiles == 1 || MODE == kRedNative)\n"
         "    return err;\n"
         "  err = cudaFuncSetAttribute(")],
    "native_vector": [
        ("// The persistent first pass: block b walks",
         _SLAB_RING + "// The persistent first pass: block b walks"),
        ("  typename E::R v[kAhead][2];\n",
         "  if (MODE == kRedNative && ((uintptr_t)x % 16) == 0) {\n"
         "    tiles_vector<MODE>(x, n, tiles, step, dst, scratch);\n"
         "    return;\n"
         "  }\n"
         "  typename E::R v[kAhead][2];\n")],
}


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"reduction_variants: an edit matches "
                             f"{src.count(old)} times, not once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(names, out: Path) -> dict:
    """{build name: library path}, every nvcc in parallel."""
    from repro_torch.kernels import _build
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "reduction.cu").read_text()
    procs = {}
    for name in ["checkout", *names]:
        cu = out / f"reduction_{name}.cu"
        cu.write_text(src if name == "checkout"
                      else variant_source(src, VARIANTS[name]))
        lib = out / f"libreduction_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"reduction_variants: nvcc failed for {name}:\n"
                             f"{log}")
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--only", nargs="*", choices=list(VARIANTS),
                    default=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("reduction_variants: no CUDA card is available",
              file=sys.stderr)
        return 2
    from repro_torch.benchmarks import tablev
    from repro_torch.benchmarks.common import l2_flush_buffer
    from repro_torch.kernels import _launch, reduction
    dev = torch.device("cuda", 0)
    print(f"card: {torch.cuda.get_device_name(dev)}", flush=True)
    libs = build(args.only, ROOT / "build" / "reduction_variants")
    symbol, argtypes = _launch.SIGNATURES["reduction"][:2]
    fns = {}
    for name, lib in libs.items():
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    x = torch.randn(tablev.RED_N, generator=g, device=dev)
    tile = reduction.SMALL_TILE
    want = {m: reduction.reduce_sum_plain(x, mode=m, tile=tile)
            for m in reduction.MODES}
    flush = l2_flush_buffer(dev)
    readings = {}
    order = ["checkout", *args.only, "checkout"]
    try:
        for turn in range(args.turns):
            for name in order:
                _launch._bound["reduction"] = fns[name]
                for mode in reduction.MODES:
                    got = reduction.reduce_sum_kernel(x, mode, tile)
                    same = got.view(torch.int32).item() == \
                        want[mode].view(torch.int32).item()
                    ms = tablev.time_ms(
                        lambda: reduction.reduce_sum_kernel(x, mode, tile),
                        flush=flush)
                    readings.setdefault((name, mode), []).append(ms)
                    print(f"turn {turn} {name} [{mode}]: {ms:.4f} ms, "
                          f"{'equals' if same else 'differs from'} the "
                          f"plain version bit for bit", flush=True)
            ms = tablev.time_ms(lambda: torch.sum(x, dtype=torch.float32),
                                flush=flush)
            readings.setdefault(("torch.sum", "library"), []).append(ms)
            print(f"turn {turn} torch.sum: {ms:.4f} ms", flush=True)
    finally:
        _launch._bound.pop("reduction", None)
    print(json.dumps({f"{k[0]} [{k[1]}]": statistics.median(v)
                      for k, v in readings.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
