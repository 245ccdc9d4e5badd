#!/usr/bin/env python3
"""Time and check the tied head on the decode GEMV's transposed-table form
(row 1f) beside variants of its source.

    python scripts/gemv_t_variants.py [--turns 2] [--only NAME ...]

Copies ``src/repro_torch/csrc/`` once as it stands and once per variant
into ``build/gemv_t_variants/<name>/``, edits the copy's
``norm_gemv_t.cuh`` as :data:`VARIANTS` says (each edit an exact text
replacement, which must match once), and builds each copy's
``rmsnorm_matmul.cu`` with ``_build.NVCC_FLAGS``.  For each build and
mode, on one card and on the same operands (granite-moe-3b-a800m's tied
head from seed 0: x [8, 1536] bf16, the f32 table [49155, 1536] read as
its transposed view): the route taken, the largest |kernel - plain| over
the largest |plain|, and the median time of 20 calls after 3, L2 flushed
(``tablev.time_ms``).  The builds take turns (the checkout first and again
last in every turn), and the library call (``F.rms_norm``, then the f32
product: chip_smoke.py's) is timed in every turn.  Prints one line per
reading and a JSON line of medians over the turns.  Needs one CUDA card.

The variants:

- ``l2_none``: the 16-byte copies without the ``.L2::256B`` prefetch
  (each then brings only this stage's 128 bytes of a row);
- ``stages_2``: a ring of two 32 KB tiles, not three;
- ``stages_4``: a ring of four (one block an SM).
"""
import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

#: variant -> [(text in norm_gemv_t.cuh, its replacement), ...]
VARIANTS = {
    "l2_none": [("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;",
                 "cp.async.cg.shared.global [%0], [%1], 16, %2;")],
    "stages_2": [("constexpr int GEMV_T_STAGES = 3;",
                  "constexpr int GEMV_T_STAGES = 2;")],
    "stages_4": [("constexpr int GEMV_T_STAGES = 3;",
                  "constexpr int GEMV_T_STAGES = 4;")],
}
SLOTS, D_MODEL, VOCAB = 8, 1536, 49155


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"gemv_t_variants: an edit matches "
                             f"{src.count(old)} times, not once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(names, out: Path) -> dict:
    """{build name: library path}, every nvcc in parallel."""
    from repro_torch.kernels import _build
    procs = {}
    for name in ["checkout", *names]:
        csrc = out / name
        if csrc.exists():
            shutil.rmtree(csrc)
        shutil.copytree(_build.CSRC, csrc)
        if name != "checkout":
            hdr = csrc / "norm_gemv_t.cuh"
            hdr.write_text(variant_source(hdr.read_text(), VARIANTS[name]))
        lib = out / f"librmsnorm_matmul_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
               str(csrc / "rmsnorm_matmul.cu")]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"gemv_t_variants: nvcc failed for {name}:\n"
                             f"{log}")
        regs = [l.split("Used")[1].strip() for l in log.splitlines()
                if "Used" in l]
        print(f"{name}: {len(regs)} kernels built", flush=True)
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--only", nargs="*", choices=list(VARIANTS),
                    default=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gemv_t_variants: no CUDA card is available", file=sys.stderr)
        return 2
    from repro_torch.benchmarks import tablev
    from repro_torch.benchmarks.common import l2_flush_buffer
    from repro_torch.kernels import _launch, fused
    dev = torch.device("cuda", 0)
    print(f"card: {torch.cuda.get_device_name(dev)}", flush=True)
    libs = build(args.only, ROOT / "build" / "gemv_t_variants")
    fns = {}
    for name, lib in libs.items():
        cdll = ctypes.CDLL(str(lib))
        fns[name] = {}
        for entry in ("rmsnorm_matmul", "rmsnorm_matmul_workspace"):
            symbol, argtypes, *rest = _launch.SIGNATURES[entry]
            fn = getattr(cdll, symbol)
            fn.argtypes = argtypes
            fn.restype = rest[1] if rest else ctypes.c_int
            fns[name][entry] = fn
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    x = torch.randn(SLOTS, D_MODEL, generator=g, device=dev).bfloat16()
    w = (1 + 0.1 * torch.randn(D_MODEL, generator=g, device=dev)).bfloat16()
    table = torch.randn(VOCAB, D_MODEL, generator=g, device=dev) * 0.02
    flush = l2_flush_buffer(dev)
    plain = {m: fused.rmsnorm_matmul_plain(x, w, table.t(), mode=m).float()
             for m in _launch.MODE_CODES}
    readings = {}
    order = ["checkout", *args.only, "checkout"]

    def library():
        return F.rms_norm(x, (D_MODEL,), w, 1e-6).float() @ table.t()
    try:
        for turn in range(args.turns):
            for name in order:
                _launch._bound.update(fns[name])
                for mode in _launch.MODE_CODES:
                    got = fused.rmsnorm_matmul(x, w, table.t(), mode=mode)
                    route = _launch.LAST_ROUTE[_launch.count_name(
                        "rmsnorm_matmul", mode)]
                    err = float((got.float() - plain[mode]).abs().max()
                                / plain[mode].abs().max())
                    ms = tablev.time_ms(lambda: fused.rmsnorm_matmul(
                        x, w, table.t(), mode=mode), flush=flush)
                    readings.setdefault((name, mode), []).append(ms)
                    print(f"turn {turn} {name} [{mode}]: {ms:.4f} ms, route "
                          f"{route}, max err / max|plain| {err:.3g}",
                          flush=True)
            ms = tablev.time_ms(library, flush=flush)
            readings.setdefault(("library", "F.rms_norm + matmul"),
                                []).append(ms)
            print(f"turn {turn} library: {ms:.4f} ms", flush=True)
    finally:
        for entry in ("rmsnorm_matmul", "rmsnorm_matmul_workspace"):
            _launch._bound.pop(entry, None)
    print(json.dumps({f"{k[0]} [{k[1]}]": statistics.median(v)
                      for k, v in readings.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
