#!/usr/bin/env python3
"""Time and check the Table V GEMM kernels beside variants of their source.

    python scripts/gemm_variants.py [--turns 2] [--n 4096] [--only NAME ...]

Builds ``src/repro_torch/csrc/gemm.cu`` as it stands and, from copies of
it edited as :data:`VARIANTS` says (each edit an exact text replacement,
which must match), one library per variant, all with ``_build.NVCC_FLAGS``
into ``build/gemm_variants/``.  For each build and mode, on one card and on
the same operands (N x N x N f32 from seed 0): the relative RMS error
against the float64 product beside ``torch.matmul``'s (TF32 off: cuBLAS
SGEMM), whether ``tablev.check_gemm`` holds, and the median time of 20
calls after 3, L2 flushed (``tablev.time_ms``).  The builds take turns
(the checkout first and again last in every turn, then the variants), and
``torch.matmul`` is timed in every turn.  Prints one line per reading and
a JSON line of medians over the turns.  Needs one CUDA card.

The variants show what each design choice buys:

- ``cvt_rna``: TF32 rounding by ``cvt.rna.tf32.f32`` instead of the two
  integer operations (the same bits for finite values);
- ``tc_sums``: the products summed in the tensor cores across K tiles,
  without the rounding FADD at the end of each tile;
- ``one_product``: 1xTF32, hi.hi alone (another function: its error);
- ``native_work_after``: native's work on the next tile (split,
  fragments) all after the last k8 step's issue, not a quarter after
  each;
- ``native_3_stages``: native's TMA ring three stages deep, not four;
- ``abstract_4_byte``: abstract's copies 4 bytes at a time on aligned
  operands too.
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

#: variant -> [(text in gemm.cu, its replacement), ...]
VARIANTS = {
    "cvt_rna": [(
        "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n",
        "  uint32_t r;\n"
        "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : \"f\"(x));\n"
        "  return r;\n")],
    "tc_sums": [
        ("wgmma_desc(lo + 8 * q, 16, 1024), q > 0);",
         "wgmma_desc(lo + 8 * q, 16, 1024), kt > 0 || q > 0);"),
        ("    for (int i = 0; i < 64; ++i) acc[i] += part[i];",
         "    for (int i = 0; i < 64; ++i) acc[i] = part[i];"),
        ("    float part[2][4][4] = {};", "    float (&part)[2][4][4] = acc;"),
        ("    add_tiles(acc, part);\n", "")],
    "one_product": [
        ("      mma_tf32(acc[i][j], al, bh[j]);\n"
         "      mma_tf32(acc[i][j], ah, bl[j]);\n", ""),
        ("      wgmma_tf32_m64n128k8(part, ch[q], wgmma_desc(lo + 8 * q, 16, 1024), q > 0);\n"
         "      wgmma_tf32_m64n128k8(part, cl[q], wgmma_desc(a + 8 * q, 16, 1024), 1);\n"
         "      wgmma_tf32_m64n128k8(part, ch[q], wgmma_desc(a + 8 * q, 16, 1024), 1);\n",
         "      wgmma_tf32_m64n128k8(part, ch[q], wgmma_desc(a + 8 * q, 16, 1024), q > 0);\n")],
    "native_work_after": [
        ("      if (more) {\n"
         "        if (q == 0) landed(kt + 1);\n"
         "        native_split_a(stage_a(kt + 1), lo_tile(kt + 1), q);\n"
         "        native_b_frag(stage_a(kt + 1) + kNatBM * kNatBK, wg * 64, q, nh[q], nl[q]);\n"
         "      }\n", ""),
        ("    wgmma_commit();\n    wgmma_wait_all();\n",
         "    wgmma_commit();\n"
         "    if (more) {\n"
         "      landed(kt + 1);\n"
         "      for (int q = 0; q < 4; ++q) {\n"
         "        native_split_a(stage_a(kt + 1), lo_tile(kt + 1), q);\n"
         "        native_b_frag(stage_a(kt + 1) + kNatBM * kNatBK, wg * 64, q, nh[q], nl[q]);\n"
         "      }\n"
         "    }\n"
         "    wgmma_wait_all();\n")],
    "native_3_stages": [("kNatStages = 4;", "kNatStages = 3;")],
    "abstract_4_byte": [(
        "auto kernel = vec ? gemm_abstract_kernel<true, OutT> : "
        "gemm_abstract_kernel<false, OutT>;",
        "auto kernel = gemm_abstract_kernel<false, OutT>;")],
}


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"gemm_variants: an edit matches {src.count(old)} "
                             f"times, not once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(names, out: Path) -> dict:
    """{build name: library path}, every nvcc in parallel."""
    from repro_torch.kernels import _build
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "gemm.cu").read_text()
    procs = {}
    for name in ["checkout", *names]:
        cu = out / f"gemm_{name}.cu"
        cu.write_text(src if name == "checkout"
                      else variant_source(src, VARIANTS[name]))
        lib = out / f"libgemm_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               "-o", str(lib), str(cu)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"gemm_variants: nvcc failed for {name}:\n{log}")
        regs = [l.split("Used")[1].strip() for l in log.splitlines()
                if "Used" in l]
        print(f"{name}: {'; '.join(regs)}", flush=True)
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--only", nargs="*", choices=list(VARIANTS),
                    default=list(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gemm_variants: no CUDA card is available", file=sys.stderr)
        return 2
    from repro_torch.benchmarks import tablev
    from repro_torch.benchmarks.common import l2_flush_buffer
    from repro_torch.kernels import _launch, gemm
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"card: {torch.cuda.get_device_name(dev)}", flush=True)
    libs = build(args.only, ROOT / "build" / "gemm_variants")
    symbol, argtypes = _launch.SIGNATURES["gemm"][:2]
    fns = {}
    for name, lib in libs.items():
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    a = torch.randn(args.n, args.n, generator=g, device=dev)
    b = torch.randn(args.n, args.n, generator=g, device=dev)
    ref64 = a.double() @ b.double()
    sgemm = tablev.gemm_rms(a @ b, ref64)
    flush = l2_flush_buffer(dev)
    readings = {}
    order = ["checkout", *args.only, "checkout"]
    try:
        for turn in range(args.turns):
            for name in order:
                _launch._bound["gemm"] = fns[name]
                for mode in gemm.MODES:
                    got = gemm.gemm(a, b, mode=mode)
                    rms = tablev.gemm_rms(got, ref64)
                    try:
                        tablev.check_gemm(got, ref64, name)
                        holds = True
                    except tablev.TableVMismatch:
                        holds = False
                    del got
                    ms = tablev.time_ms(lambda: gemm.gemm(a, b, mode=mode),
                                        flush=flush)
                    readings.setdefault((name, mode), []).append(ms)
                    print(f"turn {turn} {name} [{mode}]: {ms:.4f} ms, "
                          f"relative RMS {rms:.4g} ({rms / sgemm:.3f}x "
                          f"SGEMM's), check_gemm {'holds' if holds else 'fails'}",
                          flush=True)
            ms = tablev.time_ms(lambda: torch.matmul(a, b), flush=flush)
            readings.setdefault(("torch.matmul", "sgemm"), []).append(ms)
            print(f"turn {turn} torch.matmul: {ms:.4f} ms, relative RMS "
                  f"{sgemm:.4g}", flush=True)
    finally:
        _launch._bound.pop("gemm", None)
    print(json.dumps({f"{k[0]} [{k[1]}]": statistics.median(v)
                      for k, v in readings.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
