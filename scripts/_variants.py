"""What ``ssd_decode_variants.py``, ``histogram_variants.py`` and
``decode_variants.py`` share:
exact text edits of one kernel source, the parallel ``nvcc`` builds of a
checkout's, a parent checkout's and the edited copies' libraries, and the
profiler's device duration of one kernel launch.  Imported by those
scripts, which run on a machine with a CUDA card."""
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def load_smoke():
    """This checkout's ``chip_smoke.py`` as a module (its timers, its
    tolerances, its cases)."""
    spec = importlib.util.spec_from_file_location("smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def variant_source(src: str, edits, what: str) -> str:
    """``src`` with each (old, new) of ``edits`` replaced; each ``old`` must
    match exactly once."""
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"{what}: an edit matches {src.count(old)} "
                             f"times, not once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def build(source: str, builds: dict, out: Path) -> dict:
    """Build ``lib<name>.so`` of ``csrc/<source>.cu`` for each of
    ``builds`` ({name: (csrc dir, edits or None)}: an edited build is a copy
    of its csrc dir under ``out`` whose ``<source>.cu`` takes the edits, a
    list of (old, new), or whose files take theirs, {file name: edits}),
    every ``nvcc`` in parallel with the port's flags.  Returns {name:
    library path} of the builds that compiled; each failure's log is
    printed."""
    from repro_torch.kernels import _build
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    procs = {}
    for name, (csrc, edits) in builds.items():
        if edits is not None:
            copy = out / name
            shutil.copytree(csrc, copy)
            files = edits if isinstance(edits, dict) \
                else {f"{source}.cu": edits}
            for file, file_edits in files.items():
                (copy / file).write_text(variant_source(
                    (csrc / file).read_text(), file_edits, f"{name} {file}"))
            csrc = copy
        lib = out / f"lib{source}_{name}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
               str(csrc), "-o", str(lib), str(csrc / f"{source}.cu")]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            print(f"nvcc failed for {name}:\n{log}", flush=True)
            continue
        libs[name] = lib
    return libs


def trace_us(fns, flush, calls: int):
    """Median device duration (us) of the kernel of one call of each of
    ``fns``, over ``calls`` calls each after an L2 flush, in one
    ``torch.profiler`` trace (the calls of ``fns[0]``, then ``fns[1]``'s,
    ...); None where the trace shows no kernel of a function's calls."""
    from torch.profiler import ProfilerActivity, profile
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            for _ in range(calls):
                flush.amax()
                fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = sorted((e for e in json.loads(path.read_text())["traceEvents"]
                         if e.get("cat") == "kernel"
                         and "uisa::" in e["name"]), key=lambda e: e["ts"])
    if len(events) != calls * len(fns):
        return [None] * len(fns)
    out = []
    for k in range(len(fns)):
        durs = [e["dur"] for e in events[k * calls:(k + 1) * calls]]
        out.append({"us": statistics.median(durs), "us_min": min(durs),
                    "kernels": len(durs),
                    "name": events[k * calls]["name"][:80]})
    return out


def traced_turns(runs: dict, flush, calls: int, turns: int) -> dict:
    """{key: {"us": median over turns, "turns": [each turn's median]}} of
    ``runs`` ({key: fn}), each turn one trace of every fn
    (:func:`trace_us`), in order on even turns and in reverse on odd
    ones, so that no key always runs first."""
    keys = list(runs)
    per = {k: [] for k in keys}
    for turn in range(turns):
        order = keys if turn % 2 == 0 else keys[::-1]
        for k, r in zip(order, trace_us([runs[k] for k in order], flush,
                                        calls)):
            if r is not None:
                per[k].append(r["us"])
    return {k: {"us": statistics.median(v) if v else None, "turns": v}
            for k, v in per.items()}


def medians(readings: dict) -> dict:
    """{build: {case: {mode: median}}} of {(build, case, mode): [ms]}."""
    med = {}
    for (build_name, case, mode), v in readings.items():
        med.setdefault(build_name, {}).setdefault(case, {})[mode] = \
            statistics.median(v)
    return med


def pct_of_native(med: dict) -> dict:
    """Each mode's % of native (native ms / mode ms) by build and case."""
    return {b: {c: {m: 100.0 * v["native"] / v[m] for m in v
                    if m != "native"}
                for c, v in cases.items() if "native" in v}
            for b, cases in med.items()}
