#!/usr/bin/env python3
"""Compare the SASS of the port's kernels between two builds.

    python scripts/sass_diff.py BUILD_A BUILD_B [lib ...]
                                [--dropped ARG ...] [--renamed OLD=NEW ...]
                                [--changed NAME[=OPCODE,...] ...]

BUILD_A and BUILD_B are two build directories of ``src/repro_torch``'s
kernels (``build/repro_torch_kernels/<hash>/``, one ``lib<name>.so`` per
``csrc/<name>.cu``), typically a parent commit's and a change's, built on
the machine with the card (``cuobjdump`` comes with the CUDA toolkit).  For
each library (default: all twelve, the nine model-path kernels and Table
V's three) every kernel of BUILD_A is matched with its kernel in BUILD_B
and their instructions are compared,
addresses and encodings aside.  A kernel matches under its own name, or,
where its template gained the mode argument between A and B, under its
native instantiation: B's ``...Li2EEEv...`` (``MODE = kNative``) names A's
``...EEv...``.  Prints one line per kernel
(identical, or the count of differing instructions) and one summary line;
exits 1 if a native kernel differs or is missing.

``--dropped ARG`` (repeatable, before ``--changed``): a kernel whose
template gained a last argument between A and B keeps A's name in its
instantiation at that argument, ARG in mangled form (``Li8E`` for ``8``):
B's ``...Li2ELi8EEEv...`` names A's ``...Li2EEEv...`` (e.g. the decode
kernels' group bound ``GM``, whose 8 stands for the kernels before it).

``--renamed OLD=NEW`` (repeatable, before ``--changed``) holds A's kernel
OLD to identity with B's kernel NEW, two full mangled names: a kernel that
became a template keeps its SASS in the instantiation that stands for it
(e.g. a plain ``tc_gemm_kernel`` and the ``<bf16, false>`` instantiation
of the templated one).  A renamed pair is never excused by ``--changed``.

``--changed`` names the kernels a change set out to add or change: a
kernel whose mangled name contains NAME may differ from A's, be new in B
or be gone from B without failing the comparison, and with ``=OPCODE,...``
every kernel of B that matches NAME must hold one of those instructions
(e.g. ``tc_gemm_kernel=HGMMA``, ``attn_tc_kernel=HMMA,HGMMA``), and at
least one must exist.  Every other kernel stays held to identity.
"""
import re
import shutil
import subprocess
import sys
from pathlib import Path

DEFAULT_LIBS = ("rmsnorm_matmul", "rmsnorm_swiglu", "flash_attention_matmul",
                "paged_attention_matmul", "rmsnorm", "add_rmsnorm",
                "flash_attention", "ssd_scan", "ssd_decode", "gemm",
                "reduction", "histogram")
_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;")


def cuobjdump() -> str:
    path = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(path).exists():
        raise SystemExit("cuobjdump not found (it comes with the CUDA toolkit)")
    return path


def sass(lib: Path) -> dict:
    """{mangled kernel name: [instruction text, ...]}"""
    out = subprocess.run([cuobjdump(), "-sass", str(lib)], check=True,
                         capture_output=True, text=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.match(line)
        if m and cur is not None:
            cur.append(m.group(1))
    return funcs


def native_name(name: str) -> str:
    """B's native instantiation of a kernel templated on the mode, under
    the name the kernel had before it took the mode."""
    return name.replace("Li2EEEv", "EEv")


def dropped_name(name: str, dropped) -> str:
    """A's name of B's kernel ``name`` whose last template argument is one
    of ``dropped`` (mangled), else ``name``."""
    for arg in dropped:
        if f"{arg}EEv" in name:
            return name.replace(f"{arg}EEv", "EEv")
    return name


def holds(insns, opcodes) -> bool:
    """Whether an instruction's mnemonic is one of ``opcodes``."""
    return any(re.search(rf"\b{op}\b", i) for i in insns for op in opcodes)


def parse_changed(specs) -> dict:
    """``NAME[=OPCODE,...]`` -> {NAME: (OPCODE, ...)}"""
    out = {}
    for spec in specs:
        name, _, ops = spec.partition("=")
        out[name] = tuple(o for o in ops.split(",") if o)
    return out


def main(argv) -> int:
    changed = {}
    if "--changed" in argv:
        i = argv.index("--changed")
        changed = parse_changed(argv[i + 1:])
        argv = argv[:i]
    dropped = []
    while "--dropped" in argv:
        i = argv.index("--dropped")
        dropped.append(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    renamed = {}
    while "--renamed" in argv:
        i = argv.index("--renamed")
        old, _, new = argv[i + 1].partition("=")
        renamed[old] = new
        argv = argv[:i] + argv[i + 2:]
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    a_dir, b_dir = Path(argv[0]), Path(argv[1])
    libs = argv[2:] or DEFAULT_LIBS

    def intended(name):
        return name not in renamed and any(c in name for c in changed)

    same = differ = missing = intended_n = 0
    found = {c: 0 for c in changed}
    bad_ops = []
    for lib in libs:
        a = sass(a_dir / f"lib{lib}.so")
        b_raw = sass(b_dir / f"lib{lib}.so")
        b = dict(b_raw)
        for k, v in b_raw.items():
            b.setdefault(native_name(k), v)
            b.setdefault(dropped_name(k, dropped), v)
        for old, new in renamed.items():
            if old in a and new in b_raw:
                b[old] = b_raw[new]
        for name, insns in sorted(a.items()):
            other = b.get(name)
            if other == insns:
                same += 1
                print(f"{lib}: {name}: identical ({len(insns)} instructions)")
                continue
            if other is None:
                what = "missing in B"
            else:
                n = sum(x != y for x, y in zip(insns, other)) \
                    + abs(len(insns) - len(other))
                what = (f"{len(insns)} vs {len(other)} instructions, {n} "
                        f"differ")
            if intended(name):
                intended_n += 1
                print(f"{lib}: {name}: changed as intended ({what})")
            elif other is None:
                missing += 1
                print(f"{lib}: {name}: missing in B")
            else:
                differ += 1
                print(f"{lib}: {name}: DIFFERS ({what})")
        stands_for = {n for o, n in renamed.items() if o in a}
        new = [k for k in b_raw if k not in a and native_name(k) not in a
               and dropped_name(k, dropped) not in a and k not in stands_for]
        print(f"{lib}: {len(new)} kernels only in B")
        for name, insns in sorted(b_raw.items()):
            for c, ops in changed.items():
                if c not in name:
                    continue
                found[c] += 1
                ok = not ops or holds(insns, ops)
                print(f"{lib}: {name}: {'holds' if ok else 'LACKS'} "
                      f"{' or '.join(ops) or 'no required instruction'} "
                      f"({len(insns)} instructions)")
                if not ok:
                    bad_ops.append(name)
        unmatched = [k for k in new if not intended(k)]
        if unmatched:
            print(f"{lib}: new beyond --changed (new instantiations): "
                  f"{len(unmatched)}")
    absent = [c for c, n in found.items() if n == 0]
    for c in absent:
        print(f"--changed {c}: no kernel of B matches")
    print(f"summary: {same} identical, {differ} differ, {missing} missing, "
          f"{intended_n} changed as intended, {len(bad_ops)} lack their "
          f"instructions")
    return 0 if differ == missing == 0 and not bad_ops and not absent else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
