#!/usr/bin/env python3
"""Compare the SASS of the port's kernels between two builds.

    python scripts/sass_diff.py BUILD_A BUILD_B [lib ...]

BUILD_A and BUILD_B are two build directories of ``src/repro_torch``'s
kernels (``build/repro_torch_kernels/<hash>/``, one ``lib<name>.so`` per
``csrc/<name>.cu``), typically a parent commit's and a change's, built on
the machine with the card (``cuobjdump`` comes with the CUDA toolkit).  For
each library (default: the nine model-path kernels) every kernel of BUILD_A
is matched with its kernel in BUILD_B and their instructions are compared,
addresses and encodings aside.  A kernel matches under its own name, or,
where its template gained the mode argument between A and B, under its
native instantiation: B's ``...Li2EEEv...`` (``MODE = kNative``) names A's
``...EEv...``.  Prints one line per kernel
(identical, or the count of differing instructions) and one summary line;
exits 1 if a native kernel differs or is missing.
"""
import re
import shutil
import subprocess
import sys
from pathlib import Path

DEFAULT_LIBS = ("rmsnorm_matmul", "rmsnorm_swiglu", "flash_attention_matmul",
                "paged_attention_matmul", "rmsnorm", "add_rmsnorm",
                "flash_attention", "ssd_scan", "ssd_decode")
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


def main(argv) -> int:
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    a_dir, b_dir = Path(argv[0]), Path(argv[1])
    libs = argv[2:] or DEFAULT_LIBS
    same = differ = missing = 0
    for lib in libs:
        a = sass(a_dir / f"lib{lib}.so")
        b_raw = sass(b_dir / f"lib{lib}.so")
        b = dict(b_raw)
        for k, v in b_raw.items():
            b.setdefault(native_name(k), v)
        for name, insns in sorted(a.items()):
            other = b.get(name)
            if other is None:
                missing += 1
                print(f"{lib}: {name}: missing in B")
            elif other == insns:
                same += 1
                print(f"{lib}: {name}: identical ({len(insns)} instructions)")
            else:
                differ += 1
                n = sum(x != y for x, y in zip(insns, other)) \
                    + abs(len(insns) - len(other))
                print(f"{lib}: {name}: DIFFERS ({len(insns)} vs "
                      f"{len(other)} instructions, {n} differ)")
        new = [k for k in b_raw if k not in a and native_name(k) not in a]
        print(f"{lib}: {len(new)} kernels only in B (the new modes' "
              f"instantiations)")
    print(f"summary: {same} identical, {differ} differ, {missing} missing")
    return 0 if differ == missing == 0 else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
