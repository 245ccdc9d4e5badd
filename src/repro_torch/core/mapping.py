"""Mapping analysis (paper §VI / Fig. 3): abstract model -> vendor backends.

The JAX package's ``core/mapping.py``: the per-vendor mapping tables (the
paper's Fig. 3 as text) and the TPU adaptation table, rendered from this
package's ``SPECS`` and dialects, so the report and the enforced contracts
cannot drift apart.  The reports are the reference's line for line: the
four GPU vendors of the paper, and ``TPU_V5E`` as the target column.
"""
from __future__ import annotations

from typing import List

from repro_torch.core import dialect as D
from repro_torch.core import primitives as P


def mapping_rows(vendor: str) -> List[tuple]:
    rows = []
    for prim in P.Primitive:
        spec = P.SPECS[prim]
        native = spec.vendor_realization.get(vendor, "n/a")
        rows.append((prim.value, prim.name, spec.classification.value, native))
    return rows


def render_table(headers, rows) -> str:
    widths = [max(len(str(h)), *(len(str(r[i])) for r in rows))
              for i, h in enumerate(headers)]
    def fmt(row):
        return " | ".join(str(c).ljust(w) for c, w in zip(row, widths))
    sep = "-+-".join("-" * w for w in widths)
    return "\n".join([fmt(headers), sep] + [fmt(r) for r in rows])


def vendor_mapping_report() -> str:
    """Fig. 3 as text: every primitive's realization on all four vendors."""
    headers = ["#", "primitive", "class"] + [d.vendor for d in D.gpu_dialects()]
    rows = []
    for prim in P.Primitive:
        spec = P.SPECS[prim]
        rows.append([prim.value, prim.name, spec.classification.value[:5]] +
                    [spec.vendor_realization.get(d.vendor, "n/a")
                     for d in D.gpu_dialects()])
    return render_table(headers, rows)


def tpu_adaptation_report() -> str:
    """DESIGN.md §2: primitive -> TPU v5e realization, flagging indirect maps."""
    headers = ["#", "primitive", "direct?", "TPU realization"]
    rows = [[p.value, p.name, "yes" if P.SPECS[p].tpu_direct else "ADAPTED",
             P.SPECS[p].tpu_realization] for p in P.Primitive]
    return render_table(headers, rows)


def dialect_table() -> str:
    """Paper Table III + the TPU column."""
    ds = list(D.gpu_dialects()) + [D.TPU_V5E]
    headers = ["parameter"] + [d.vendor for d in ds]
    rows = [
        ["wave width W"] + ["/".join(map(str, d.wave_width)) for d in ds],
        ["max regs R"] + [d.R for d in ds],
        ["scratchpad S"] + [f"{d.S // 1024}K" for d in ds],
        ["max workgroup"] + [d.max_workgroup for d in ds],
        ["named barriers"] + [d.named_barriers for d in ds],
        ["native FP64"] + ["yes" if d.native_fp64 else "no" for d in ds],
        ["matrix tile"] + [str(d.matrix_unit.tile) if d.matrix_unit else "absent"
                           for d in ds],
        ["HW atomics"] + ["yes" if d.has_hw_atomics else "NO" for d in ds],
        ["lane shuffle"] + ["yes" if d.has_lane_shuffle else "no" for d in ds],
    ]
    return render_table(headers, rows)


def full_report() -> str:
    parts = [
        "== Parameterizable dialects (paper Table III + TPU target) ==",
        dialect_table(),
        "",
        "== Invariant/divergent primitives across vendors (Table II / Fig. 3) ==",
        vendor_mapping_report(),
        "",
        "== TPU v5e adaptation (DESIGN.md section 2) ==",
        tpu_adaptation_report(),
    ]
    return "\n".join(parts)
