"""Roofline terms per (arch x shape x mesh) cell, from the port's dry-run
records, on an NVIDIA H100.

Ported from ``src/repro/analysis/roofline.py``, with the reference's TPU
constants replaced by a ``Hardware`` record:

    compute term    = dot FLOPs per device / peak FLOP/s
    memory term     = HBM bytes per device / HBM bandwidth
    collective term = ICI wire bytes / ICI bandwidth + DCN wire bytes / DCN bandwidth

The per-device counts come from ``op_analysis.analyze_step`` (the port has
no HLO): ``launch/dryrun.py`` writes them into each record's ``analysis``
block.  ``H100_SXM`` holds NVIDIA's H100 SXM5 80GB data-sheet figures at its
700 W limit.  The reference's two collective buckets map onto the links of
a GPU cluster: ``ici`` (groups of more than two, the ``data`` and ``model``
axes) onto NVLink, ``dcn`` (groups of two, the ``pod`` axis) onto one
InfiniBand port a GPU.  A group of 16 spans two 8-GPU nodes, so its traffic
rides InfiniBand in part and the NVLink term is a lower bound there.

MODEL_FLOPS = 6·N·T (train) / 2·N·T (inference) with N = active parameters
and T = global tokens; ``useful_ratio`` = MODEL_FLOPS per device over the
counted dot FLOPs (below 1 where the step does extra work, such as remat).

    PYTHONPATH=src python -m repro_torch.analysis.roofline build/dryrun
"""
from __future__ import annotations

import glob
import json
import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass(frozen=True)
class Hardware:
    """Peak rates of one device: FLOP/s, and bytes/s of HBM and of the two
    collective links (a direction)."""

    name: str
    peak_flops: float
    hbm_bw: float
    ici_bw: float
    dcn_bw: float


# NVIDIA H100 SXM5 80GB data sheet, at 700 W.
H100_SXM = Hardware(
    name="h100-sxm (data sheet)",
    peak_flops=989e12,      # dense bf16 on the tensor cores (data sheet)
    hbm_bw=3.35e12,         # HBM3 (data sheet)
    ici_bw=450e9,           # NVLink 4, a direction (data sheet)
    dcn_bw=50e9,            # one NDR 400 Gb/s InfiniBand port a GPU (data sheet)
)
# float32 outside the tensor cores (data sheet): the stencil kernels' bound.
FP32_PEAK = 67e12
# PCIe Gen5 x16 to the host, a direction (data sheet: 128 GB/s both ways).
PCIE_BW = 64e9


def model_flops(cfg, shape) -> float:
    """Analytic useful FLOPs for the whole cell step (global, all devices)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def roofline_terms(analysis: Dict, devices: int, cfg=None, shape=None,
                   hw: Hardware = H100_SXM) -> Dict:
    """The roofline of one step from ``analysis`` (the dict that
    ``analyze_step`` returns, or the reference's ``analyze_hlo_text``)."""
    a = analysis
    compute_s = a["dot_flops"] / hw.peak_flops
    memory_s = a["hbm_bytes"] / hw.hbm_bw
    coll_s = a["collective_bytes_ici"] / hw.ici_bw + a["collective_bytes_dcn"] / hw.dcn_bw
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    bound_s = max(terms.values())
    out = {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "bound_s": bound_s,
        "dot_flops_per_device": a["dot_flops"],
        "hbm_bytes_per_device": a["hbm_bytes"],
        "ici_bytes": a["collective_bytes_ici"],
        "dcn_bytes": a["collective_bytes_dcn"],
        "collectives": a["collective_op_counts"],
    }
    if cfg is not None and shape is not None:
        mf = model_flops(cfg, shape)
        out["model_flops_total"] = mf
        out["model_flops_per_device"] = mf / devices
        out["useful_ratio"] = (mf / devices) / max(a["dot_flops"], 1.0)
        # roofline fraction: useful work time over the actual bound
        out["roofline_fraction"] = (mf / devices / hw.peak_flops) / max(bound_s, 1e-30)
    return out


def analyze_report_dir(dryrun_dir: str, out_md: Optional[str] = None,
                       hw: Hardware = H100_SXM) -> List[Dict]:
    """The roofline table of every dry-run record (``*.json`` with an
    ``analysis`` block) in ``dryrun_dir``."""
    from ..configs import get_config, get_reduced_config
    from ..models.config import SHAPES

    rows = []
    for jpath in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(jpath) as f:
            meta = json.load(f)
        if "analysis" not in meta:
            continue
        arch = meta["arch"].replace("-", "_").replace(".", "_")
        reduced = meta.get("flags", {}).get("reduced", False)
        cfg = (get_reduced_config if reduced else get_config)(arch)
        terms = roofline_terms(meta["analysis"], meta["devices"], cfg,
                               SHAPES[meta["shape"]], hw)
        rows.append({**meta, **terms, "file": os.path.basename(jpath)})

    if out_md:
        os.makedirs(os.path.dirname(out_md) or ".", exist_ok=True)
        with open(out_md, "w") as f:
            f.write(_to_markdown(rows))
    return rows


def _fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}us"


def _to_markdown(rows: List[Dict]) -> str:
    hdr = ("| cell | mesh | compute | memory | collective | bound | "
           "MODEL/HLO flops | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|\n")
    lines = [hdr]
    for r in rows:
        lines.append(
            f"| {r['arch']} x {r['shape']} | {r['mesh']} | "
            f"{_fmt_s(r['compute_s'])} | {_fmt_s(r['memory_s'])} | "
            f"{_fmt_s(r['collective_s'])} | **{r['dominant']}** | "
            f"{r.get('useful_ratio', 0):.2f} | "
            f"{r.get('roofline_fraction', 0) * 100:.1f}% |\n")
    return "".join(lines)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    d = argv[0] if argv else "reports/dryrun_torch"
    rows = analyze_report_dir(d, out_md="reports/roofline_torch.md")
    print(_to_markdown(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
