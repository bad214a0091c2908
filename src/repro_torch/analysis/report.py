"""Tables of a folder of dry-run cell JSONs (``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.analysis.report results/dryrun_torch

The twin of the reference's report over the port's cells, whose keys
differ where XLA's did: ``trace_s`` for ``compile_s`` and
``memory.peak_bytes`` (``MemTracker``'s peak per device) for
``peak_bytes_tpu_corrected``.
"""
from __future__ import annotations

import glob
import json
import os
import sys


def load_cells(out_dir: str) -> list[dict]:
    cells = []
    for f in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(f) as fh:
            cells.append(json.load(fh))
    return cells


def _fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def roofline_table(cells: list[dict], mesh: str = "single_pod") -> str:
    rows = ["| arch | shape | compute | memory | collective | bound | "
            "MODEL/counted flops | roofline-frac | fits HBM |",
            "|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if c["mesh"] != mesh:
            continue
        if c["status"] == "skip":
            rows.append(f"| {c['arch']} | {c['shape']} | — | — | — | "
                        f"skip: {c['reason']} | — | — | — |")
            continue
        if c["status"] != "ok":
            rows.append(f"| {c['arch']} | {c['shape']} | ERROR |||||||")
            continue
        r = c["roofline"]
        m = c["memory"]
        rows.append(
            f"| {c['arch']} | {c['shape']} | {_fmt_s(r['compute_s'])} | "
            f"{_fmt_s(r['memory_s'])} | {_fmt_s(r['collective_s'])} | "
            f"**{r['bottleneck']}** | {r['useful_flops_ratio']:.4f} | "
            f"{r['roofline_fraction']:.4f} | "
            f"{'yes' if m['fits_hbm'] else 'NO'} |")
    return "\n".join(rows)


def dryrun_table(cells: list[dict], mesh: str) -> str:
    rows = ["| arch | shape | trace | peak bytes/dev | "
            "counted flops/dev | coll. bytes/dev | collectives |",
            "|---|---|---|---|---|---|---|"]
    for c in cells:
        if c["mesh"] != mesh or c["status"] != "ok":
            continue
        m, co = c["memory"], c["costs"]
        det = ", ".join(f"{k.replace('all-', 'a')}:{v / 1e9:.1f}G"
                        for k, v in sorted(
                            co["collective_detail"].items()))
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['trace_s']}s | "
            f"{m['peak_bytes'] / 1e9:.1f} GB | "
            f"{co['flops_per_device'] / 1e12:.2f} T | "
            f"{co['collective_bytes_per_device'] / 1e9:.2f} GB | {det} |")
    return "\n".join(rows)


def summarize(out_dir: str) -> dict:
    cells = load_cells(out_dir)
    ok = [c for c in cells if c["status"] == "ok"]
    skip = [c for c in cells if c["status"] == "skip"]
    err = [c for c in cells if c["status"] == "error"]
    worst = sorted((c for c in ok if c["mesh"] == "single_pod"),
                   key=lambda c: c["roofline"]["roofline_fraction"])
    coll = sorted((c for c in ok if c["mesh"] == "single_pod"),
                  key=lambda c: -c["roofline"]["collective_s"])
    return {"ok": len(ok), "skip": len(skip), "error": len(err),
            "worst_fraction": [(c["arch"], c["shape"],
                                c["roofline"]["roofline_fraction"])
                               for c in worst[:5]],
            "most_collective_bound": [(c["arch"], c["shape"],
                                       c["roofline"]["collective_s"])
                                      for c in coll[:5]]}


def main(argv: list[str] | None = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    out_dir = argv[0] if argv else "results/dryrun_torch"
    cells = load_cells(out_dir)
    print("## Roofline (single-pod 16x16)\n")
    print(roofline_table(cells, "single_pod"))
    print("\n## Dry-run detail (single-pod)\n")
    print(dryrun_table(cells, "single_pod"))
    print("\n## Dry-run detail (multi-pod 2x16x16)\n")
    print(dryrun_table(cells, "multi_pod"))
    print("\n## Summary\n")
    print(json.dumps(summarize(out_dir), indent=2))


if __name__ == "__main__":
    main()
