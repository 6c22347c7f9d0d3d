"""Roofline report: per (arch x shape) three-term analysis.

Torch port: a copy of the JAX package's ``launch/roofline.py`` on the
H100 constants of ``repro_torch.launch.analytics``.  Sources:
 * analytic terms from ``repro_torch.launch.analytics`` (primary; the
   counts are validated against published parameter totals and, in
   ``tests/test_torch_dryrun.py``, against an exact FLOP count of a
   reduced config);
 * the port's dry-run reports (``python -m repro_torch.launch.dryrun
   --all --out results/dryrun_all.jsonl``): per-device argument bytes
   under the fitted spec trees, and the analytic collective estimate.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.roofline --dryrun results/dryrun_all.jsonl
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

from repro_torch.configs import get_config
from repro_torch.configs.registry import all_cells
from repro_torch.launch.analytics import HBM_BW, ICI_BW, PEAK_FLOPS, roofline, total_params


def cost_analysis_dict(counted) -> Dict:
    """The dry run's count as the reference's ``cost_analysis()`` dict.

    ``counted`` is a ``torch.utils.flop_counter.FlopCounterMode`` that
    ran the step, or a report of ``repro_torch.launch.dryrun.run_cell``;
    either way a plain dict with ``"flops"`` comes back, so callers can
    ``.get("flops")`` as they do on the reference's."""
    if hasattr(counted, "get_total_flops"):
        return {"flops": float(counted.get_total_flops())}
    return {"flops": float(counted["flops"])}


def _fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}us"


def load_dryrun(path: Optional[str]) -> Dict:
    """The port's dry-run reports by (arch, shape, mesh), each also under
    the keys ``build_table`` reads: ``memory.argument_bytes`` (per device
    under the fitted spec trees on the report's layout) and
    ``collective_bytes_per_device.total`` (``collective_bytes_est``, an
    estimate: one card runs no collective)."""
    if not path:
        return {}
    out = {}
    try:
        for line in open(path):
            r = json.loads(line)
            if r.get("ok"):
                r.setdefault("memory", {"argument_bytes": r["argument_bytes_per_device"][r["mesh"]]})
                r.setdefault("collective_bytes_per_device", {"total": r["collective_bytes_est"]})
                out[(r["arch"], r["shape"], r["mesh"])] = r
    except FileNotFoundError:
        pass
    return out


def improvement_hint(r) -> str:
    if r.bottleneck == "compute":
        if r.useful_ratio < 0.6:
            return "cut recompute (remat policy) / masked-tile waste in attention"
        return "compute-bound near useful peak; larger per-chip batch or fewer pods"
    if r.bottleneck == "memory":
        return "raise arithmetic intensity: larger decode batch / fuse cache+weight streams / quantize weights"
    return "shrink collective volume: 2D expert sharding, overlap a2a with expert compute, fewer TP hops"


# Best-known per-cell config from the §Perf hillclimb (EXPERIMENTS.md):
# small models train ZeRO-1 (no TP), MoE trains use the a2a EP
# choreography with parallel blocks (on by default in the code), and
# attention-family decode quantizes the KV cache.
def optimized_overrides(arch: str, shape: str) -> dict:
    cfg = get_config(arch)
    out = {}
    if shape == "train_4k":
        if total_params(cfg) < 3e9 and cfg.family in ("ssm", "dense", "encdec"):
            out["fsdp_all_axes"] = True
        if cfg.family in ("dense", "vlm", "moe"):
            out["parallel_block"] = True
    if shape in ("decode_32k", "long_500k") and cfg.family in ("dense", "vlm", "moe", "encdec", "hybrid"):
        out["kv_cache_quant"] = True
    return out


def build_table(
    dryrun_path: Optional[str] = None, n_dev: int = 256, optimized: bool = False
) -> List[dict]:
    import dataclasses as _dc

    dr = load_dryrun(dryrun_path)
    rows = []
    for arch, shape in all_cells():
        cfg = get_config(arch)
        if optimized:
            ov = optimized_overrides(arch, shape)
            if ov:
                cfg = _dc.replace(cfg, **ov)
        r = roofline(cfg, shape, n_dev=n_dev)
        raw = dr.get((arch, shape, "16x16"), {})
        rows.append({
            "arch": arch,
            "shape": shape,
            "bottleneck": r.bottleneck,
            "compute_s": r.compute_s,
            "memory_s": r.memory_s,
            "collective_s": r.collective_s,
            "step_s": r.step_s,
            "useful_flops_6ND": r.useful_flops,
            "computed_flops": r.computed_flops,
            "useful_ratio": r.useful_ratio,
            "roofline_fraction": r.roofline_fraction,
            "dryrun_ok": bool(raw),
            "dryrun_args_gb_per_dev": (raw.get("memory", {}) or {}).get("argument_bytes", 0) / 1e9 if raw else None,
            "dryrun_collective_gb_per_dev": (raw.get("collective_bytes_per_device", {}) or {}).get("total", 0) / 1e9 if raw else None,
            "hint": improvement_hint(r),
        })
    return rows


def print_table(rows: List[dict]) -> None:
    hdr = f"{'arch':>26} {'shape':>11} {'bneck':>10} {'compute':>9} {'memory':>9} {'collect':>9} {'roofline%':>9} {'useful%':>8}"
    print(hdr)
    for r in rows:
        print(
            f"{r['arch']:>26} {r['shape']:>11} {r['bottleneck']:>10} "
            f"{_fmt_s(r['compute_s']):>9} {_fmt_s(r['memory_s']):>9} "
            f"{_fmt_s(r['collective_s']):>9} {100*r['roofline_fraction']:>8.1f}% "
            f"{100*r['useful_ratio']:>7.1f}%"
        )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="results/dryrun_all.jsonl")
    ap.add_argument("--json", default=None)
    ap.add_argument("--optimized", action="store_true",
                    help="apply the best-known per-cell perf config")
    args = ap.parse_args()
    rows = build_table(args.dryrun, optimized=args.optimized)
    print_table(rows)
    if args.json:
        with open(args.json, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
