"""One run of one cell: set-up, the window, the comparison, the result line.

Everything specific is found by name under the root of a checkout:
``BENCHMARK.json`` lists the cells and metrics; a cell's configuration
is the file its ``configs`` entry names, its traffic mix
``h100bench/traffic/<mix>.json`` (whose ``kind`` names the driver
``h100bench/drivers/<kind>.py``), its limits ``h100bench/limits/<cell>.json``,
and each per-layer metric's reader ``h100bench/metrics/<metric>.py``.

A driver module gives ``setup(ctx)``, ``item(ctx, state, i)`` (one timed
item, returning its tokens), ``check_items(ctx)`` (the items the check
needs after set-up, where a run has no window), ``check(ctx, state)``
(frees the program's state and returns the compared numbers),
``control(ctx, state)`` (after ``check``: the float8 control's numbers),
``end_to_end(ctx, items)`` and ``work(ctx, state, items)`` (the yardstick
quantities the per-layer readers use).  ``failed`` is 1 where the
checked sample is out of its limits.

The window opens at the first item's dispatch and closes at the end of
the first item that ends ``seconds`` or more after it opened; items run
back to back (a closed loop).  A rate is all the window's tokens over its
span; a tail is the tail of all its items.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from h100bench import program
from h100bench.trace import WINDOW, Profiler, span

#: top-level module names the run's process may not hold once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Item:
    t0: float
    t1: float
    tokens: int


@dataclasses.dataclass
class Context:
    root: Path
    cell: Dict
    spec: Dict  # the configuration file
    widths: Dict  # what the reference and the formulas read
    traffic: Dict
    seed: int
    device: torch.device
    trace: bool
    log: Callable[[str], None] = print

    def span(self, name: str):
        return span(name, self.trace)


@dataclasses.dataclass
class Run:
    """What a per-layer reader sees."""
    ctx: Context
    items: List[Item]
    span_s: float
    work: Dict[str, float]
    counters: Dict[str, int]
    trace: Any  # h100bench.trace.Trace


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def widths(spec: Dict) -> Dict:
    """The configuration file's widths with its family and dtype."""
    return dict(spec["widths"], family=spec["family"], dtype=spec["dtype"])


def context(root: Path, workload: str, seed: int, device, trace: bool,
            log: Callable[[str], None] = print) -> Context:
    bench = read_json(root / "BENCHMARK.json")
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(cells)}")
    cell = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    spec = read_json(root / cfg["file"])
    traffic = read_json(root / "h100bench" / "traffic" / f"{cell['traffic']}.json")
    return Context(root, cell, spec, widths(spec), traffic, seed, torch.device(device), trace, log)


def driver(ctx: Context):
    kind = ctx.traffic["kind"]
    return load_module(ctx.root / "h100bench" / "drivers" / f"{kind}.py", f"h100bench_driver_{kind}")


def limits(ctx: Context) -> Dict[str, float]:
    lim = read_json(ctx.root / "h100bench" / "limits" / f"{ctx.cell['name']}.json")
    return {k: v["limit"] for k, v in lim.items()}


def metrics_of(ctx: Context) -> Dict[str, List[Dict]]:
    """The cell's end-to-end and per-layer metrics from ``BENCHMARK.json``."""
    bench = read_json(ctx.root / "BENCHMARK.json")
    name = ctx.cell["name"]
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {"end_to_end": e2e, "per_layer": per}


def window(ctx: Context, drv, state, seconds: float) -> List[Item]:
    items: List[Item] = []
    t_open = None
    with ctx.span(WINDOW):
        while True:
            t0 = time.perf_counter()
            t_open = t0 if t_open is None else t_open
            n = drv.item(ctx, state, len(items))
            t1 = time.perf_counter()
            items.append(Item(t0, t1, n))
            if t1 - t_open >= seconds:
                break
    return items


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (the process's modules),
    each compared whole: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def device_info(ctx: Context, chips: int) -> Dict:
    if ctx.device.type != "cuda":
        return {"platform": ctx.device.type, "kind": ctx.device.type, "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(ctx.device))}


def sync(ctx: Context) -> None:
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)


def release(ctx: Context, state, *names: str) -> None:
    """Frees the program's state (``state``'s attributes ``names``) before
    the reference runs, so that the reference neither sets the peak nor
    runs short of memory."""
    for n in names:
        delattr(state, n)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None, log: Callable[[str], None] = print) -> Dict:
    """One run of ``workload``; returns the result line's object (its
    compared numbers last, under ``checks``)."""
    t_start = time.perf_counter() if t_start is None else t_start
    ctx = context(root, workload, seed, device, trace, log)
    drv = driver(ctx)
    lim = limits(ctx)
    want = metrics_of(ctx)
    state = drv.setup(ctx)
    sync(ctx)
    before = program.counters()
    prof = Profiler() if trace else None
    if prof:
        prof.__enter__()
    t_open = time.perf_counter()
    try:
        items = window(ctx, drv, state, seconds)
    finally:
        if prof:
            prof.__exit__(None, None, None)
    after = program.counters()
    setup_s = t_open - t_start
    span_s = items[-1].t1 - items[0].t0
    secs = [it.t1 - it.t0 for it in items]
    log(f"[window] {len(items)} items in {span_s:.4f} s after {setup_s:.4f} s of set-up; "
        f"item s median {nearest_rank(secs, 0.5):.5f}, max {max(secs):.5f}")
    device_ = device_info(ctx, ctx.cell["chips"])
    work = drv.work(ctx, state, items)
    e2e = drv.end_to_end(ctx, items)
    e2e["setup_s"] = setup_s
    checks = drv.check(ctx, state)
    numbers = {k: {"value": v, "limit": lim[k]} for k, v in checks.items()}
    correct = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in numbers.values())
    out: Dict[str, Any] = {"correct": correct, "attempted": len(items),
                           "failed": 0 if correct else 1}
    if trace:
        tr = prof.trace()
        if tr is None:
            raise RuntimeError("the trace holds no window span")
        run = Run(ctx, items, span_s, work,
                  {k: after[k] - before[k] for k in after}, tr)
        out["metrics"] = per_layer_values(run, want["per_layer"])
        device_["busy_s"], device_["window_s"] = tr.busy_s, tr.window_s
        out["device"] = device_
        out["breakdown"] = tr.breakdown()
    else:
        out["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                          for m in want["end_to_end"]}
        out["device"] = device_
    out["checks"] = numbers
    return out


def per_layer_values(run: Run, metrics: List[Dict]) -> Dict[str, Dict]:
    """Each per-layer metric's reader ``h100bench/metrics/<name>.py`` over
    the traced run; a reader that finds nothing returns None and its metric
    is left out."""
    vals = {}
    for m in metrics:
        reader = load_module(run.ctx.root / "h100bench" / "metrics" / f"{m['name']}.py",
                             f"h100bench_metric_{m['name'].replace('.', '_')}")
        v = reader.read(run)
        if v is not None:
            vals[m["name"]] = {"value": v, "unit": m["unit"]}
    return vals


def nearest_rank(values: List[float], q: float) -> float:
    """The ``q`` quantile (0 < q <= 1) by nearest rank."""
    vals = sorted(values)
    return vals[max(0, math.ceil(q * len(vals)) - 1)]
