"""A throwaway checkout for the tests: the benchmark's files, plus small
configurations, mixes, cells, limits and a per-layer metric added as new
files and entries only (no file of the benchmark edited)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for p in (REPO / "src", REPO):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

#: small widths of the benchmarked family; every key that differs from
#: the registry's configuration is listed in ``reduced``
TINY = {
    "tiny-mamba2": dict(arch="mamba2-1.3b", family="ssm", widths=dict(
        n_layers=2, d_model=64, vocab_size=256, ssm_state=16, ssm_headdim=16, ssm_expand=2,
        ssm_chunk=16, ssm_conv_width=4, tie_embeddings=True, norm_eps=1e-5)),
}
OPT = dict(lr=3e-4, warmup_steps=0, total_steps=100000, b1=0.9, b2=0.95, eps=1e-8,
           weight_decay=0.1, clip_norm=1.0)
MIXES = {
    "tiny-prefill": dict(kind="prefill", batch=4, seq_len=64, pool=2, check_rows=3),
    "tiny-train": dict(kind="train", batch=2, seq_len=32, pool=8, checked_steps=3, opt=OPT),
}
CELLS = [("tiny-mamba2", "tiny-prefill"), ("tiny-mamba2", "tiny-train")]
#: limits of the small cells, from CPU readings of bf16 runs on six seeds
#: (prefill 0.008-0.011; loss 6e-6 to 8e-5, first gradient 0.0017-0.0031,
#: change 0.002-0.012), each well below; the float8 control reads above one
#: of them on every seed (prefill 0.072-0.116, first gradient 0.013-0.060)
LIMITS = {"prefill": {"logits_err": 0.04},
          "train": {"loss_gap": 2e-4, "grad_gap": 0.008, "update_gap": 0.025}}
#: each kind's end-to-end metrics, added as entries where BENCHMARK.json has none
E2E = {"prefill": [("prefill_tok_per_s", "tokens/s", "higher")],
       "train": [("train_tok_per_s", "tokens/s", "higher")]}
#: a per-layer metric added as a file: the tokens of the traced window
METRIC = '''"""tokens_seen.prefill: the window's prompt tokens (a test's metric)."""


def read(run):
    return float(sum(it.tokens for it in run.items))
'''


def cell_name(config: str, mix: str) -> str:
    return f"{config}.{mix}"


def make_root(tmp: Path, dtype: str = "bfloat16") -> Path:
    root = tmp / "checkout"
    shutil.copytree(REPO / "h100bench", root / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    keep = {"tie_embeddings", "norm_eps", "ssm_expand", "ssm_conv_width"}
    for name, t in TINY.items():
        reduced = [k for k in t["widths"] if k not in keep]
        spec = dict(name=name, dtype=dtype, source="a test", reduced=reduced, assumed={},
                    departures=[], **t)
        (root / "h100bench" / "configs" / f"{name}.json").write_text(json.dumps(spec))
        bench["configs"].append({"name": name, "source": "a test",
                                 "file": f"h100bench/configs/{name}.json", "reduced": reduced,
                                 "why": "a test"})
    for name, mix in MIXES.items():
        (root / "h100bench" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for config, mix in CELLS:
        name, kind = cell_name(config, mix), MIXES[mix]["kind"]
        bench["workloads"].append({"name": name, "config": config, "traffic": mix, "chips": 1,
                                   "why": "a test"})
        (root / "h100bench" / "limits" / f"{name}.json").write_text(
            json.dumps({k: {"limit": v} for k, v in LIMITS[kind].items()}))
        for metric, unit, better in E2E[kind]:
            entry = next((m for m in bench["end_to_end"] if m["name"] == metric), None)
            if entry is None:
                entry = {"name": metric, "unit": unit, "better": better, "bound": 0.25,
                         "source": "host_clock", "workloads": []}
                bench["end_to_end"].append(entry)
            entry["workloads"].append(name)
        for m in bench["per_layer"]:
            if kind in m["name"]:
                m["workloads"].append(name)
    (root / "h100bench" / "metrics" / "tokens_seen.prefill.py").write_text(METRIC)
    bench["per_layer"].append({"name": "tokens_seen.prefill", "unit": "tokens", "better": "higher",
                               "source": "program_counter", "layer": "prefill step",
                               "moves": "prefill_tok_per_s",
                               "workloads": [cell_name(c, "tiny-prefill") for c in TINY]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
