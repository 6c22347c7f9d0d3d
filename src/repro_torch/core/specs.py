"""Tiny call-style spec strings for grid dimensions.

Campaign grids name their axes with strings — ``"poisson"``,
``"mmpp(burstiness=4,on_fraction=0.2)"``, ``"terastal(backfill_mode=paper)"``
— so trial specs stay picklable (process-pool workers) and printable
(result rows).  This module parses that one shape: ``name`` or
``name(key=value, ...)`` with bool/int/float/str literals.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

_SPEC_RE = re.compile(r"^\s*([A-Za-z_][\w.-]*)\s*(?:\((.*)\))?\s*$")


def _parse_literal(text: str) -> Any:
    t = text.strip()
    low = t.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        pass
    return t.strip("\"'")


def parse_call_spec(spec: str) -> Tuple[str, Dict[str, Any]]:
    """``"name"`` or ``"name(k=v, ...)"`` -> ``(name, {k: v, ...})``."""
    m = _SPEC_RE.match(spec)
    if not m or (m.group(2) is None and "(" in spec):
        raise ValueError(f"malformed spec {spec!r}; expected 'name' or 'name(k=v, ...)'")
    name, argstr = m.group(1), m.group(2)
    kwargs: Dict[str, Any] = {}
    if argstr and ("(" in argstr or ")" in argstr):
        # greedy (.*) would swallow stray parens ("periodic(jitter=0.5))")
        # into a string value and defer the crash deep into a pool worker
        raise ValueError(f"malformed spec {spec!r}: unbalanced or nested parentheses")
    if argstr and argstr.strip():
        for part in argstr.split(","):
            if "=" not in part:
                raise ValueError(f"malformed spec {spec!r}: argument {part!r} is not key=value")
            k, v = part.split("=", 1)
            kwargs[k.strip()] = _parse_literal(v)
    return name, kwargs


def format_call_spec(name: str, kwargs: Dict[str, Any]) -> str:
    if not kwargs:
        return name
    inner = ",".join(f"{k}={v}" for k, v in sorted(kwargs.items()))
    return f"{name}({inner})"


def format_dag_edges(preds) -> str:
    """Compact positional edge spec for a layer DAG's predecessor lists:
    nodes joined with ``;``, each node's predecessor ids joined with
    ``,``, a source left empty — ``((), (0,), (0,), (1, 2))`` becomes
    ``";0;0;1,2"``.  Printable in result rows and benchmark labels the
    same way call specs are."""
    return ";".join(",".join(str(p) for p in ps) for ps in preds)


def parse_dag_edges(spec: str) -> Tuple[Tuple[int, ...], ...]:
    """Inverse of :func:`format_dag_edges` (structure only — acyclicity
    and id validation happen in ``repro_torch.core.dag.LayerDag``)."""
    out = []
    for l, part in enumerate(spec.split(";")):
        part = part.strip()
        try:
            out.append(
                tuple(int(p) for p in part.split(",")) if part else ()
            )
        except ValueError:
            raise ValueError(
                f"malformed DAG edge spec {spec!r}: node {l} part {part!r} "
                "is not a comma-separated id list"
            ) from None
    return tuple(out)
