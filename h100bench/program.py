"""The system under test: the port's model from its registry, and its counters.

This module and the drivers are the only parts of the benchmark that
import ``repro_torch``.  The configuration file's widths are asserted
against the registry's configuration; only keys the file lists in
``reduced`` are overridden.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


def model_config(spec: Dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs import get_config

    cfg = get_config(spec["arch"])
    if cfg.family != spec["family"]:
        raise ValueError(f"{spec['arch']} is family {cfg.family}, the file says {spec['family']}")
    over = {"dtype": spec["dtype"]}
    for k, v in spec["widths"].items():
        have = cfg.resolved_head_dim if k == "head_dim" else getattr(cfg, k)
        if k in spec["reduced"]:
            over[k] = v
        elif have != v:
            raise ValueError(f"{spec['arch']}: the registry has {k}={have!r}, the configuration "
                             f"file {v!r}, and {k} is not listed in reduced")
    return dataclasses.replace(cfg, **over)


def build(spec: Dict, device):
    """``(cfg, Model)`` of the port for a configuration file on ``device``."""
    from repro_torch.models.model_api import build_model

    cfg = model_config(spec)
    return cfg, build_model(cfg, device)


def counters() -> Dict[str, int]:
    """The port's kernel launch counters (calls since the process began)."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan_cuda

    return {"ssd_scan": ssd_scan_cuda.launches}
