"""Configurations only the port runs, looked up beside the registry.

``configs.registry`` is a verbatim copy of the JAX package's and holds its
ten architectures.  A configuration of a family the JAX package lacks
(zamba2 as released: ``models.zamba2``; Nemotron-H: ``models.nemotron_h``;
DeepSeek-V3: ``models.deepseek_v3``)
is found here instead, so that the registry, and every test that holds the
port to it, stays as it is.
"""

from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.models.config import ModelConfig

_MODULES: Dict[str, str] = {
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "nemotron-3-nano-30b-a3b": "repro_torch.configs.nemotron_3_nano_30b_a3b",
    "deepseek-v3": "repro_torch.configs.deepseek_v3",
}

PORT_ARCHS: Tuple[str, ...] = tuple(_MODULES)


def get_port_config(arch: str) -> ModelConfig:
    try:
        mod = _MODULES[arch]
    except KeyError:
        raise KeyError(f"unknown port-only arch '{arch}'; available: {list(PORT_ARCHS)}") from None
    return importlib.import_module(mod).CONFIG
