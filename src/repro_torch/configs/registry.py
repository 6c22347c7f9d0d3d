"""Architecture registry: ``--arch <id>`` resolution.

``long_500k`` applicability: only the sub-quadratic families (ssm,
hybrid) run the 524288-token decode shape; the 8 pure full-attention
architectures skip it (recorded in DESIGN.md §4).
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from repro_torch.models.config import ModelConfig
from repro_torch.models.model_api import SHAPES

_MODULES: Dict[str, str] = {
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b_a17b",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen1_5_7b",
    "gemma-7b": "repro_torch.configs.gemma_7b",
    "mistral-nemo-12b": "repro_torch.configs.mistral_nemo_12b",
    "llama3.2-1b": "repro_torch.configs.llama3_2_1b",
    "zamba2-2.7b": "repro_torch.configs.zamba2_2_7b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
}

ARCHS: Tuple[str, ...] = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    try:
        mod = _MODULES[arch]
    except KeyError:
        raise KeyError(f"unknown arch '{arch}'; available: {list(ARCHS)}") from None
    return importlib.import_module(mod).CONFIG


def list_archs() -> List[str]:
    return list(ARCHS)


def shape_applicable(cfg: ModelConfig, shape_name: str) -> bool:
    """Which (arch x shape) dry-run cells run (see DESIGN.md §4)."""
    if shape_name == "long_500k":
        return cfg.family in ("ssm", "hybrid")
    return True


def all_cells() -> List[Tuple[str, str]]:
    cells = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            if shape_applicable(cfg, shape):
                cells.append((arch, shape))
    return cells
