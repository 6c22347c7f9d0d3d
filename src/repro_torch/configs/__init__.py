"""Exact configs for the ten assigned architectures + registry.

Every config is selectable via ``--arch <id>`` in the launchers.  Each
module exposes ``CONFIG`` (the full published architecture) — smoke tests
use ``CONFIG.reduced()``.
"""

from repro_torch.configs.registry import ARCHS, get_config, list_archs

__all__ = ["ARCHS", "get_config", "list_archs"]
