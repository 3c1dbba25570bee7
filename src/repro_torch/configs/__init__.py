"""Architecture registry (``--arch <id>``) and the paper's workload DAGs
(``paper_models``).

Copies of ``repro.configs``: the ten arch files keep the reference's
code with their import rewritten (``tests/test_torch_compiler.py`` locks
them); ``get_config`` / ``ARCH_IDS`` / ``all_configs`` resolve an arch
the same way.  ``SHAPES`` / ``applicable`` / ``input_specs``
(``configs.shapes``) are the dry run's input-shape cells.
"""

from __future__ import annotations

import importlib

from ..models.config import ArchConfig
from .shapes import SHAPES, ShapeSpec, applicable, input_specs  # noqa: F401

_ARCH_MODULES = {
    "internlm2-20b": "internlm2_20b",
    "qwen3-4b": "qwen3_4b",
    "qwen1.5-4b": "qwen1_5_4b",
    "nemotron-4-15b": "nemotron_4_15b",
    "whisper-medium": "whisper_medium",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "llama4-maverick-400b-a17b": "llama4_maverick",
    "dbrx-132b": "dbrx_132b",
    "mamba2-2.7b": "mamba2_2_7b",
    "qwen2-vl-2b": "qwen2_vl_2b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str, reduced: bool = False) -> ArchConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    mod = importlib.import_module(f".{_ARCH_MODULES[arch]}", __name__)
    return mod.reduced() if reduced else mod.config()


def all_configs(reduced: bool = False) -> dict[str, ArchConfig]:
    return {a: get_config(a, reduced) for a in ARCH_IDS}
