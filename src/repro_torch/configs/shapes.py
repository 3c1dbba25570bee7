"""A step's input shape: the reference's ``ShapeSpec``
(``repro.configs.shapes``).  Its assigned shape cells, their
applicability and ``input_specs`` wait for the multi-device dry run
(ROADMAP A.6)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode
