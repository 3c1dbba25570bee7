"""Carries tensors from the reference onto the port's device.

The two packages compute on the same numbers only if they start from the
same numbers: ``WorkloadGraph.random_inputs(seed)`` (numpy, seeded) makes
the inputs and weights, and ``inputs_to_torch`` checks each against the
compiled memory map and puts it on the device.  ``resolve_device`` is the
port's one rule for where an entry point runs: the CUDA card unless the
caller names another device, and an error where there is no card.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Mapping

import numpy as np
import torch

if TYPE_CHECKING:
    from .core.codegen import MemoryMap


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the CUDA card; raises where CUDA is absent.  Only an
    explicit device (``"cpu"`` in the tests) runs elsewhere."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on a CUDA device and none is "
                           "available; pass device='cpu' to run the plain "
                           "versions on the CPU")
    return dev


def inputs_to_torch(inputs: Mapping[str, np.ndarray | torch.Tensor],
                    memmap: MemoryMap,
                    device: str | torch.device | None = None
                    ) -> dict[str, torch.Tensor]:
    """fp32, contiguous copies of ``inputs`` on ``device``, each checked
    against its ``(rows, cols)`` in the memory map."""
    dev = resolve_device(device)
    out = {}
    for name, arr in inputs.items():
        if name not in memmap.by_name:
            raise KeyError(f"{name!r} is not a tensor of this program")
        rows, cols = memmap.by_name[name][1:]
        if tuple(arr.shape) != (rows, cols):
            raise ValueError(f"{name}: expected {(rows, cols)}, got "
                             f"{tuple(arr.shape)}")
        out[name] = torch.as_tensor(arr).to(device=dev, dtype=torch.float32,
                                            copy=True).contiguous()
    return out
