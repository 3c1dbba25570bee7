"""Checkpointing: atomic, manifest-verified, async-capable.  Port of
``repro.checkpoint.ckpt`` with its layout:

  <dir>/step_<N:08d>.tmp/        (written first)
      arrays.npz                 flat {path: array}
      manifest.json              step, keys, shapes, dtypes, crc32 per
                                 array, extra
  <dir>/step_<N:08d>/            (renamed on completion)

Keys are the port's tree paths (``layers/3/attn/wq``, ``tree.SEP``).
numpy has no bf16: a bf16 leaf is stored as its uint16 bits, with
"bfloat16" in the manifest, and reinterpreted on restore.  ``restore``
rebuilds the tree of ``like`` on each leaf's device and dtype (placing
shards on a mesh waits for ROADMAP A.6).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch

from .. import tree as T

BF16 = "bfloat16"


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the numpy array stored, and its manifest dtype."""
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def save(directory: str, step: int, tree, extra: dict | None = None) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat, dtypes = {}, {}
    for key, leaf in T.leaves_with_paths(tree):
        flat[key], dtypes[key] = _host(leaf)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": dtypes,
        "crc32": {k: zlib.crc32(np.ascontiguousarray(v).tobytes())
                  for k, v in flat.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


class AsyncSaver:
    """Off-thread saver: training goes on while the previous checkpoint
    drains to disk (one in flight).  ``save`` copies the tree to host
    memory first: the trainer updates its parameters in place."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, directory: str, step: int, tree,
             extra: dict | None = None) -> None:
        self.wait()
        host = T.tree_map(lambda t: torch.as_tensor(t).detach().to(
            "cpu", copy=True), tree)

        def work():
            try:
                save(directory, step, host, extra)
            except BaseException as e:   # raised again by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore(directory: str, step: int, like, verify: bool = True
            ) -> tuple[dict, dict]:
    """(the tree of ``like`` read from step ``step``, the manifest's
    extra): each leaf checked against the manifest's crc32 (``verify``)
    and ``like``'s shape, then cast to ``like``'s dtype on its device."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in manifest["keys"]}
    if verify:
        for k, arr in arrays.items():
            if zlib.crc32(np.ascontiguousarray(arr).tobytes()) \
                    != manifest["crc32"][k]:
                raise IOError(f"checkpoint corruption: crc mismatch at {k}")
    out = []
    for key, leaf in T.leaves_with_paths(like):
        arr = arrays[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"model shape {tuple(leaf.shape)}")
        t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
             if manifest["dtypes"][key] == BF16 else torch.from_numpy(arr))
        out.append(t.to(device=leaf.device, dtype=leaf.dtype))
    return T.unflatten(like, out), manifest["extra"]
