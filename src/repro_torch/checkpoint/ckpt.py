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
rebuilds the tree of ``like`` on each leaf's device and dtype, and places
each leaf on a mesh where ``shardings`` names one: a checkpoint saved
from any mesh, or from none, restores onto any other (the elastic
rescale).

A tree of DTensors is gathered one leaf at a time on the calling thread
(``full_tensor()`` is a collective: on the saver's thread the ranks could
wait on each other).  Each gathered leaf is copied to host memory on rank
0 and freed before the next is gathered, so no rank holds more than one
whole leaf on its device, and the other ranks keep nothing.  Rank 0 alone
writes, and the ranks meet at a barrier once it is written.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .. import tree as T
from ..parallel.sharding import place

BF16 = "bfloat16"


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as the numpy array stored, and its manifest dtype."""
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr))


def _distributed(tree) -> bool:
    return any(isinstance(t, DTensor) for t in T.leaves(tree))


def _writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(tree):
    """The tree copied to host memory, one leaf at a time: a DTensor leaf
    is gathered whole (a collective: every rank calls this), copied, and
    freed before the next leaf.  Only the writer keeps the copies; the
    other ranks get None."""
    keep = _writer()
    out = []
    for leaf in T.leaves(tree):
        t = leaf.full_tensor() if isinstance(leaf, DTensor) else leaf
        out.append(torch.as_tensor(t).detach().to("cpu", copy=True)
                   if keep else None)
        del t
    return T.unflatten(tree, out) if keep else None


def save(directory: str, step: int, tree, extra: dict | None = None) -> str:
    """Write ``tree`` as step ``step``; DTensor leaves are gathered leaf by
    leaf and rank 0 writes (every rank returns once it is written)."""
    if _distributed(tree):
        host = _to_host(tree)
        if host is not None:
            _write(directory, step, host, extra)
        dist.barrier()
        return os.path.join(directory, f"step_{step:08d}")
    return _write(directory, step, tree, extra)


def _write(directory: str, step: int, tree, extra: dict | None) -> str:
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
        "crc32": {k: _crc(v) for k, v in flat.items()},
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
        self._meet = False        # the ranks meet in wait()

    def save(self, directory: str, step: int, tree,
             extra: dict | None = None) -> None:
        """Copy ``tree`` to host memory (DTensors gathered here, leaf by
        leaf, on the calling thread, by every rank) and write it off
        thread (rank 0 alone)."""
        self.wait()
        self._meet = _distributed(tree)
        host = _to_host(tree)
        if host is None:
            return

        def work():
            try:
                _write(directory, step, host, extra)
            except BaseException as e:   # raised again by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._meet:
            self._meet = False
            dist.barrier()
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


def restore(directory: str, step: int, like, verify: bool = True,
            shardings=None) -> tuple[dict, dict]:
    """(the tree of ``like`` read from step ``step``, the manifest's
    extra): each leaf checked against the manifest's crc32 (``verify``)
    and ``like``'s shape, then cast to ``like``'s dtype on its device.  A
    leaf is placed on a mesh by its ``shardings`` entry (a tree of
    ``sharding.NamedSharding`` or None, shaped like ``like``): each rank
    takes its block."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in manifest["keys"]}
    if verify:
        for k, arr in arrays.items():
            if _crc(arr) != manifest["crc32"][k]:
                raise IOError(f"checkpoint corruption: crc mismatch at {k}")
    shs = (T.leaves(shardings) if shardings is not None
           else [None] * len(T.leaves(like)))
    out = []
    for (key, leaf), sh in zip(T.leaves_with_paths(like), shs):
        arr = arrays[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"model shape {tuple(leaf.shape)}")
        t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
             if manifest["dtypes"][key] == BF16 else torch.from_numpy(arr))
        t = t.to(dtype=leaf.dtype)
        if sh is not None:
            dev = leaf.device if leaf.device.type != "meta" \
                else sh.mesh.device_type
            out.append(place(t, sh, dev))
        else:
            out.append(t.to(device=leaf.device))
    return T.unflatten(like, out), manifest["extra"]
