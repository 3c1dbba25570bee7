"""Carries tensors from the reference onto the port's device.

The two packages compute on the same numbers only if they start from the
same numbers: ``WorkloadGraph.random_inputs(seed)`` (numpy, seeded) makes
the inputs and weights, and ``inputs_to_torch`` checks each against the
compiled memory map and puts it on the device.  ``params_from_jax``
carries a language model's parameters, made by ``repro.models.lm.init``
and handed over as numpy arrays, into the port's per-layer layout;
``encdec_params_from_jax`` does the same for ``repro.models.encdec.init``.
``resolve_device`` is the port's one rule for where an entry point runs:
the CUDA card unless the caller names another device, and an error where
there is no card.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Mapping

import numpy as np
import torch

from .tree import tree_map

if TYPE_CHECKING:
    from .core.codegen import MemoryMap
    from .models.config import ArchConfig


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


def _leaf_to_torch(arr: Any, device: torch.device) -> torch.Tensor:
    """A copy of one array on ``device``, in its own dtype (bf16 arrays
    arrive as numpy's ml_dtypes bfloat16, which torch cannot read)."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.tensor(arr.astype(np.float32), device=device
                            ).to(torch.bfloat16)
    return torch.tensor(arr, device=device)


def params_from_jax(cfg: ArchConfig, tree: Mapping,
                    device: str | torch.device | None = None) -> dict:
    """The port's parameters from the reference's tree.

    ``tree`` is ``repro.models.lm.init(cfg, key)[0]`` with its leaves as
    numpy arrays (or anything ``np.asarray`` takes): ``embed``,
    ``lm_head``, ``final_norm`` and ``blocks/pos{i}/...`` stacked with a
    leading dim of ``cfg.n_blocks``.  Returns ``{"embed", "lm_head",
    "final_norm", "layers": [one dict per layer]}`` on ``device``, layer
    ``b * pattern_len + i`` from ``blocks/pos{i}[b]``.  Weights keep the
    reference's ``(in, out)`` layout, applied as ``x @ w``; dtypes are
    kept.  Any tree of the parameters' structure crosses the same way:
    the reference's gradients (``jax.grad`` of its loss) or AdamW moments
    land leaf for leaf on the port's parameters.
    """
    dev = resolve_device(device)
    stacked = [_unstack(cfg, tree["blocks"][f"pos{pi}"], cfg.n_blocks)
               for pi in range(cfg.pattern_len)]
    layers = [tree_map(lambda a, b=b: _leaf_to_torch(a[b], dev), stacked[pi])
              for b in range(cfg.n_blocks) for pi in range(cfg.pattern_len)]
    return {**_ends(cfg, tree, ("final_norm",), dev), "layers": layers}


def encdec_params_from_jax(cfg: ArchConfig, tree: Mapping,
                           device: str | torch.device | None = None) -> dict:
    """The port's encoder-decoder parameters from the reference's tree.

    ``tree`` is ``repro.models.encdec.init(cfg, key)[0]`` with numpy
    leaves: ``embed``, ``lm_head``, ``enc_norm``, ``final_norm``, and
    ``encoder`` / ``decoder`` stacked over ``cfg.encoder_layers`` /
    ``cfg.n_layers``.  Returns the same keys on ``device`` with
    ``encoder`` and ``decoder`` as lists of one dict per layer; layouts
    and dtypes are kept."""
    dev = resolve_device(device)
    out = _ends(cfg, tree, ("enc_norm", "final_norm"), dev)
    for key, n in (("encoder", cfg.encoder_layers), ("decoder", cfg.n_layers)):
        stacked = _unstack(cfg, tree[key], n)
        out[key] = [tree_map(lambda a, i=i: _leaf_to_torch(a[i], dev),
                              stacked) for i in range(n)]
    return out


def _ends(cfg: ArchConfig, tree: Mapping, norms: tuple[str, ...],
          dev: torch.device) -> dict:
    """``embed``, ``lm_head`` and the named norms on ``dev``, the first two
    checked against the config."""
    V, D = cfg.vocab_size, cfg.d_model
    embed, head = np.asarray(tree["embed"]), np.asarray(tree["lm_head"])
    if embed.shape != (V, D) or head.shape != (D, V):
        raise ValueError(f"{cfg.name}: embed {embed.shape} / lm_head "
                         f"{head.shape} do not match vocab {V}, d_model {D}")
    return {"embed": _leaf_to_torch(embed, dev),
            "lm_head": _leaf_to_torch(head, dev),
            **{n: tree_map(lambda a: _leaf_to_torch(a, dev), tree[n])
               for n in norms}}


def _unstack(cfg: ArchConfig, tree: Mapping, n: int) -> dict:
    """``tree``'s leaves as numpy arrays, each checked to be stacked over
    ``n`` layers."""
    stacked = tree_map(np.asarray, tree)

    def check(arr):
        if arr.ndim == 0 or arr.shape[0] != n:
            raise ValueError(f"{cfg.name}: a layer leaf of shape {arr.shape} "
                             f"is not stacked over {n} layers")
    tree_map(check, stacked)
    return stacked
