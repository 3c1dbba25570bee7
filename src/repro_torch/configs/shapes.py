"""The assigned input-shape set and per-cell applicability: port of
``repro.configs.shapes``.

  train_4k     seq 4096,   global_batch 256   (training)
  prefill_32k  seq 32768,  global_batch 32    (inference prefill)
  decode_32k   seq 32768,  global_batch 128   (decode: 1 new token,
                                               KV cache of seq_len)
  long_500k    seq 524288, global_batch 1     (long-context decode)

``long_500k`` needs sub-quadratic sequence mixing: it runs only for the
SSM and hybrid families (mamba2-2.7b, jamba-1.5-large-398b) and is
skipped, with the reason recorded, for the 8 pure full-attention archs.
Every arch runs the decode shapes (whisper decodes with its decoder).
``input_specs`` gives ``meta`` tensors (shape and dtype, no storage) in
the reference's dtypes; the launch layer builds parameters and caches on
``meta`` too (``launch.steps``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.config import ArchConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.name == "long_500k" and not cfg.attention_free_or_hybrid:
        return False, ("skip: pure full-attention arch — 512k decode "
                       "needs sub-quadratic sequence mixing")
    return True, ""


def enc_len(cfg: ArchConfig, shape: ShapeSpec) -> int:
    """Encoder frames of an encoder-decoder's cell (the reference's
    ``_enc_len``): the audio stub's frames scale with the assigned
    seq_len, so whisper's encoder reads 32,768 frames at prefill_32k."""
    return shape.seq_len


def input_specs(cfg: ArchConfig, shape: ShapeSpec,
                compute_dtype: torch.dtype | None = None
                ) -> dict[str, torch.Tensor]:
    """``meta`` stand-ins for every model input of this cell: tokens and
    labels int32, whisper's frames (B, ``enc_len``, d_model) in the
    compute dtype; a decode cell takes one token a row."""
    B, S = shape.global_batch, shape.seq_len
    cd = compute_dtype or getattr(torch, cfg.compute_dtype)

    def spec(shape_, dtype=torch.int32):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": spec((B, 1))}
    out = {}
    if cfg.is_encdec:
        out["frames"] = spec((B, enc_len(cfg, shape), cfg.d_model), cd)
    out["tokens"] = spec((B, S))
    if shape.kind == "train":
        out["labels"] = spec((B, S))
    return out
