"""Batched serving driver: static-batch prefill, then lock-step decode.

Port of ``repro.launch.serve``.  Requests of different prompt lengths
are left-padded with token 0 to the longest prompt and prefilled
together with positions ``0 .. plen-1`` and no padding mask, so the
padding is attended to, exactly as in the reference; the whole batch
then decodes one token per step at ``pos = plen + t - 1``.  Sampling is
greedy (``argmax``, the first maximum) or by temperature, drawn from a
``torch.Generator`` seeded with 0 for each ``serve`` call (it cannot
reproduce ``jax.random.categorical``'s bits).  One model replica on one
device, or, with ``mesh``, laid out over a DeviceMesh by the arch's
sharding rules (``parallel.sharding``: prefill and decode run under
them on DTensors, each rank's kernels on its own tensors; every rank
samples the same tokens from the gathered logits).  It serves the dense archs (qwen3-4b, qwen1.5-4b, internlm2-20b,
nemotron-4-15b, and qwen2-vl-2b on text position streams), mamba2-2.7b,
whose cache is a conv window and an SSD state per layer, and the MoE
archs (dbrx-132b, llama4-maverick-400b-a17b, and the attention + SSM
hybrid jamba-1.5-large-398b).  ``cfg`` is any ``ArchConfig``, so a config
cut with ``dataclasses.replace`` is served as it is.  An encoder-decoder
(whisper) has no server here, as in the reference: drive
``models.encdec.prefill`` / ``decode_step``.  The serving phase of
``chip_smoke.py`` runs the six dense and SSM archs at full width and
depth on one H100 (80 GB), and the three MoE archs at full width cut in
depth (dbrx to 8 of 40 layers; llama4 to one block of 24; jamba to one
block of 9 with 12 of its 16 experts), with random weights drawn by
``lm.init_cast``; its times and load peaks are in PERF.md.

Run on the card:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

and over the cards of one host, a rank a card (rank 0 prints):

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch qwen3-4b --model-axis 4
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..configs import get_config
from ..convert import resolve_device
from ..models import lm
from ..models.config import ArchConfig
from ..parallel import sharding as SH
from .mesh import cli_mesh, mesh_device


@dataclass
class Request:
    id: int
    prompt: np.ndarray               # (len,) int32
    max_new: int = 16
    temperature: float = 0.0
    tokens_out: list[int] = field(default_factory=list)


class BatchServer:
    """Fixed-slot batched decoder (one model replica on one device).

    ``device=None`` means the CUDA card and raises without one.  The
    parameters are drawn on the device from ``seed`` and cast one layer at
    a time (``lm.init_cast``: the peak is the cast parameters plus one
    fp32 item), or taken from ``params`` (e.g. ``convert.params_from_jax``)
    and cast once to the compute dtype (``lm.cast_params``).  With
    ``mesh`` they are laid out by ``sharding.make_rules`` on the mesh's
    device, each rank keeping its block: drawn onto the mesh one item at
    a time (``lm.init_cast``'s ``rules``), or ``params`` cast and then
    sliced."""

    def __init__(self, cfg: ArchConfig, max_len: int = 256, seed: int = 0,
                 device: str | torch.device | None = None,
                 params: dict | None = None, mesh=None):
        self.device = resolve_device(
            mesh_device(mesh) if mesh is not None and device is None
            else device)
        lm.check_supported(cfg)
        self.cfg = cfg
        self.max_len = max_len
        self.rules = None if mesh is None else SH.make_rules(cfg, mesh)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.params = lm.init_cast(cfg, gen, self.device, self.rules)
        else:
            self.params = lm.cast_params(cfg, params)
            if mesh is not None:
                self.params = SH.distribute(self.params, lm.param_specs(cfg),
                                            self.rules)

    def _on_mesh(self, fn, tokens: torch.Tensor, *args):
        """``fn(cfg, params, ..., tokens, *args)`` under the rules, the
        tokens' rows over the data axes; the logits come back whole."""
        if self.rules is None:
            return fn(tokens, *args)
        sh = self.rules.sharding_for(("batch", None), tuple(tokens.shape))
        with SH.use_rules(self.rules):
            logits, cache = fn(SH.place(tokens, sh), *args)
        return logits.full_tensor(), cache

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample(self, logits: torch.Tensor, temps: np.ndarray,
                gen: torch.Generator) -> np.ndarray:
        greedy = logits.argmax(dim=-1).cpu().numpy()
        if (temps <= 0).all():
            return greedy
        t = torch.as_tensor(np.maximum(temps, 1e-4), device=logits.device)
        probs = torch.softmax(logits / t[:, None], dim=-1)
        noisy = torch.multinomial(probs, 1, generator=gen)[:, 0].cpu().numpy()
        return np.where(temps > 0, noisy, greedy)

    def serve(self, requests: list[Request]) -> dict:
        """Serve one batch; returns ``prefill_s``, ``decode_s``,
        ``decode_tok_per_s`` (host clock around a device synchronize) and
        ``outputs`` (request id -> generated token ids)."""
        cfg, dev = self.cfg, self.device
        B = len(requests)
        plen = max(len(r.prompt) for r in requests)
        max_new = max(r.max_new for r in requests)
        if plen + max_new - 1 > self.max_len:
            raise ValueError(f"prompt {plen} + {max_new} new tokens need "
                             f"{plen + max_new - 1} cache rows; max_len is "
                             f"{self.max_len}")
        prompts = np.zeros((B, plen), np.int64)
        for i, r in enumerate(requests):
            prompts[i, plen - len(r.prompt):] = r.prompt   # left pad
        tokens = torch.from_numpy(prompts).to(dev)
        self._sync()
        t0 = time.perf_counter()
        logits, cache = self._on_mesh(
            lambda t: lm.prefill(cfg, self.params, t, max_len=self.max_len),
            tokens)
        self._sync()
        t_prefill = time.perf_counter() - t0

        temps = np.array([r.temperature for r in requests], np.float32)
        gen = torch.Generator(device=dev).manual_seed(0)
        tok = self._sample(logits, temps, gen)
        for i, r in enumerate(requests):
            r.tokens_out.append(int(tok[i]))
        self._sync()
        t0 = time.perf_counter()
        ndec = 0
        for t in range(1, max_new):
            step = torch.from_numpy(tok[:, None].astype(np.int64)).to(dev)
            logits, cache = self._on_mesh(
                lambda s, c, p: lm.decode_step(cfg, self.params, c, s, p),
                step, cache, plen + t - 1)
            tok = self._sample(logits, temps, gen)
            ndec += 1
            for i, r in enumerate(requests):
                if len(r.tokens_out) < r.max_new:
                    r.tokens_out.append(int(tok[i]))
        self._sync()
        t_decode = time.perf_counter() - t0
        return {
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "decode_tok_per_s": B * ndec / t_decode if ndec else 0.0,
            "outputs": {r.id: r.tokens_out for r in requests},
        }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's tiny same-family config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    ap.add_argument("--model-axis", type=int, default=0,
                    help="serve on a (world / m, m) mesh of the world that "
                         "exists (torchrun's, else one rank); 0: no mesh")
    args = ap.parse_args()

    cfg = get_config(args.arch, reduced=args.reduced)
    mesh = cli_mesh(args.model_axis, args.device)
    server = BatchServer(cfg, max_len=128, device=args.device, mesh=mesh)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                    rng.integers(4, 24)).astype(np.int32),
                    max_new=args.gen, temperature=0.7 * (i % 2))
            for i in range(args.batch)]
    stats = server.serve(reqs)
    if mesh is not None and mesh.get_rank() != 0:
        return
    print(f"prefill {stats['prefill_s']:.3f}s, "
          f"decode {stats['decode_tok_per_s']:.1f} tok/s")
    for rid, toks in stats["outputs"].items():
        print(f"  req {rid}: {toks[:12]}...")


if __name__ == "__main__":
    main()
