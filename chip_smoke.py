#!/usr/bin/env python3
"""Drives DORA's PyTorch/CUDA port on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no phase is caught):

1. device: a CUDA device must be present; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build: compiles every kernel source of ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` each, in parallel) and prints the seconds, and the
   registers and spills ``ptxas -v`` reports for the backward kernels.
3. kernels: holds each kernel against its plain PyTorch version on the
   card: ``flex_gemm`` over the reference's GEMM shapes, every epilogue,
   with and without the accumulator, fp32 and bf16, plus every MMU tile
   shape of BERT-L; the SFU row kernels over the reference's SFU shapes
   and the main path's row shapes; ``rmsnorm_rows`` over the SFU shapes
   (fp32) and the serving rows (bf16), with and without gamma;
   ``flash_attention`` over the reference's attention shapes x causal
   (fp32), its bf16 case, and qwen3-4b's prefill and decode shapes;
   ``ssd`` over the reference's SSD sweep (fp32 and bf16, chunks 32 and
   64, from zero and from an initial state, y and the final state), its
   tail case, G > 1 with a tail, a 2,048-token prompt and two state groups
   at mamba2-2.7b's widths, and mamba2-2.7b's prefill (bf16) and
   short-prompt (fp32) shapes; ``rmsnorm_rows`` over mamba2-2.7b's
   gated-norm rows and internlm2-20b's 6144-wide rows, ``layernorm_rows``
   over nemotron-4-15b's, fp32 (its 4-layer check) and bf16 (as served);
   unaligned and ragged operands of ``rmsnorm_rows``, ``layernorm_rows``,
   ``softmax_rows`` and ``act_rows`` (their scalar loads or block
   kernels); ``flash_attention`` at qwen2-vl-2b's and whisper-medium's
   shapes (non-causal over 1,500 encoder frames: the encoder, the cross
   prefill and the cross decode), ``rmsnorm_rows`` at qwen2-vl-2b's
   1536-wide rows and ``layernorm_rows`` at whisper-medium's 1024-wide
   ones; every MMU tile and SFU row of the multi-tenant binaries below;
   the MoE archs' shapes: ``rmsnorm_rows`` at llama4-maverick's and
   jamba-1.5-large's rows (5120, 8192, and jamba's gated norm over
   16,384; bf16 as served, fp32 as jamba's fp32 check), ``flash_attention``
   at dbrx's GQA 6, llama4's GQA 5 and jamba's GQA 8 (prefill and decode),
   ``ssd`` at jamba's 256 heads of 64 (bf16 and fp32).
4. DORA path: compiles paper workloads with ``DoraCompiler`` and runs
   each compiled binary through ``DoraCompiler.execute`` on the card from
   ``random_inputs(0)``: BERT-L and DeiT-L at full width, MLP-L (the one
   paper workload whose binary carries an element-wise SFU op) and every
   -S model.  The kernels' launch counts, zeroed just before, must equal
   the binaries' lead ``MMU_GEMM`` and ``SFU_*`` instruction counts.
   Every layer is held against ``reference_execute`` of that layer on
   the inputs the binary gave it (rtol 5e-4, atol 5e-4 scaled up only
   past |ref| = 100); the chained outputs against ``reference_execute``
   of the whole graph by relative L2 error (see ``CHAIN_RTOL``).  ROADMAP
   C.2's diagnosis: DeiT-S's chained error with one kernel family at a
   time, then every family, run on its plain version (printed).  Then
   DORA's multi-tenant path, the scenarios of
   ``benchmarks/bench_multi_tenant.py``: BERT-S + NCF-S (small_pair)
   compiled jointly into one binary and run as encoded, then reordered
   by ``interleave_stream`` ("rr" and "priority") and run again;
   qwen3-4b + whisper-medium (llm_pair, ``from_arch`` at the configs'
   widths, cut to 3 blocks a tenant as the benchmark cuts them) compiled
   jointly and run; and BERT-S + NCF-S + MLP-S (small_trio) placed on a
   two-PE ``DoraMesh`` by ``DoraMeshCompiler``, each PE's program run in
   turn.  The same launch, per-layer and chained checks; compile seconds,
   host ms and device-busy ms of each joint run.
5. serving: ``repro_torch.launch.serve.BatchServer`` serves qwen3-4b at
   full width and depth (36 layers, d 2560, vocab 151,936, bf16 compute,
   random weights from seed 0) to 4 greedy requests of 512, 384, 200 and
   37 prompt tokens, 32 new tokens each.  The kernels' launch counts,
   zeroed just before, must equal what the model's call structure gives
   (printed with its derivation).  The same weights then run
   teacher-forced on the served tokens through the kernels and through
   the plain versions (``plain=True``); every step's logits are held by
   relative L2 (see ``SERVE_RTOL``).  The prefill and a decode step are
   timed (host clock) and profiled (device busy share, time by kernel).
   qwen3-4b at full width, 4 layers, fp32 compute: prefill + decode held
   against ``forward`` (see ``FP32_DECODE_TOL``).  Then, with qwen3-4b's
   server freed, the same for mamba2-2.7b at full width and depth (64
   SSM layers, d 2560, 80 SSD heads of 64, state 128, vocab 50,280)
   on the same traffic, with ``SSM_RTOL`` for the logits, the same
   weights cut to 8 layers (``SSM_SHALLOW_RTOL``), and its prefill once
   more at fp32 compute and full depth, kernels against plain versions
   (see ``SSM_FP32_RTOL``).  Then, each server freed before the next,
   internlm2-20b (48 layers, d 6144), nemotron-4-15b (32 layers, d 6144,
   layernorm on its bf16 rows, relu2 MLP; also the fp32 4-layer check)
   and qwen1.5-4b
   (qkv bias) at full width and depth on the same traffic, within
   ``SERVE_RTOL``; then qwen2-vl-2b (M-RoPE, GQA 6, 28 layers, d 1536)
   the same way, and ``lm.forward`` on one 512-token prompt with
   distinct (t, h, w) position ids, kernels against plain versions.
   whisper-medium (24 encoder and 24 decoder layers, d 1024; no server,
   as in the reference) is driven through ``encdec.prefill`` and
   ``encdec.decode_step``: 4 items of 1,500 stub frames and a 64-token
   prompt, 32 greedy tokens, a 128-row self cache, with its launch counts
   a prefill and a decode step, its logits against the plain versions
   (``SERVE_RTOL``) and an fp32 4 + 4-layer decode-consistency check.
   Then the MoE archs at full width, cut in depth (``MOE_CUTS``, printed
   beside every number): dbrx-132b (8 of 40 layers, 16 experts top-4,
   layernorm), llama4-maverick-400b-a17b (one block of 24: a dense and a
   MoE layer of 128 experts top-1) and jamba-1.5-large-398b (one 8-layer
   block of 9, 12 of its 16 experts top-2, 7 SSM layers), each served the
   same way; the teacher-forced check also records every MoE layer's
   routing on both paths and prints the decisions that differ, layer by
   layer, in the prefill and every step; it holds the logits of a third
   run, the kernels with each route pinned to the plain path's, within
   ``SERVE_RTOL``, and each decision the kernels would have made
   otherwise within ``ROUTE_MARGIN`` of a tie.  Their fp32 checks at full
   width: dbrx's first 2 layers and jamba's first two pattern positions,
   prefill kernels against plain versions (``FP32_DECODE_TOL``,
   ``FP32_ROUTE_MARGIN``); llama4's MoE layer alone (60 GiB in fp32),
   ``moe_fwd`` by index against its one-hot form.
   Every server is drawn by ``lm.init_cast``; the peak
   device memory of building it must stay under its bf16 parameters plus
   the largest fp32 item (the embedding, the head or a layer) plus 1 GiB,
   and under what holding one fp32 item at a time gives plus 1 GiB (a MoE
   layer's items: its mixer, norms and router, then each expert matrix).
6. training: the backward kernels (rmsnorm's, layernorm's, flash
   attention's and the SSD scan's, no Pallas counterpart) against autograd
   of their plain versions on the card: rmsnorm over the reference's SFU
   rows (fp32), qwen3-4b's, qwen2-vl-2b's and internlm2-20b's training
   rows (bf16 and fp32) and a ragged and an unaligned case; attention
   over the reference's attention shapes, causal and not (fp32, and bf16
   on the tensor-core kernels), a causal
   case whose first rows see no key (their gradient must be 0), a ragged
   head-128 GQA-4 case with Sq != Skv (bf16), qwen3-4b's training
   attention (4 x 512, and train_4k's 2 x 4,096), qwen1.5-4b's,
   qwen2-vl-2b's and internlm2-20b's (fp32 and bf16) and whisper-medium's
   (D 64, causal and full over 512 tokens, and the served cross shape over
   1,500 frames; bf16); layernorm, with
   and without gamma and beta, over the reference's SFU rows (fp32),
   whisper-medium's and nemotron-4-15b's training rows and ``LN_ODD``
   (fp32 and bf16); ``ssd`` from zero and from an initial state with a
   gradient into the final state, over the reference's SSD sweep (fp32
   and bf16, its tail case, G > 1), mamba2-2.7b's training shape (bf16 and
   fp32) and train_4k's 1 x 4,096 (bf16), and jamba's 256 heads (bf16);
   every gradient within ``FP32_GRAD_TOL`` / ``BF16_GRAD_RTOL`` /
   ``DGAMMA_RTOL``, and a second backward run equal to the bit.  Model
   gradients (``lm.loss_fn``, ``encdec.loss_fn``), kernels against plain
   versions on the same weights and ``SyntheticLM`` batch at full width:
   qwen3-4b fp32 over 2
   layers (``MODEL_FP32_TOL``) and bf16 over the training cut
   (``MODEL_BF16_RTOL``, each leaf printed); then ``MODEL_GRAD_CUTS``:
   whisper-medium fp32 over 2 + 2 layers and bf16 over 4 + 4, mamba2-2.7b
   fp32 over 2 and bf16 over 8, nemotron-4-15b, qwen1.5-4b and
   internlm2-20b bf16 over 2, qwen2-vl-2b bf16 over 4.  Then
   ``launch.train.Trainer`` trains qwen3-4b at full width cut to
   ``TRAIN_LAYERS`` of 36 layers, and then, one at a time, whisper-medium
   and mamba2-2.7b at full width and depth (``FULL_TRAIN_ARCHS``; fp32
   parameters and moments, bf16 compute, remat) for ``TRAIN_STEPS`` steps
   of 4 x 512 tokens each: the mean loss of the last 3 steps must fall
   below the first's, the launch counts, zeroed just before, must equal
   what the call structure gives (printed with its derivation); step ms,
   tokens/s, the predicted and measured peak memory and one profiled step.
   Then qwen1.5-4b and qwen2-vl-2b at full width and depth and
   internlm2-20b at full width cut to ``DENSE_TRAIN_CUTS`` layers
   (``DENSE_TRAIN_ARCHS``), one at a time, the same way but timed on the
   host clock only.
   Then the MoE archs at full width, cut in depth and experts to fit the
   training state (``MOE_TRAIN_CUTS``, printed beside every number), one
   cut at a time: bf16 model gradients, kernels against plain versions,
   each MoE call of the kernels pinned to the plain path's routes of its
   layer and its own aux loss (``MODEL_BF16_RTOL``; each decision the
   kernels' router would have made otherwise within ``ROUTE_MARGIN`` of a
   tie, but on ``ROUTES_VS_FP32``'s cut; on every cut the kernels' and the
   plain versions' decisions against an fp32 evaluation of the same
   weights, the kernels' no farther from it, ``ROUTE_FP32_SLACK``), the
   gradient again with each kernel family on its plain version in turn
   and both paths' gradients against an fp32 one on the same routes;
   fp32 ones up to the first MoE layer, routes free
   (``MODEL_FP32_TOL``, ``FP32_ROUTE_MARGIN``); ``Trainer`` with the
   config's bf16 moments (jamba at ``MOE_TRAIN_PEAK_LR``), the same checks
   as above and the peak under ``CARD_TRAIN_GB`` (jamba's cut for
   ``MOE_TRAIN_STEPS`` steps); ROADMAP C.6: a bf16
   forward of the batch after the last step's, which no step trains on,
   on the trained weights and on the initial ones, the kernels' own
   routes against the plain path's, held as the pinned gradients' routes,
   and the MoE inputs' drift with each kernel family on its plain version
   in turn (on the initial weights), and that batch's loss, which must
   fall from the initial weights to the trained ones (jamba's by more
   than ``HELD_OUT_SPREADS`` standard deviations of its step-to-step loss
   differences); dbrx-132b trained again with a fault at
   ``FAULT_AT`` and no checkpoint, its losses replayed within
   ``FAULT_RTOL`` and its peak within 1 GiB of the uninterrupted run's.
   Then one step's gradients of qwen3-4b's training cut under each
   ``remat_policy`` ("nothing", "dots", "dots_nb"), equal to the bit, with
   their peaks and host ms.  Last, a fault injected into reduced qwen3-4b's
   and reduced dbrx-132b's training on the card: each run resumed from its
   checkpoint replays an uninterrupted run's losses (``FAULT_RTOL``).
7. mesh: the multi-device layer (``repro_torch.parallel``) on the card's
   one-device mesh, (data 1, model 1) over a world of one (NCCL takes one
   rank a card; ``launch.mesh.make_local_mesh``).  qwen3-4b at full width
   and depth, its weights laid out by the sharding rules, serves the
   serving phase's 4 requests: the greedy tokens and the launch counts
   (145 rmsnorm, 36 flash_attention a step) are the meshless server's
   on the same weights, and the teacher-forced logits of a prefill and
   ``MESH_DECODE_STEPS`` steps equal the meshless ones; the prefill and
   decode ``StepBundle``s (4 x 512, a 1,024-row cache) give
   ``lm.prefill``'s and ``lm.decode_step``'s outputs; mamba2-2.7b cut to
   ``MESH_SSM_LAYERS`` (its prefill's ``ssd`` calls) and whisper-medium
   cut to ``MESH_WHISPER_LAYERS`` + ``MESH_WHISPER_LAYERS`` (encoder over
   1,500 frames, prefill, decode) equal their meshless runs; ``Trainer``
   on qwen3-4b cut to ``MESH_TRAIN_LAYERS`` layers for
   ``MESH_TRAIN_STEPS`` steps gives the
   meshless losses and backward launches, its checkpoint holds the
   meshless one's bytes (every leaf's crc32, shape and dtype in the two
   manifests), and the meshless one restores onto the mesh bit for bit;
   ``ef_tree_quantize`` over a few gradients on the card equals the
   CPU's, and ``compressed_psum`` over the world of one equals
   ``decompress(ef_quantize(g))``.  Prints the phase's seconds and a
   decode step's host ms with and without the mesh.
8. examples: ``examples_torch/`` through each example's ``run`` (see
   ``EX_*``): quickstart (BERT-S compiled by the MILP, executed on the
   DORA kernels; launches equal to the binary's, every layer's chained
   output within ``CHAIN_RTOL``), serve_batch at its defaults (reduced
   qwen3-4b; launches, greedy tokens teacher-forced again, prefill ms and
   decode tok/s), train_lm's 100m preset at full width for
   ``EX_TRAIN_STEPS`` steps with a fault at ``EX_TRAIN_FAIL_AT`` (one
   failure, the replayed losses, the loss falling, launches of the
   backward kernels, step ms, tokens/s and the peak), and
   grad_compression over the card's NCCL world (the fp32 path against
   full-batch descent, both paths' mse and all-reduced bytes).  Prints
   the phase's seconds.  dora_scheduling is numpy only and is tested on
   the CPU.
9. long context: the reference's assigned shapes
   (``src/repro/configs/shapes.py``) at full width through the same entry
   points, each global batch cut to fit the card (see ``LONG_*``):
   first the kernels alone at the cells' shapes (``flash_attention``'s
   prefill and decode, the layernorm and rmsnorm kernels on 65,536 rows),
   bf16 and fp32, against their plain versions, each bf16 one timed
   beside its library call and its bound;
   qwen3-4b at full depth serves two 32,768-token prompts and 32 new
   tokens from one ``BatchServer`` of 32,800 cache rows (prefill_32k,
   decode_32k; launches a step as the serving phase's; teacher-forced
   logits, every pass and row, as near fp32 arithmetic on the same bf16
   weights (the plain versions) as the plain bf16 versions' (whose
   attention runs over 1,024-row query chunks there), planted faults
   that must fail that bound, and the kernels against the plain versions
   within ``SERVE_RTOL`` over the first ``LONG_SHALLOW_LAYERS`` layers);
   internlm2-20b, nemotron-4-15b, qwen1.5-4b and qwen2-vl-2b the same way,
   one at a time, and whisper-medium through ``encdec`` over 32,768 stub
   frames (launches; their weights' first ``LONG_SHALLOW_LAYERS`` layers
   teacher-forced, kernels against plain versions, bf16 within
   ``SERVE_RTOL`` and at fp32 compute within ``FP32_DECODE_TOL``);
   mamba2-2.7b at full depth serves a 524,288-token prompt and 32 new
   tokens (long_500k; launches, finite logits at every step, the first
   decode step against the kernels' prefill over the prompt and that
   token within ``SSM_RTOL``), after its ``ssd`` kernel alone at that
   length, bf16 and fp32, is held against ``ref.ssd_chained``; then
   ``Trainer`` on qwen3-4b's training cut at 2 x 4,096 tokens,
   mamba2-2.7b at full depth at 1 x 4,096, whisper-medium (4,096 frames
   and tokens a row) and qwen2-vl-2b at full depth at 2 x 4,096 (train_4k;
   launches, descent, peak; phase 6 holds the backward kernels at these
   shapes); then the kernels alone at the MoE archs' and mamba2-2.7b's
   32k shapes (llama4's and jamba's attention, the rmsnorm kernel on
   65,536 rows of 5,120, 8,192 and 16,384, ``ssd`` at jamba's 256 heads
   and mamba2-2.7b's 80 over 2 x 32,768 positions), dbrx-132b,
   llama4-maverick and jamba-1.5-large at full width cut in depth
   (``LONG_MOE_CUTS``) serving the same two 32,768-token prompts and 32
   new tokens, held as the serving phase holds the MoE cuts (launches,
   the load peak, pinned routes; fp32 over their first 2 layers), and
   mamba2-2.7b at full depth the same (launches, finite logits, its first
   8 layers in bf16 and the full depth at fp32 compute, kernels against
   plain versions).  Prints every load, serve and phase peak and the
   phase's seconds.
10. timing: BERT-L's compile and execute seconds and its device time by
   kernel (profiler); each kernel's device time at its main path's
   shapes (CUDA events, see ``cuda_ms``) beside its plain version, one
   PyTorch library call where one computes the same function, and the
   card's bound: ``flex_gemm`` at every distinct tile of each main-path
   model with the launch-weighted sum over a run, ``flash_attention``
   decode over 65, 540 and 1,024 cache rows, the gelu row kernel, the
   rmsnorm and layernorm rows of the served archs (nemotron-4-15b's norm
   as served, bf16 in and out, beside its old path: a cast to fp32, the
   fp32 kernel and a cast back); the redesigned rmsnorm, activation,
   layernorm and softmax kernels beside the kernels before their redesign;
   ``flash_attention`` at whisper-medium's three attention shapes,
   qwen2-vl-2b's prefill and the MoE archs' prefill and decode,
   ``sfu_layernorm`` at whisper-medium's rows, ``rmsnorm`` at qwen2-vl-2b's
   and the MoE archs', ``ssd`` at jamba's prefill; the backward kernels at
   qwen3-4b's, whisper-medium's, nemotron-4-15b's and mamba2-2.7b's
   training shapes, beside their plain versions, the backward of
   ``F.rms_norm`` / ``F.layer_norm`` / ``F.scaled_dot_product_attention``
   (none computes the SSD backward), and in brackets their times before
   the redesign (``MS_BEFORE_REDESIGN``, as recorded in ``PERF.md``), and
   ``ssd_bwd`` at jamba's 256 heads, ``rmsnorm_bwd`` at the MoE archs'
   training rows (5120, 8192, 16,384) and ``flash_attention_bwd`` at their
   training attention (GQA 6, 5 and 8), and both at the other dense
   archs' (rmsnorm's rows of 1536 and 6144, attention at qwen1.5-4b's GQA
   1 and qwen2-vl-2b's 12 over 2 heads); the norms' backward plans each
   beside an alternative in turns, through the wrappers (``[tune]``:
   rmsnorm's q-norm rows on the warp or the vector kernel; layernorm's
   whisper-medium rows on the vector or the warp kernel, nemotron-4-15b's
   on one or two blocks an SM).
   The profiles sum ``ssd``'s two kernels and each backward's kernels, and
   print each step's device activities.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --cards 4

is the four-card mode, on a machine with four cards (it raises at once on
fewer; see ``CARDS``): it prints every card's name and power limit, starts
four ranks of this script, rank r on card r, joined over NCCL through a
``FileStore`` (``launch.mesh.join_world``); rank 0 builds the kernels while
the others wait, every rank checks itself, and a rank that fails stops
the world; a rank that misses a numeric bound prints it, runs on through
the phases and fails at their end.  Its phases drive the multi-device
layer through ``BatchServer``, ``Trainer``, the step bundles and
``checkpoint.ckpt`` at full width:

* serve: qwen3-4b at full depth on (1, 4), (2, 2) and (4, 1), drawn onto
  each mesh (``lm.init_cast(..., rules=)``), each card's load peak under
  its block of the bf16 parameters plus the largest fp32 item plus 1 GiB;
  the serving phase's traffic with each rank's launches the meshless
  path's, every rank sampling the same tokens; at fp32 over
  ``CARDS_FP32_LAYERS`` layers, logits against one card's
  (``FP32_DECODE_TOL``); in bf16, teacher-forced, every pass and row as
  near fp32 arithmetic on the same bf16 weights as rank 0's one-card
  server (``LONG_FP32_SLACK``), with two planted faults that must fail
  that bound (``CARDS_FAULTS``: every rmsnorm, and on (1, 4) and (2, 2)
  one model rank's block of every ``wo``), and within ``SERVE_RTOL`` of
  one card over the first ``LONG_SHALLOW_LAYERS`` layers;
* moe: dbrx-132b at full depth (40 layers, 245 GiB in bf16) on (1, 4),
  4 experts a rank, served the same way, and its first
  ``MOE_SHALLOW_LAYERS`` and ``CARDS_MOE_CUT`` layers teacher-forced with
  each MoE call pinned to the plain path's routes (``SERVE_RTOL``,
  ``MOE_RTOL``; the kernels' own differing decisions within
  ``ROUTE_MARGIN`` of a tie);
* train: qwen3-4b's training cut on each mesh: step 0's loss and whole
  bf16 gradient against rank 0's one-card ones (``CARDS_LOSS_RTOL``,
  ``MODEL_BF16_RTOL``), then ``TRAIN_STEPS`` steps of ``Trainer``
  (descent, each rank's backward launches the meshless path's);
* nemotron: nemotron-4-15b at full width and depth trained
  ``TRAIN_STEPS`` steps on (2, 2) (FSDP, tensor parallel, ZeRO-1), its
  peak under ``CARD_TRAIN_GB`` a card, step ms and tokens/s;
* state: ``examples_torch/grad_compression.py`` over the NCCL world
  against its gloo world of 4 on the CPU (``EX_GD_TOL``, equal bytes), and
  a reduced dbrx-132b training state saved from (2, 2), restored onto
  (1, 4) and onto one card bit for bit.

It prints the readings as one JSON line, every card's ``nvidia-smi``
line, and ``{"ok": true, ...}`` last, with ``count`` the cards.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MAIN_MODELS = ("BERT-L", "DeiT-L", "MLP-L", "MLP-S", "DeiT-S", "BERT-S",
               "PointNet-S", "NCF-S")
# The reference's kernel sweeps (tests/test_kernels.py).
GEMM_SHAPES = [(128, 128, 128), (100, 200, 300), (7, 33, 129),
               (256, 512, 384), (1, 17, 5), (130, 257, 131),
               (512, 64, 1024)]
SFU_SHAPES = [(64, 128), (100, 300), (8, 17), (256, 512), (5, 1000)]
# Layer tolerance: the reference runtime's rtol = atol = 5e-4
# (tests/test_runtime_simulator.py); atol grows with the layer's magnitude
# past 100 (MLP-L reaches ~1e5), since reordered fp32 sums err in
# proportion to the terms (the reasoning of tests/test_system.py:47-49).
LAYER_RTOL, LAYER_ATOL, LAYER_ATOL_REL = 5e-4, 5e-4, 5e-6
# Chained outputs: softmax over logits of ~100 and layernorm amplify any
# reordering of fp32 sums block by block, so no element-wise bound holds
# across 4 blocks: the reference's own numpy runtime already differs from
# reference_execute by 2% relative L2 on DeiT-S (see
# tests/test_torch_runtime.py::test_chained_drift_exceeds_layer_tolerance).
# The element-wise guarantee is the per-layer check; this one catches
# gross errors only.
CHAIN_RTOL = 0.1
# The reference's attention sweep (B, Hq, Hkv, Sq, Skv, D).
ATTN_SHAPES = [(1, 4, 2, 64, 64, 32), (2, 8, 2, 32, 128, 64),
               (1, 2, 1, 1, 96, 32), (1, 4, 4, 50, 50, 16),
               (1, 2, 2, 1, 500, 64), (2, 6, 3, 40, 100, 32)]
# Serving traffic: qwen3-4b, 4 greedy requests, prompts left-padded to
# 512, 32 new tokens each, a 1024-row cache.
SERVE_ARCH, SERVE_PROMPTS, SERVE_NEW, SERVE_MAX_LEN = \
    "qwen3-4b", (512, 384, 200, 37), 32, 1024
# qwen3-4b's rmsnorm rows (rows, width): prefill of 4 x 512 tokens
# (norm1/norm2, q-norm over 32 heads, k-norm over 8), decode of 4 tokens
# (norms and the prefill's last-position final norm, q-norm, k-norm).
RMS_SERVING = [(2048, 2560), (65536, 128), (16384, 128), (4, 2560),
               (128, 128), (32, 128)]
# Kernels against plain versions on the serving path, both bf16: each
# step's logits by relative L2.  The two differ by one bf16 rounding here
# and there (the kernels sum in another order), and 36 bf16 layers carry
# that forward; 2e-2 is the bound this check starts from for bf16, above
# the worst step measured on the H100 (see PERF.md).
SERVE_RTOL = 2e-2
# mamba2-2.7b serving: the same traffic; an SSM cache holds a conv window
# and a state per layer, whatever max_len is.
SSM_ARCH = "mamba2-2.7b"
# ssd: (B, S, H, P, G, N, chunk).  The reference's sweep
# (tests/test_kernels.py:160-196) at chunks 32 and 64, its tail case
# S = 100, and G > 1 with a tail, in fp32; mamba2-2.7b's own shapes are
# derived from its config (see SSM_SHAPES in main).
SSD_SHAPES = [(2, 128, 4, 16, 2, 8, 32), (2, 128, 4, 16, 2, 8, 64),
              (1, 64, 2, 8, 1, 4, 32), (1, 64, 2, 8, 1, 4, 64),
              (2, 256, 8, 32, 2, 16, 32), (2, 256, 8, 32, 2, 16, 64),
              (1, 100, 2, 8, 1, 4, 64), (2, 77, 8, 32, 4, 16, 32)]
# ssd at mamba2-2.7b's widths beyond its served shapes: a 2,048-token
# prompt (16 chunks in series through the state kernel) and two state
# groups.
SSD_WIDE = [(1, 2048, 80, 64, 1, 128, 128), (1, 256, 16, 64, 2, 128, 128)]
# mamba2-2.7b's rmsnorm rows beyond qwen3-4b's: the gated norm (5120 wide)
# of 4 x 512 prefill tokens and of 4 decode tokens.
RMS_SSM = [(2048, 5120), (4, 5120)]
# internlm2-20b's rmsnorm rows (d_model 6144), prefill and decode; the same
# rows go through the layernorm kernel on nemotron-4-15b, in bf16 as
# served and in fp32 in its 4-layer check.
RMS_WIDE = [(2048, 6144), (4, 6144)]
# qwen2-vl-2b's rmsnorm rows (d_model 1536), prefill and decode
RMS_VL = [(2048, 1536), (4, 1536)]
# The MoE archs, each served at full width and cut in depth to fit one
# card: ``dataclasses.replace(get_config(arch), **cut)``.  Sizes are bf16
# parameters by ``ArchConfig.param_count``: dbrx-132b to 8 of its 40
# layers (50.86 GiB; 245 whole); llama4-maverick to one block of its 24, a
# dense and a MoE layer (34.32 GiB; its MoE layer alone is 30 GiB);
# jamba-1.5-large to one 8-layer block of its 9 with 12 of its 16 experts
# (66.09 GiB; one block with 16 is 84.09, over the card, and 14 experts,
# 75.09, leave no room for the prefill)
MOE_CUTS = {"dbrx-132b": {"n_layers": 8},
            "llama4-maverick-400b-a17b": {"n_layers": 2},
            "jamba-1.5-large-398b": {"n_layers": 8, "n_experts": 12}}
# their rmsnorm rows beyond the dense archs': llama4 (d 5120, as mamba2's
# gated norm), jamba (d 8192, and its gated norm over 16,384), prefill and
# decode; dbrx's layernorm rows are nemotron-4-15b's (d 6144, bf16)
RMS_MOE = [(2048, 8192), (4, 8192), (2048, 16384), (4, 16384)]
# Routing of the kernels against the plain versions (bf16): the norms and
# attention before the router differ by a bf16 ulp here and there, so a
# token near a top-k tie may take another expert, and then its whole FFN
# output differs.  With random weights that is no small change: the
# reference's expert scale, 1/sqrt(E) for w_gate and w_up, makes each MoE
# output dominate the residual, and through attention a swapped expert
# reaches every later token of its row, whose routes then differ too, far
# from any tie.  So the logits are held on the kernels with each MoE call
# dispatched by the plain path's choices (``moe_calls(pin=)``), and the
# unpinned run's differing decisions are printed.  Even pinned, each MoE
# layer adds its own bf16 rounding at the scale of the whole residual, so
# the MoE inputs of the two paths drift apart linearly in the MoE depth
# (3 % at dbrx's eighth, see PERF.md): the served weights cut to their
# first MOE_SHALLOW_LAYERS layers are held within SERVE_RTOL, every
# decision the kernels' own router would have made otherwise within
# ROUTE_MARGIN of a tie in the plain path's router probabilities (the gap
# to its nearer top-k neighbour); the full cut within MOE_RTOL, which a
# wrong expert, gate or slot (tens of percent) exceeds.  At fp32 compute
# the paths differ by fp32 reorderings (about 1e-6): a differing decision
# must lie within FP32_ROUTE_MARGIN of a tie.
# The training phase's bf16 route checks (the pinned gradients, C.6) hold
# each decision of the kernels that differs from the plain versions'
# within ROUTE_MARGIN of a tie, on every cut but ROUTES_VS_FP32's.  Every
# cut is also held against an fp32 evaluation of the same weights and
# tokens (``routes_vs_fp32``): the kernels' decisions that differ from it
# at most the plain versions' count n + 3 sqrt(2n) (three standard
# deviations of the difference of two Poisson counts of mean n: two bf16
# paths as accurate as each other flip different near-ties), and their
# largest margin and MoE-input drift from it within ROUTE_FP32_SLACK times
# the plain versions' (the margin at least ROUTE_MARGIN).  jamba-1.5-large's
# training cut is held to that alone: there the attention kernel's
# rounding, as near fp32 as the plain version's, reaches the MoE input
# through the dense FFN and the SSM layer at 1.3 %, and the plain bf16 path
# itself decides otherwise than fp32 at margins past 1e-2 (0.038 at the
# initial weights, 0.26 trained; see PERF.md), so no bf16 path can be held
# to ROUTE_MARGIN of another there (ROADMAP C.6).
ROUTE_MARGIN, FP32_ROUTE_MARGIN = 1e-2, 1e-5
ROUTES_VS_FP32, ROUTE_FP32_SLACK = ("jamba-1.5-large-398b",), 1.25
MOE_SHALLOW_LAYERS, MOE_RTOL = 2, 0.1
# The MoE archs' fp32 checks at full width: dbrx's first 2 layers and
# jamba's first two pattern positions (attn + dense, ssm + moe; 12
# experts), kernels against plain versions; llama4's fp32 MoE layer alone
# is 60 GiB, so it runs its moe_fwd alone (moe_layer_fp32_check)
MOE_FP32_LAYERS = {"dbrx-132b": 2, "jamba-1.5-large-398b": 2}
# The MoE archs' training cuts (phase 6): full width (d, d_ff, heads, vocab
# and top-k unchanged), cut in depth, and in experts where one layer with
# all of them does not fit, so that the training state (fp32 parameters and
# gradients and the configs' bf16 moments: 12 bytes a parameter) fits one
# card beside the step's temporaries: dbrx-132b 1 of 40 layers with its 16
# experts (4.492 B parameters, 50.2 GiB of state); llama4-maverick one
# block of 24 (a dense and a MoE layer) with 16 of its 128 experts (4.334
# B, 48.4 GiB; the block with all 128 is 18.4 B); jamba-1.5-large its first
# two pattern positions (attn + dense, ssm + moe) with 4 of its 16 experts
# (4.652 B, 52.0 GiB; one block of 8 layers with 12 is 45.1 B)
MOE_TRAIN_CUTS = {"dbrx-132b": {"n_layers": 1},
                  "llama4-maverick-400b-a17b": {"n_layers": 2,
                                                "n_experts": 16},
                  "jamba-1.5-large-398b": {"n_layers": 2, "n_experts": 4}}
# Their peak lr where TRAIN_PEAK_LR does not train them: at 1e-3 the loss
# of jamba-1.5-large's cut (d 8,192) on a held-out batch rises over the 10
# steps, at AdamW's default 3e-4 it falls (the phase prints the 1e-3 run
# beside the checked one; PERF.md)
MOE_TRAIN_PEAK_LR = {"jamba-1.5-large-398b": 3e-4}
# Their step counts where TRAIN_STEPS cannot show descent (ROADMAP C.6): at
# 3e-4 jamba's cut moves its held-out loss less in 10 steps than one
# step's loss moves the next, and in 30 steps by 0.50 of the standard
# deviation of its step-to-step loss differences (at peak lr 1e-4, 6e-4 or
# 1e-3, without the aux loss or the clip, it does no better; PERF.md); in
# 90 steps by 3.9 of them.  Such a cut trains MOE_TRAIN_STEPS steps and
# its held-out loss must fall by more than HELD_OUT_SPREADS standard
# deviations of its step-to-step loss differences; the other cuts' must
# fall.
MOE_TRAIN_STEPS, HELD_OUT_SPREADS = {"jamba-1.5-large-398b": 90}, 3.0
# their fp32 gradient checks run up to the first MoE layer, the experts
# halved while the fp32 parameters and two gradients would pass this many
# GiB; a training run's peak must stay under the card's 80 GB; the MoE
# arch whose full-width run is repeated with a fault, and which joins
# reduced qwen3-4b in the fault-and-resume check
MOE_FP32_GIB, CARD_TRAIN_GB, MOE_FAULT_ARCH = 60, 80, "dbrx-132b"
# Unaligned and ragged rows of the redesigned kernels, (rows, width,
# offset): a view ``offset`` elements into its buffer is not 16-byte
# aligned, and a width of no whole number of 16-byte vectors cannot be
# read in them; both take the scalar kernels of csrc/sfu.cu.
RMS_ODD = [(2048, 6144, 1), (64, 2561, 0), (8, 6143, 1), (16, 4100, 0)]
ACT_ODD = [(512, 3072, 1), (7, 1001, 0), (1, 3, 0)]
# the same for layernorm (scalar loads of the warp kernel up to 1,024
# wide, else the block kernel) and softmax (the warp kernel's scalar
# loads, the block kernel past 1,024)
LN_ODD = RMS_ODD + [(197, 768, 1), (33, 1025, 0)]
SM_ODD = [(512, 512, 1), (197, 197, 0), (5, 1000, 1), (3, 1025, 0),
          (3, 1025, 1)]
# the layernorm and softmax rows timed beside the kernels before their
# redesign: (kernel, rows, width, dtype), nemotron-4-15b's and the DORA
# path's
REDESIGNED_ROWS = [("sfu_layernorm", 2048, 6144, "bfloat16"),
                   ("sfu_layernorm", 4, 6144, "bfloat16"),
                   ("sfu_layernorm", 2048, 6144, "float32"),
                   ("sfu_layernorm", 4, 6144, "float32"),
                   ("sfu_layernorm", 512, 768, "float32"),
                   ("sfu_layernorm", 197, 768, "float32"),
                   ("sfu_layernorm", 197, 384, "float32"),
                   ("sfu_softmax", 512, 512, "float32"),
                   ("sfu_softmax", 197, 197, "float32"),
                   ("sfu_softmax", 32, 32, "float32")]
# The dense archs served after qwen3-4b and mamba2-2.7b, in this order, on
# qwen3-4b's traffic: internlm2-20b (the widest, 6144), nemotron-4-15b
# (layernorm on bf16 rows, relu2 MLP, vocab 256,000), qwen1.5-4b (qkv
# bias) and qwen2-vl-2b (MROPE_ARCH: M-RoPE on text position streams, GQA
# 6).  qwen2-vl-2b's position check then feeds one prompt an image-like
# (t, h, w) grid of MROPE_GRID[0] x MROPE_GRID[1] patches.
MROPE_ARCH, MROPE_GRID = "qwen2-vl-2b", (16, 32)
DENSE_ARCHS = ("internlm2-20b", "nemotron-4-15b", "qwen1.5-4b", MROPE_ARCH)
# whisper-medium: 4 items of 1,500 stub frames (its 30-second window), a
# 64-token prompt each, 32 greedy tokens, a 128-row self cache
WHISPER_ARCH = "whisper-medium"
WHISPER_BATCH, WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_MAX_LEN = \
    4, 1500, 64, 128
# DORA's multi-tenant scenarios (benchmarks/bench_multi_tenant.py): tenant
# -> None for a paper workload, or (seq, blocks) of ``from_arch``: the
# benchmark cuts its LLM tenants to 3 blocks at their published widths
MT_SCENARIOS = {
    "small_pair": {"BERT-S": None, "NCF-S": None},
    "llm_pair": {"qwen3-4b": (128, 3), "whisper-medium": (192, 3)},
    "small_trio": {"BERT-S": None, "NCF-S": None, "MLP-S": None},
}
MT_JOINT = ("small_pair", "llm_pair")
# the "priority" interleave's weights by tenant index (tests/test_interleave.py)
MT_PRIORITIES = {0: 1.0, 1: 8.0}
# Kernels against plain versions on mamba2-2.7b, both bf16: each step's
# logits by relative L2.  Far looser than SERVE_RTOL, and examined: the
# SSD kernels (bf16 products on the tensor cores, each fp32 operand split
# into a bf16 high and low part, about fp32 sums) and ssd_chunked (fp32)
# sum in different orders, so their bf16 outputs differ by one ulp here
# and there (held element-wise in phase 3),
# and 64 SSM layers of random bf16 weights carry such differences much
# further than qwen3-4b's 36 attention layers do:
# tests/test_torch_ssm.py::test_bf16_drift_grows_with_depth_and_fp32_holds
# shows two fp32 orders of the same SSD drifting by several percent over
# 64 bf16 layers at d_model 128, and by about 1e-5 in fp32.  So this bound
# catches a gross fault only; SSM_SHALLOW_RTOL and SSM_FP32_RTOL below
# are the sharper end-to-end checks.
SSM_RTOL = 0.35
# The same served weights cut to their first 8 layers, bf16, prefill
# logits of the kernels against the plain versions by relative L2: the
# CPU drift test above gives 0.0124 at 8 layers against 0.113 at 64
# (d_model 128), so the 0.156 measured at full depth on the H100 scales to
# about 0.017 here; 0.05 leaves 3x, where a fault in the SSD kernel's
# decay or masking moves the logits by tens of percent.
SSM_SHALLOW_LAYERS, SSM_SHALLOW_RTOL = 8, 0.05
# The same weights at fp32 compute, full width and depth: prefill logits
# of the kernels against the plain versions by relative L2.  fp32
# reordering alone gives ~1e-5 over 64 layers (the test above); a 1 %
# error in the decay gives tens of percent.
SSM_FP32_RTOL = 1e-3
# fp32 compute, 4 layers at full width: prefill + decode against forward,
# |err| <= FP32_DECODE_TOL * max|logit| (tests/test_models.py holds the
# reduced configs to 2e-3 absolute; logits here are of order 1-10).
FP32_DECODE_TOL = 2e-3
# Training: qwen3-4b, the configuration of the training path that runs the
# fewest kernels (rmsnorm and flash attention, each with its backward
# kernel), at full width cut to TRAIN_LAYERS of its 36 layers; fp32
# parameters and moments, bf16 compute, remat on (the config's own); a
# batch of TRAIN_BATCH x TRAIN_SEQ tokens from SyntheticLM seed 0,
# TRAIN_STEPS AdamW steps warmed up over TRAIN_WARMUP to TRAIN_PEAK_LR, no
# checkpoint.  The peak is examples/train_lm.py's 1e-3: at AdamW's default
# 3e-4 the loss does not leave the batch-to-batch spread (about 0.03)
# within 10 steps over 151,936 uniformly used tokens (the phase prints
# that run beside the checked one; see PERF.md).
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = "qwen3-4b", 8, 4, 512
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_PEAK_LR = 10, 2, 1e-3
# Backward kernels against autograd of their plain versions on the card:
# fp32 gradients within FP32_GRAD_TOL x max|ref| (reordered fp32 sums, as
# the reference's kernel tests hold fp32); bf16 dx, dq, dk, dv by relative
# L2 within BF16_GRAD_RTOL (each rounded to bf16 once, and attention's
# backward reads the forward's bf16 output); dgamma, fp32 sums of the same
# products in another order, within DGAMMA_RTOL.
FP32_GRAD_TOL, BF16_GRAD_RTOL, DGAMMA_RTOL = 1e-4, 2e-2, 1e-3
# rmsnorm's backward rows (rows, width, offset), besides the reference's
# SFU rows: qwen3-4b's training rows (norm1 / norm2 / the final norm over 4
# x 512 tokens, the q-norm's 65,536 rows of 128 and the k-norm's 16,384),
# a ragged width (the block kernel) and an unaligned view (scalar loads)
RMS_BWD_ROWS = [(2048, 2560, 0), (65536, 128, 0), (16384, 128, 0),
                (64, 2561, 0), (2048, 2560, 1)]
# and the training rows of DENSE_TRAIN_ARCHS that no other path reaches:
# qwen2-vl-2b's 1536 and internlm2-20b's 6144
RMS_BWD_ROWS += [(2048, 1536, 0), (2048, 6144, 0)]
# attention's backward besides the reference's sweep (fp32 and bf16) and
# the training shape: a causal case whose first 40 query rows see no key
# (Sq > Skv) and a ragged head-128 GQA-4 case with Sq != Skv, whose lengths
# are no multiple of the kernels' tiles
ATTN_EMPTY_ROWS = (1, 4, 2, 80, 40, 64)
ATTN_RAGGED_128 = (1, 8, 2, 100, 130, 128)
# layernorm's backward rows (rows, width, offset), besides the reference's
# SFU rows (fp32) and LN_ODD (fp32 and bf16): whisper-medium's training
# rows (4 x 512 tokens of 1024) and nemotron-4-15b's (6144), bf16 and fp32
LN_BWD_ROWS = [(2048, 1024, 0), (2048, 6144, 0)]
# model gradients of the two new training archs and nemotron-4-15b,
# kernels against plain versions at full width: (arch, fp32 layers or
# None, bf16 layers); whisper's counts are encoder + decoder layers each
MODEL_GRAD_CUTS = (("whisper-medium", 2, 4), ("mamba2-2.7b", 2, 8),
                   ("nemotron-4-15b", None, 2), ("qwen1.5-4b", None, 2),
                   ("qwen2-vl-2b", None, 4), ("internlm2-20b", None, 2))
# the two new Trainer runs, at full width and depth, on TRAIN_BATCH x
# TRAIN_SEQ tokens for TRAIN_STEPS steps at TRAIN_PEAK_LR (bf16 compute,
# remat: their configs' own); one trainer at a time
FULL_TRAIN_ARCHS = ("whisper-medium", "mamba2-2.7b")
# the other dense archs' Trainer runs (ROADMAP A.8.1), the same way at full
# width: qwen1.5-4b (GQA 1, qkv bias) and qwen2-vl-2b (M-RoPE, GQA 6, rows
# of 1536) at full depth, internlm2-20b (rows of 6144) cut to
# DENSE_TRAIN_CUTS layers: whole, its state is 296 GiB at 16 bytes a
# parameter, 74 a card on four; 6 of its 48 layers hold 3.478 B
# parameters, 51.8 GiB.  Their steps are timed on the host clock only (no
# profiled step)
DENSE_TRAIN_ARCHS = ("qwen1.5-4b", "qwen2-vl-2b", "internlm2-20b")
DENSE_TRAIN_CUTS = {"internlm2-20b": 6}
# device ms of the backward kernels before their redesign (fp32 FMA
# attention kernels; rmsnorm's one-row blocks, a partial row of dgamma
# each, a zero fill), by kernel and operand shape, as PERF.md records them
# (NVIDIA H100 80GB HBM3, 700.00 W): printed in brackets beside this run's
MS_BEFORE_REDESIGN = {("rmsnorm_bwd", (2048, 2560)): 0.0240,
                      ("rmsnorm_bwd", (65536, 128)): 0.0438,
                      ("rmsnorm_bwd", (16384, 128)): 0.0126,
                      ("flash_attention_bwd", (4, 32, 512, 128)): 1.5186,
                      ("ssd_bwd", (4, 512, 80, 64, 1, 128)): 2.0004,
                      ("layernorm_bwd", (2048, 1024)): 0.0311,
                      ("layernorm_bwd", (2048, 6144)): 0.0768}
# the backward kernels whose ptxas registers and spills the build prints,
# by library
PTXAS_KERNELS = {
    "flash_attention": ("flash_bwd_delta_kernel", "flash_bwd_kv_mma_kernel",
                        "flash_bwd_q_mma_kernel"),
    "sfu": ("rmsnorm_bwd_vec_kernel", "rmsnorm_bwd_warp_kernel",
            "rmsnorm_bwd_block_kernel", "layernorm_bwd_vec_kernel",
            "layernorm_bwd_warp_kernel", "layernorm_bwd_block_kernel",
            "column_sum_kernel"),
    "ssd": ("ssd_bwd_state", "ssd_bwd_chunk", "ssd_bwd_state_mma",
            "ssd_bwd_chunk_mma", "ssd_bwd_group_sum"),
}
# the kernels of one backward call, which the profiles sum (csrc/*.cu); the
# norms share the column sum, which a profile with both norms' backwards
# counts in each
BWD_PHASES = {"flash_attention_bwd": ("flash_bwd_delta", "flash_bwd_kv",
                                      "flash_bwd_q"),
              "rmsnorm_bwd": ("rmsnorm_bwd_", "column_sum"),
              "layernorm_bwd": ("layernorm_bwd_", "column_sum"),
              "ssd_bwd": ("ssd_bwd_state_mma", "ssd_bwd_chunk_mma",
                          "ssd_bwd_state<", "ssd_bwd_chunk<",
                          "ssd_bwd_group_sum")}
# Model gradients, kernels against plain versions, same weights and batch:
# at fp32 compute over MODEL_FP32_LAYERS layers every leaf within
# MODEL_FP32_TOL x max|g| (as FP32_DECODE_TOL holds logits); at bf16 over
# the TRAIN_LAYERS cut the whole flattened gradient by relative L2 within
# MODEL_BF16_RTOL (each leaf's printed)
MODEL_FP32_LAYERS, MODEL_FP32_TOL, MODEL_BF16_RTOL = 2, 2e-3, 5e-2
# Fault and resume on the card: reduced qwen3-4b (fp32), FAULT_STEPS steps
# of 8 x 64 tokens, a checkpoint every 5, a fault injected at FAULT_AT; the
# resumed run's losses within FAULT_RTOL of an uninterrupted run's
FAULT_STEPS, FAULT_AT, FAULT_RTOL = 12, 7, 1e-6
# Operations of one tanh-GELU (x³, times 0.044715, plus x, times
# sqrt(2/pi), tanh, plus 1, times x / 2)
GELU_FLOPS = 9
# Peak rates from NVIDIA's data sheets: fp32 FLOP/s outside the tensor
# cores, dense bf16 FLOP/s of the tensor cores, device-memory bytes/s.
PEAKS = (("H100 PCIe", 51e12, 756e12, 2.0e12),
         ("H100 NVL", 60e12, 835e12, 3.9e12),
         ("H200", 67e12, 989e12, 4.8e12),
         ("H100", 67e12, 989e12, 3.35e12))
REPLACES = {
    "flex_gemm": "src/repro/kernels/flex_gemm.py:58",
    "sfu_softmax": "src/repro/kernels/sfu.py:32",
    "sfu_layernorm": "src/repro/kernels/sfu.py:41",
    "sfu_act": "src/repro/kernels/sfu.py:67",
    "rmsnorm": "src/repro/kernels/sfu.py:56",
    "flash_attention": "src/repro/kernels/flash_attention.py:28",
    "ssd": "src/repro/kernels/ssd.py:31",
    # no Pallas kernel has a backward: the reference differentiates its jnp
    # norms, attention and SSD (src/repro/models/layers.py,
    # src/repro/kernels/ops.py)
    "rmsnorm_bwd": "src/repro/models/layers.py:40",
    "flash_attention_bwd": "src/repro/models/layers.py:158",
    "layernorm_bwd": "src/repro/models/layers.py:39",
    "ssd_bwd": "src/repro/kernels/ops.py:121",
}
SOURCES = {
    "flex_gemm": "src/repro_torch/kernels/csrc/flex_gemm.cu",
    "sfu_softmax": "src/repro_torch/kernels/csrc/sfu.cu",
    "sfu_layernorm": "src/repro_torch/kernels/csrc/sfu.cu",
    "sfu_act": "src/repro_torch/kernels/csrc/sfu.cu",
    "rmsnorm": "src/repro_torch/kernels/csrc/sfu.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "ssd": "src/repro_torch/kernels/csrc/ssd.cu",
    "rmsnorm_bwd": "src/repro_torch/kernels/csrc/sfu.cu",
    "flash_attention_bwd": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "layernorm_bwd": "src/repro_torch/kernels/csrc/sfu.cu",
    "ssd_bwd": "src/repro_torch/kernels/csrc/ssd.cu",
}
DORA_KERNELS = ("flex_gemm", "sfu_softmax", "sfu_layernorm", "sfu_act")
# The mesh phase (ROADMAP A.6): the multi-device layer on the card's one-
# device mesh, (data 1, model 1) over a world of one (NCCL takes one rank
# a card).  qwen3-4b served at full width and depth as the serving phase
# serves it, the step bundles at 4 x 512 (prefill) and a 1,024-row cache
# (decode), mamba2-2.7b cut to MESH_SSM_LAYERS, whisper-medium cut to
# MESH_WHISPER_LAYERS encoder and decoder layers (MESH_DECODE_STEPS greedy
# steps), qwen3-4b's training cut for MESH_TRAIN_STEPS steps with a
# checkpoint at the last, each against the same run without the mesh.
# Logits are held bit for bit; where an op's DTensor path reorders a sum
# the check falls to relative L2 within MESH_RTOL (a tenth of SERVE_RTOL)
# and the op is named.  The compression check takes the gradients of
# MESH_COMPRESS_LEAVES (a product's weight, the largest matrix, a norm's
# gain) of the meshless training state.  The phase prints its seconds.
MESH_SSM_LAYERS, MESH_WHISPER_LAYERS, MESH_DECODE_STEPS = 8, 4, 8
MESH_TRAIN_STEPS, MESH_RTOL = 3, 2e-3
# the mesh's Trainer and checkpoint check on qwen3-4b cut to
# MESH_TRAIN_LAYERS layers: it holds the two runs bit for bit, which
# depth does not change, and at 2 layers (0.980 B parameters, 11.8 GB of
# fp32 parameters and moments) its three checkpoint transfers move less
# than TRAIN_LAYERS' 19.0 GB (1.585 B) each (ROADMAP H.9)
MESH_TRAIN_LAYERS = 2
MESH_COMPRESS_LEAVES = ("layers/0/attn/wq", "layers/0/mlp/w_down",
                        "final_norm/scale")
# The examples phase: examples_torch/ on the card, each through its run()
# with the counts from 0.  quickstart (BERT-S, stage-2 MILP) is held as the
# DORA path is (launches equal to the binary's lead MMU_GEMM and SFU_*
# counts, every layer's chained output within CHAIN_RTOL); serve_batch at
# its defaults (reduced qwen3-4b, 4 requests, 24 new tokens) by its
# launches and its greedy tokens, which the same weights teacher-forced
# through the kernels must give again (and the plain versions within
# SERVE_RTOL); train_lm's 100m preset at its full width for EX_TRAIN_STEPS
# steps (its "few hundred") with a fault at EX_TRAIN_FAIL_AT, which
# resumes from the last checkpoint (every CKPT_EVERY steps) and replays
# the steps since within FAULT_RTOL; the mean loss of its last
# EX_TRAIN_TAIL steps must fall below the first step's; its step times
# are read past the first EX_TRAIN_WARM steps; grad_compression over the
# card's NCCL world, its fp32 path equal to full-batch gradient descent on
# one process within EX_GD_TOL x max|w|.  dora_scheduling is numpy only
# and touches no device: its tests run it on the CPU.
EX_TRAIN_STEPS, EX_TRAIN_FAIL_AT = 300, 160
EX_TRAIN_TAIL, EX_TRAIN_WARM, EX_GD_TOL = 10, 5, 1e-5
# The long-context phase: the reference's assigned shapes
# (src/repro/configs/shapes.py: prefill_32k, decode_32k, long_500k,
# train_4k) on one card at full width, each global batch cut to fit its
# 80 GB (PERF.md section 4).  qwen3-4b at full depth serves LONG_BATCH
# prompts of LONG_PROMPT tokens (seeds 0, 1, ...; no padding) and LONG_NEW
# greedy tokens from one BatchServer of LONG_MAX_LEN cache rows.  Past
# attn_chunk_threshold both packages' plain attention runs over 1,024-row
# query chunks and refuses a prompt that they do not divide (ROADMAP C.3),
# hence 32,768 prompt tokens and 32 more cache rows.  Its launches are the
# serving phase's a step.  Its teacher-forced logits, kernels against
# plain versions, are held within SERVE_RTOL over the weights' first
# LONG_SHALLOW_LAYERS layers.  At full depth no two bf16 runs that differ
# anywhere stay within SERVE_RTOL at this length: each sits ~1.9 % from
# fp32 arithmetic on the same weights (PERF.md section 6; ROADMAP C.8).
# So at full depth the kernels are held as near fp32 arithmetic on the
# same bf16 weights as the plain versions are, within LONG_FP32_SLACK
# times (the slack the MoE training cuts give the same kind of witness),
# every pass and every row; the fp32 run takes the plain versions and so
# shares no code with the kernels.  Kernels vs plain at full depth is
# printed.  The bound's power is shown on every run: the kernels with each
# of LONG_FAULTS planted (through kernels.ops, on the first row) must fail
# it.  flash_attention alone at L1's prefill and decode shapes, bf16 and
# fp32, is held against its plain version within LONG_ATTN_RTOL relative
# L2 (at 32k keys an output is of order 1/sqrt(keys) of v, so an absolute
# tolerance would not see a fault), and its decode over the rows past its
# plan's first split must sit outside that bound from the whole.  The
# other dense archs (DENSE_ARCHS, L4-L7) and whisper-medium (L8, through
# encdec: its encoder over as many stub frames as prompt tokens, the
# reference's _enc_len) serve the same prompts at full width and depth,
# their launches each prefill and step path_launches' (encdec_launches'),
# every served token in range; at full depth no bound holds them (the
# full-depth plain and fp32 runs would cost minutes), so their weights'
# first LONG_SHALLOW_LAYERS layers (whisper's encoder and decoder) are
# teacher-forced on the served tokens, kernels against plain versions,
# in bf16 within SERVE_RTOL at every pass, and at fp32 compute on the same
# weights over the prefill and LONG_FP32_STEPS decode steps within
# FP32_DECODE_TOL x max|logit| (fp32 reorderings alone).  Before them the
# kernels alone at their shapes: flash_attention's non-causal prefill at
# whisper's D 64, the causal ones at internlm2-20b's and qwen1.5-4b's
# heads, decode over whisper's cross rows and qwen1.5-4b's cache (with a
# dropped split planted), the layernorm and rmsnorm kernels on the
# prefill's 65,536 rows of each width, bf16 and fp32, each bf16 one
# timed over LONG_TIME_ITERS calls beside its library call and its bound
# (the plain version once).  One cache is held at a time.  mamba2-2.7b at
# full depth
# serves one prompt of LONG_SSM_PROMPT tokens and LONG_NEW tokens: its
# launches, its teacher-forced logits finite at every step, and its first
# decode step within SSM_RTOL of the kernels' prefill over the prompt and
# that token (the state after 4,096 chunks carries into decode).  Its
# plain SSD would hold 80 heads of b and c in fp32 (21.5 GB each), so the
# ssd kernel alone at (1, LONG_SSM_PROMPT, 80, 64), bf16 and fp32, from
# zero and from an initial state, is held against ref.ssd_chained over
# LONG_SSD_SEGMENT positions at a time (the same recurrence) with
# check_ssd's tolerances.  Trainer takes LONG_TRAIN_STEPS steps of
# LONG_TRAIN_SEQ tokens a row, LONG_TRAIN_BATCH rows, on qwen3-4b's
# TRAIN_LAYERS cut and on mamba2-2.7b, whisper-medium and qwen2-vl-2b at
# full depth (peak lr LONG_TRAIN_PEAK_LR), held as the training phase
# holds its Trainer runs; phase 6 holds the backward kernels at those
# shapes.
LONG_BATCH, LONG_PROMPT, LONG_MAX_LEN, LONG_NEW = 2, 32768, 32800, 32
LONG_SHALLOW_LAYERS, LONG_FP32_SLACK, LONG_FP32_STEPS = 2, 1.25, 8
LONG_TIME_ITERS = 3
LONG_ATTN_RTOL = {"bfloat16": 2e-2, "float32": 1e-4}
# (what, how much): every rmsnorm kernel's output scaled by 1 + how much;
# decode's attention without the first split of its plan's rows
LONG_FAULTS = (("rmsnorm", 2 ** -7), ("attention", "first split"))
LONG_SSM_PROMPT, LONG_SSD_SEGMENT = 524288, 16384
LONG_TRAIN_SEQ, LONG_TRAIN_STEPS = 4096, 10
LONG_TRAIN_BATCH = {"qwen3-4b": 2, "mamba2-2.7b": 1, WHISPER_ARCH: 2,
                    MROPE_ARCH: 2}
# Their peak lr where TRAIN_PEAK_LR does not train them in 10 steps
# (ROADMAP C.9): at 1e-3 qwen3-4b's cut at 2 x 4,096 falls to step 4
# (12.452 -> 12.323) and then rises (the last 3 steps' mean 12.470), and
# so does the same run in fp32 arithmetic on the plain versions, with no
# kernel and no bf16 rounding (12.478), within 0.01 of it at every step.
# From step 4 its gradient norm is 0.66-0.89, a sixth of step 0's 4.24,
# while AdamW, whose step does not shrink with the gradient, still moves
# the head, attention and MLP weights by 1.6-1.8 % of their RMS at step 4
# and 1.1-1.3 % at step 5: more than the gradient supports.  At 5e-4 the
# steps are half that and the loss falls (12.355).  The port's step is
# the reference's at this shape and schedule (tests/test_torch_train_4k.py);
# PERF.md section 6 and experiments_torch/train_lr.py give the readings
LONG_TRAIN_PEAK_LR = {"qwen3-4b": 5e-4}
# The MoE archs' prefill_32k and decode_32k (L9-L11): L1's traffic through
# BatchServer at full width (d, heads, d_ff, vocab, top-k, capacity factor
# 1.25, route groups of 1,024 tokens), cut in depth, and jamba in experts
# as MOE_CUTS cuts it: ``dataclasses.replace(get_config(arch), **cut)``,
# jamba's pattern cut to its first n_layers positions.  At 2 x 32,768
# tokens a MoE layer routes 64 groups of 1,024, each expert taking cap =
# ceil(1,024 K / E x 1.25) slots of each; bf16 GiB by
# ArchConfig.param_count, peaks estimated from the shapes:
# - dbrx-132b, its first 4 of 40 layers (26.58 GiB; MOE_CUTS' 8 hold
#   50.86): 64 x 320 x 16 = 327,680 slots, xe 3.75 GiB, each 10,752-wide
#   intermediate 6.56 GiB (three live), the KV cache 1.00 GiB: ~58 GiB;
# - llama4-maverick, MOE_CUTS' block of 2 (34.32 GiB): 64 x 10 x 128 =
#   81,920 slots, each 8,192-wide intermediate 1.25 GiB, the dense FFN's
#   1.0 GiB, KV 0.50 GiB: ~42 GiB;
# - jamba-1.5-large, its first 4 pattern positions (attn+dense, ssm+moe,
#   ssm+dense, ssm+moe) with 8 of 16 experts (24.81 GiB): 64 x 320 x 8 =
#   163,840 slots, each 24,576-wide intermediate 7.50 GiB, xe 2.50 GiB,
#   the dense FFN's 3.0 GiB, ssd's x 2.0 GiB, KV 0.25 GiB: ~57 GiB
#   (served peak 58.44 on the H100).  MOE_CUTS' 12 experts (33.81 GiB;
#   64 x 214 x 12 = 164,352 slots, estimated ~65 GiB) served at 67.52
#   GiB alone, and after the earlier phases the served prefill ran out
#   of memory (63.21 GiB allocated, 10.09 more reserved in pieces, 7.52
#   asked), so the cut takes 8.  The plain SSD's (1, 256, 256, 128, 128)
#   fp32 chunk terms at 256 heads take 4 GiB each over one row of 32,768
#   positions, and one row's plain pass ran out of memory with them:
#   ref.ssd_plain runs SSD_PLAIN_SEGMENT positions at a time.
# Held as the serving phase holds MOE_CUTS (MOE_SHALLOW_LAYERS, ROUTE_
# MARGIN, MOE_RTOL), at fp32 compute on the served weights' first
# MOE_SHALLOW_LAYERS layers over the prefill and LONG_FP32_STEPS decode
# steps; llama4's fp32 MoE layer alone (60 GiB) on the 32k prompt's MoE
# inputs.  On LONG_ROUTES_VS_FP32's cuts the first MOE_SHALLOW_LAYERS
# layers' routes are held as ROUTES_VS_FP32 holds jamba's training cut,
# against an fp32 evaluation (``routes_vs_fp32``), and that bound's power
# is shown: with every norm kernel's output scaled by 1 + LONG_ROUTE_FAULT
# the kernels' routes must fall outside it.  jamba for the reason C.6
# gives; dbrx-132b because at 32k its second MoE layer's pinned run
# decides otherwise than the plain path at margins of 0.0122-0.0170 over
# two seeds, and the plain path otherwise than fp32 at 0.0161-0.0193
# (ROADMAP C.10).  A teacher-forced pass holds the plain path beside the served
# weights: its one-hot dispatch at dbrx's 2 rows ((64, 4,096, 16, 320)
# fp32, 5.0 GiB, plus the one-hot xe and three 6.56 GiB intermediates)
# and the plain SSD at jamba's 256 heads would pass the card's 79 GiB, so
# those passes run LONG_MOE_ROWS rows at a time on the same tokens (a
# route group never spans rows), and so does llama4's fp32 layer (60 GiB
# of weights)
LONG_MOE_CUTS = {"dbrx-132b": {"n_layers": 4},
                 "llama4-maverick-400b-a17b": {"n_layers": 2},
                 "jamba-1.5-large-398b": {"n_layers": 4, "n_experts": 8}}
LONG_MOE_ROWS = {"dbrx-132b": 1, "llama4-maverick-400b-a17b": 2,
                 "jamba-1.5-large-398b": 1}
LONG_ROUTES_VS_FP32 = ("dbrx-132b", "jamba-1.5-large-398b")
# On LONG_LOGITS_VS_FP32's cuts the pinned runs of the first
# MOE_SHALLOW_LAYERS layers are held by C.8's method: the kernels as near
# an fp32 witness as the plain versions (``pinned_witness``), each row's
# mean over its passes within LONG_FP32_SLACK times, the planted norm
# fault past that; the SERVE_RTOL reading is printed.  jamba-1.5-large
# because at 32k its first 2 layers (attention + dense FFN, SSM + MoE)
# through the kernels sat 0.015-0.026 from the plain versions at 8 and
# 12 experts, while over row 0's 32 passes the plain versions themselves
# sat 0.015-0.033 from fp32 and the kernels 0.016-0.037 (means 0.0200
# and 0.0214), none nearer with any one of ssd, rmsnorm or attention on
# its plain version: bf16's own drift.  A pass's ratio of two such
# distances spread from 0.68 to 1.55, so the mean is held (ROADMAP C.11)
LONG_LOGITS_VS_FP32 = ("jamba-1.5-large-398b",)
LONG_ROUTE_FAULT = 2 ** -7
# The four-card mode (``--cards 4``): a world of CARDS ranks, one a card,
# joined over NCCL by a FileStore; every rank checks itself and a failed
# rank stops the world.  qwen3-4b served at full width and depth on each
# of CARD_MESHES, (data, model), held per rank to the meshless launches,
# at fp32 over CARDS_FP32_LAYERS layers to one card's (FP32_DECODE_TOL),
# and in bf16, teacher-forced, every pass and row, as near fp32 arithmetic
# on the same bf16 weights (the plain versions on rank 0's card) as rank
# 0's one-card bf16 server is, within LONG_FP32_SLACK times: a row-parallel
# product's bf16 sum is one more rounding on a mesh, and two bf16 runs
# that differ anywhere part to bf16's own error at full depth (ROADMAP
# C.7, as C.8 on one card); over the first LONG_SHALLOW_LAYERS layers the
# mesh stays within SERVE_RTOL of one card, and each of CARDS_FAULTS
# planted on the mesh must fail the ratio bound; where the bf16 gap opens
# is read, not held: the prefill's logits after the first k of
# CARDS_DEPTHS layers, mesh against one card and both against the fp32
# witness; dbrx-132b served
# at full depth on CARDS_MOE_MESH (its experts over the model axis), its
# logits over its first MOE_SHALLOW_LAYERS layers and CARDS_MOE_CUT layers
# held with each MoE call pinned to the plain path's routes (SERVE_RTOL,
# MOE_RTOL); qwen3-4b's training cut trained on each mesh, its step 0
# through the Trainer's own step against rank 0's one-card step: the loss
# and the gradient read back from the first moments (CARDS_LOSS_RTOL,
# MODEL_BF16_RTOL);
# nemotron-4-15b trained at full width and depth on CARDS_TRAIN_MESH, its
# peak under CARD_TRAIN_GB a card; grad_compression over the world against
# its gloo run on the CPU (EX_GD_TOL); a reduced dbrx-132b training state
# saved from (2, 2) and restored onto (1, 4) and onto one card, bit for
# bit.  A card's load peak of a server stays under its block of the cast
# parameters plus the largest fp32 item plus 1 GiB.  The world's ranks
# stop after CARDS_DEADLINE_S seconds.
CARDS, CARD_MESHES, CARDS_FP32_LAYERS = 4, ((1, 4), (2, 2), (4, 1)), 4
CARDS_MOE_ARCH, CARDS_MOE_MESH, CARDS_MOE_CUT = "dbrx-132b", (1, 4), 8
CARDS_TRAIN_ARCH, CARDS_TRAIN_MESH = "nemotron-4-15b", (2, 2)
CARDS_LOSS_RTOL, CARDS_DEADLINE_S = 1e-3, 1140
CARDS_DEPTHS = (1, 2, 4, 9, 18, 36)
# the faults planted on each mesh in M4.1, by how much each scales: every
# rmsnorm output (LONG_FAULTS' first), and where the model axis splits wo,
# the block of every layer's wo on the ranks at its first coordinate
CARDS_FAULTS = (2 ** -7, 2 ** -7)
SERVING_KERNELS = ("rmsnorm", "flash_attention", "ssd")
TRAINING_KERNELS = ("rmsnorm_bwd", "flash_attention_bwd", "layernorm_bwd",
                    "ssd_bwd")
# the CUDA kernels of one ssd call (csrc/ssd.cu)
SSD_PHASES = ("ssd_state_", "ssd_scan_")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def peaks(name: str) -> tuple[float, float, float]:
    for key, fp32, bf16, bw in PEAKS:
        if key in name:
            return fp32, bf16, bw
    print(f"note: no data-sheet peaks for {name!r}; using the H100 SXM's")
    return PEAKS[-1][1:]


def causal_pairs(sq: int, skv: int) -> int:
    """(query, key) pairs a causal attention computes: row i sees
    keys 0 .. i + skv - sq."""
    return sum(max(0, min(skv, i + skv - sq + 1)) for i in range(sq))


def ssd_work(B, S, H, P, G, N, chunk, esize) -> tuple[int, int]:
    """(FLOPs, bytes) of the chunked SSD.  Per (row, chunk of true length
    L): C Bᵀ and its product with X over the causal pairs only, L(L+1)/2
    (N + P) multiply-adds (the pairs above the diagonal are 0 and need
    none, as ``causal_pairs`` counts for attention), plus the readout of
    the carried state and its update, 2LNP.  Bytes: x and y (``esize``
    bytes an element), a (fp32) and b, c (once per group) read or written
    once, plus the fp32 final state."""
    lens = [min(chunk, S - s) for s in range(0, S, chunk)]
    macs = B * H * sum(L * (L + 1) // 2 * (N + P) + 2 * L * N * P
                       for L in lens)
    nbytes = esize * (2 * B * S * H * P + 2 * B * S * G * N) \
        + 4 * B * S * H + 4 * B * H * P * N
    return 2 * macs, nbytes


def ssd_bwd_work(B, S, H, P, G, N, chunk, esize) -> tuple[int, int]:
    """(FLOPs, bytes) of the SSD backward.  Per (row, chunk of true length
    L): C Bᵀ, dY Xᵀ, Rᵀ dY, Zᵀ C and Z B over the causal pairs only,
    L(L+1)/2 (3N + 2P) multiply-adds, plus the four products with the
    carried state or its gradient (w ∘ B Gᵀ, w ∘ X G, e ∘ dY S_prev, and
    the reverse recurrence dYᵀ (C ∘ e)), 4LNP.  Bytes: x, dy, dx (``esize``
    bytes an element), b, c, db, dc (once per group), a and da (fp32) read
    or written once, and the forward's saved fp32 states read once."""
    lens = [min(chunk, S - s) for s in range(0, S, chunk)]
    macs = B * H * sum(L * (L + 1) // 2 * (3 * N + 2 * P) + 4 * L * N * P
                       for L in lens)
    nbytes = esize * (3 * B * S * H * P + 4 * B * S * G * N) \
        + 8 * B * S * H + 4 * B * len(lens) * H * P * N
    return 2 * macs, nbytes


def mangled_is(mangled: str, name: str) -> bool:
    """Whether a mangled kernel name is ``name`` (a template's
    instantiation, ``nameI...``, or a plain function, ``nameE...``)."""
    return bool(re.search(rf"\d{name}[IE]", mangled))


def kernel_label(mangled: str, name: str) -> str:
    """``name<template arguments>`` from a kernel's mangled name (``name``
    for a plain function)."""
    if name + "I" not in mangled:
        return name
    args = mangled.split(name + "I", 1)[-1].split("Ev", 1)[0]
    found = re.findall(r"Li(\d+)|Lb([01])|__nv_(bfloat16)|^(f)(?=[EL])",
                       args)
    return f"{name}<" + ", ".join(
        n or ("false", "true")[int(t)] if n or t else b or "float"
        for n, t, b, _ in found) + ">"


def rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def cuda_ms(torch, fn, iters: int = 50) -> tuple[float, float]:
    """(device ms, back-to-back ms) per call of ``fn``, by CUDA events.

    Device: a spin kernel holds the card while the host queues all
    ``iters`` calls, so the events bracket device work alone (the host
    takes tens of microseconds per call, longer than many of these
    kernels).  Back-to-back: the same loop without the spin, which is
    what a caller issuing calls one after another gets."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for spin in (True, False):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return times[0], times[1]


def event_ms(torch, fn):
    """(``fn()``, its ms between CUDA events recorded around the one call):
    for calls too long to repeat, the card synchronized first."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def time_row(smi: str, bw_peak: float, name: str, shape: str, kernel, plain,
             library, flops: float, nbytes: float, peak: float,
             before=None, iters: int = 50):
    """Prints and returns a kernel's device ms (``cuda_ms``) beside its
    plain version's (timed the same way, or a float of ms taken before),
    the library call's (None: there is none), and the card's bound,
    max(``flops`` / ``peak``, ``nbytes`` / ``bw_peak``); ``before``: its
    ms before a redesign, as recorded.  (ms, plain ms, library ms, bound
    ms, what bounds it.)"""
    import torch
    ms, ms_b2b = cuda_ms(torch, kernel, iters)
    plain_ms, plain_b2b = ((plain, None) if isinstance(plain, float)
                           else cuda_ms(torch, plain, iters))
    lib_ms, lib_b2b = (cuda_ms(torch, library, iters) if library
                       else (None, None))
    t_ops, t_bytes = flops / peak, nbytes / bw_peak
    bound_ms = 1e3 * max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    lib = "library none" if library is None else f"library {lib_ms:.4f}"
    once = " (one call)" if plain_b2b is None else ""
    was = ("" if before is None else
           f" [before the redesign, recorded in PERF.md: {before:.4f}]")
    b2b = "" if plain_b2b is None else f", plain {plain_b2b:.4f}"
    lib_b = "" if library is None else f", library {lib_b2b:.4f}"
    print(f"[time] {name} {shape}: device ms: kernel {ms:.4f}{was}, plain "
          f"{plain_ms:.4f}{once}, {lib}, bound {bound_ms:.4f} ({bound_by}, "
          f"{flops / 1e9:.4g} GFLOP, {nbytes / 1e6:.4g} MB); back-to-back "
          f"ms: kernel {ms_b2b:.4f}{b2b}{lib_b}; on {smi}")
    return ms, plain_ms, lib_ms, bound_ms, bound_by


def ln_affine(xb, g, bt):
    """The gamma and beta ``F.layer_norm`` takes beside bf16 rows: fp32,
    or bf16 where PyTorch refuses fp32 ones there (the yardstick's choice
    only; the kernel takes fp32)."""
    import torch
    import torch.nn.functional as F
    try:
        F.layer_norm(xb[:1], (xb.shape[1],), g, bt, 1e-5)
    except RuntimeError:
        return g.to(torch.bfloat16), bt.to(torch.bfloat16)
    return g, bt


def sdpa_call(q, k, v, causal: bool):
    """A call of ``F.scaled_dot_product_attention`` computing what
    ``flash_attention`` computes on these operands, on PyTorch's
    FlashAttention backend (its math backend would hold every score):
    with ``enable_gqa`` where that backend takes it, else over k and v
    repeated to q's heads beforehand."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call(kk, vv, **kw):
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
            return F.scaled_dot_product_attention(q, kk, vv,
                                                  is_causal=causal, **kw)
    if q.shape[1] == k.shape[1]:
        return lambda: call(k, v)
    try:
        call(k, v, enable_gqa=True)
        return lambda: call(k, v, enable_gqa=True)
    except RuntimeError:
        r = q.shape[1] // k.shape[1]
        kr, vr = (t.repeat_interleave(r, dim=1) for t in (k, v))
        return lambda: call(kr, vr)


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0


def close(got, want, rtol: float, atol: float) -> bool:
    return bool(((got.float() - want.float()).abs()
                 <= atol + rtol * want.float().abs()).all())


def binary_launches(res) -> dict:
    """Launches a run of ``res``'s binary must make: its lead
    ``MMU_GEMM`` and its ``SFU_*`` instructions; no serving kernel."""
    from repro_torch.core import OpType
    from repro_torch.core.runtime import SFU_ACT
    sfu_ops = {"sfu_softmax": {OpType.SFU_SOFTMAX},
               "sfu_layernorm": {OpType.SFU_LAYERNORM},
               "sfu_act": set(SFU_ACT)}
    prog = res.codegen.program.instructions
    expected = {k: sum(1 for i in prog if i.op_type in ops)
                for k, ops in sfu_ops.items()}
    expected["flex_gemm"] = sum(1 for i in prog
                                if i.op_type == OpType.MMU_GEMM
                                and i.body.ping_op == 1)
    return expected | {k: 0 for k in SERVING_KERNELS + TRAINING_KERNELS}


def path_launches(cfg) -> tuple[dict, dict, str]:
    """Kernel launches per prefill or decode step, and in the prefill
    only, of a decoder, with their derivation from its layer pattern:
    norm1 a layer, norm2 a layer with an FFN (dense or MoE) and the
    final norm on the rmsnorm kernel (or the layernorm kernel, on the
    bf16 rows); the gated norm of an SSM layer, and q- and k-norm an
    attention layer on rmsnorm where the arch has them; one attention
    an attention layer; one ``ssd`` an SSM layer, in the prefill only
    (decode updates the state in plain PyTorch, as the reference
    does).  The MoE FFN launches none of the kernels."""
    layers_ = [cfg.pattern[i % cfg.pattern_len]
               for i in range(cfg.n_layers)]
    attn = sum(p.mixer == "attn" for p in layers_)
    ssm = len(layers_) - attn
    ffn = sum(p.ffn != "none" for p in layers_)
    L = len(layers_)
    norm = "sfu_layernorm" if cfg.norm_kind == "layernorm" else "rmsnorm"
    steps = Counter({norm: L + ffn + 1})
    why = [f"{norm} {L + ffn + 1} = {L} norm1 + {ffn} norm2 + 1 final"]
    if ssm:
        steps["rmsnorm"] += ssm
        why.append(f"rmsnorm {ssm} gated norms of the SSM layers")
    if cfg.qk_norm and attn:
        steps["rmsnorm"] += 2 * attn
        why.append(f"rmsnorm q/k-norm 2 x {attn} attention layers")
    if attn:
        steps["flash_attention"] = attn
        why.append(f"flash_attention {attn} = 1 x {attn} attention "
                   f"layers")
    prefill = {"ssd": ssm} if ssm else {}
    if ssm:
        why.append(f"ssd 1 x {ssm} SSM layers in the prefill only")
    return dict(steps), prefill, "x (" + "; ".join(why) + ")"


def encdec_launches(cfg) -> tuple[dict, dict, str]:
    """Kernel launches of an encoder-decoder's prefill and of each decode
    step, with their derivation: two layernorms an encoder layer and its
    final norm, three a decoder layer and its final norm; attention once
    an encoder layer and twice a decoder layer (self, cross).  A decode
    step runs the decoder alone."""
    E, D = cfg.encoder_layers, cfg.n_layers
    prefill = {"sfu_layernorm": 2 * E + 1 + 3 * D + 1,
               "flash_attention": E + 2 * D}
    step = {"sfu_layernorm": 3 * D + 1, "flash_attention": 2 * D}
    return prefill, step, (
        f"prefill sfu_layernorm {prefill['sfu_layernorm']} = 2 x {E} encoder"
        f" layers + 1 + 3 x {D} decoder layers + 1, flash_attention "
        f"{prefill['flash_attention']} = {E} encoder + {D} self + {D} cross;"
        f" a decode step sfu_layernorm {step['sfu_layernorm']}, "
        f"flash_attention {step['flash_attention']} = {D} self + {D} cross")


def train_launches(tcfg) -> tuple[dict, str]:
    """Kernel launches a train step, with their derivation: the forward's
    (``path_launches``, ``ssd`` included; an encoder-decoder's prefill,
    ``encdec_launches``), each layer's again in the remat recompute (all
    but the final norms, which run outside it), and one backward a
    forward call outside the recompute."""
    if tcfg.is_encdec:
        E, D = tcfg.encoder_layers, tcfg.n_layers
        norms, attn = 2 * E + 3 * D, E + 2 * D
        again = tcfg.remat
        per_step = {"sfu_layernorm": norms + 2 + again * norms,
                    "layernorm_bwd": norms + 2,
                    "flash_attention": attn * (1 + again),
                    "flash_attention_bwd": attn}
        return per_step, (
            f"sfu_layernorm {per_step['sfu_layernorm']} = ({2 * E} encoder "
            f"norms + 1 final encoder norm + {3 * D} decoder norms + 1 final "
            f"norm) in the forward" + (f" + {norms} in the remat recompute"
                                       if again else "")
            + f"; layernorm_bwd {norms + 2}; flash_attention "
            f"{per_step['flash_attention']} = ({E} encoder + {D} self + {D} "
            f"cross){' x 2 (forward, recompute)' if again else ''}; "
            f"flash_attention_bwd {attn}")
    steps, prefill, why = path_launches(tcfg)
    norm = "sfu_layernorm" if tcfg.norm_kind == "layernorm" \
        else "rmsnorm"
    bwd = {"rmsnorm": "rmsnorm_bwd", "sfu_layernorm": "layernorm_bwd",
           "flash_attention": "flash_attention_bwd", "ssd": "ssd_bwd"}
    per_step = Counter()
    for k, n in (Counter(steps) + Counter(prefill)).items():
        per_step[k] += n + (n - (k == norm) if tcfg.remat else 0)
        per_step[bwd[k]] += n
    return dict(per_step), (
        f"{dict(per_step)}: the forward {why}"
        + (", each layer again in the remat recompute (the final norm "
           "outside it)" if tcfg.remat else "")
        + ", one backward a forward call")


def load_bytes(cfg) -> tuple[int, int, int]:
    """From the config: bytes of the parameters in the compute dtype;
    of the largest fp32 item ``lm.init_cast`` holds (the embedding or
    head, V x d, one layer, or in a MoE layer its mixer, norms and
    router, or one expert matrix, d x d_ff); and of the most it holds
    at once if it holds one fp32 item: everything cast so far beside
    the fp32 item being drawn (a MoE leaf counts whole from its first
    expert on: it is allocated whole, then filled)."""
    import dataclasses

    import torch
    esize = torch.empty((), dtype=getattr(torch, cfg.compute_dtype)
                        ).element_size()
    d, vd = cfg.d_model, cfg.vocab_size * cfg.d_model
    matrices = 3 if cfg.mlp_kind == "swiglu" else 2
    cast, held, item = 0, 0, 0

    def draw(fp32, leaf):
        nonlocal cast, held, item
        cast += leaf
        held, item = max(held, esize * cast + 4 * fp32), max(item, fp32)

    draw(vd, vd)                                   # embed
    draw(vd, vd)                                   # lm_head
    draw(d, d)                                     # final norm
    for i in range(cfg.n_layers):
        pat = cfg.pattern[i % cfg.pattern_len]
        layer = dataclasses.replace(cfg, pattern=(pat,), n_layers=1
                                    ).param_count() - 2 * vd - d
        if pat.ffn != "moe":
            draw(layer, layer)
            continue
        expert = cfg.n_experts * cfg.d_model * cfg.d_ff
        draw(layer - matrices * expert, layer - matrices * expert)
        for _ in range(matrices):
            draw(cfg.d_model * cfg.d_ff, expert)
    return esize * cfg.param_count(), 4 * item, held


def mesh_phase(counters, launches, zero_counts, smi) -> None:
    """The multi-device layer on the card's (1, 1) mesh, each path against
    the same path without the mesh (see ``MESH_*``).  The mesh paths'
    launches, each counted from 0, are added to ``launches``."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import checkpoint as ckpt
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import BatchServer, Request
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.launch.train import TrainOptions, Trainer
    from repro_torch.models import encdec, lm
    from repro_torch.optim import OptConfig, compression
    from repro_torch.parallel import sharding as SH

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    mesh = make_local_mesh()
    require(tuple(mesh.shape) == (1, 1) and mesh.device_type == "cuda"
            and dist.get_backend() == "nccl",
            f"the card's mesh is {mesh} over {dist.get_backend()}")

    t_lap = [time.perf_counter()]

    def lap() -> str:
        """Seconds since the last lap, for the phase's lines."""
        now = time.perf_counter()
        dt, t_lap[0] = now - t_lap[0], now
        return f" [{dt:.1f} s]"
    # NCCL sets up a communicator (and its device buffers) at a group's
    # first collective: set up the world's and each mesh axis's now,
    # before the phase fills the card
    torch.cuda.empty_cache()
    for group in (dist.group.WORLD, mesh.get_group("data"),
                  mesh.get_group("model")):
        dist.all_reduce(torch.zeros(1, device=dev), group=group)
    torch.cuda.synchronize()
    print(f"[mesh] {mesh.mesh_dim_names} {tuple(mesh.shape)} on cuda, "
          f"{dist.get_backend()} world of {dist.get_world_size()}; "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB held by the "
          f"phases before")

    def counted(fn, on_mesh: bool):
        """``fn()`` with the counts from 0; (its result, the counts).  A
        mesh path's counts join ``launches``."""
        zero_counts()
        out = fn()
        torch.cuda.synchronize()
        got = {k: f.launches for k, f in counters.items()}
        if on_mesh:
            for k, n in got.items():
                launches[k] += n
        return out, got

    def same(what, got, want) -> None:
        """Bit for bit, else within MESH_RTOL by relative L2 (printed)."""
        got = got.full_tensor() if isinstance(got, SH.DTensor) else got
        if torch.equal(got, want):
            return
        err = rel_l2(got, want)
        print(f"[mesh] {what}: not bit for bit, relative L2 {err:.3e}")
        require(err <= MESH_RTOL, f"{what}: relative L2 {err} over "
                f"{MESH_RTOL}")

    # qwen3-4b served with and without the mesh on the same weights
    cfg = get_config(SERVE_ARCH)
    params = lm.init_cast(cfg, torch.Generator(device=dev).manual_seed(0),
                          dev)
    plain_srv = BatchServer(cfg, max_len=SERVE_MAX_LEN, device=dev,
                            params=params)
    mesh_srv = BatchServer(cfg, max_len=SERVE_MAX_LEN, device=dev,
                           params=params, mesh=mesh)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in SERVE_PROMPTS]

    def requests(n=SERVE_NEW):
        return [Request(i, p, n) for i, p in enumerate(prompts)]

    for srv in (plain_srv, mesh_srv):
        srv.serve(requests(2))           # warm-up
    plain, plain_n = counted(lambda: plain_srv.serve(requests()), False)
    served, mesh_n = counted(lambda: mesh_srv.serve(requests()), True)
    require(served["outputs"] == plain["outputs"],
            "the mesh server's greedy tokens differ from the meshless one's")
    require(mesh_n == plain_n and mesh_n["rmsnorm"] == 145 * SERVE_NEW
            and mesh_n["flash_attention"] == 36 * SERVE_NEW,
            f"mesh serving launches {mesh_n} vs meshless {plain_n}")
    print(f"[mesh] {cfg.name} served on the mesh: the meshless server's "
          f"greedy tokens and launches ({mesh_n['rmsnorm'] // SERVE_NEW} "
          f"rmsnorm, {mesh_n['flash_attention'] // SERVE_NEW} "
          f"flash_attention a step); prefill {served['prefill_s']:.4f} s vs "
          f"{plain['prefill_s']:.4f} s, decode {served['decode_s']:.4f} s vs "
          f"{plain['decode_s']:.4f} s (host clock) on {smi}" + lap())

    # teacher-forced on the served tokens, with and without the mesh
    B, plen = len(prompts), max(SERVE_PROMPTS)
    tok = np.zeros((B, plen), np.int64)
    for i, p in enumerate(prompts):
        tok[i, plen - len(p):] = p
    tok = torch.from_numpy(tok).to(dev)
    outs = torch.tensor([served["outputs"][i] for i in range(B)],
                        device=dev)

    want, _ = counted(lambda: forced_logits(plain_srv, tok, outs,
                                            MESH_DECODE_STEPS), False)
    got, _ = counted(lambda: forced_logits(mesh_srv, tok, outs,
                                           MESH_DECODE_STEPS), True)
    for t, (g, w) in enumerate(zip(got, want)):
        same(f"{cfg.name} teacher-forced step {t}", g, w)
    print(f"[mesh] {cfg.name} teacher-forced prefill + {MESH_DECODE_STEPS} "
          f"decode steps: logits as without the mesh" + lap())
    step_tok = outs[:, :1]
    for srv, label in ((plain_srv, "without"), (mesh_srv, "with")):
        _, cache = srv._on_mesh(lambda t: lm.prefill(
            cfg, srv.params, t, max_len=SERVE_MAX_LEN), tok)
        best = math.inf
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            srv._on_mesh(lambda s, c, q: lm.decode_step(
                cfg, srv.params, c, s, q), step_tok, cache, plen)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        print(f"[mesh] {cfg.name} decode step {label} the mesh: host ms "
              f"{best * 1e3:.3f} (least of 3) on {smi}" + lap())
        del cache

    # the step bundles against lm.prefill / lm.decode_step
    ptok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 512))).to(dev)
    pb = make_prefill_step(cfg, mesh, ShapeSpec("p", 512, 4, "prefill"))
    p_mesh, batch = pb.place(params, {"tokens": ptok})
    (got_l, got_c), _ = counted(lambda: pb(p_mesh, batch), True)
    want_l, want_c = lm.prefill(cfg, params, ptok)
    same("prefill bundle logits", got_l, want_l)
    for key, leaf in T.leaves_with_paths(want_c):
        same(f"prefill bundle cache {key}", SH.full(got_c)[key.split("/")[0]]
             [key.split("/")[1]], leaf)
    del got_c, want_c
    db = make_decode_step(cfg, mesh, ShapeSpec("d", 1024, 4, "decode"))
    want_l, want_c = lm.prefill(cfg, params, ptok, max_len=1024)
    with SH.use_rules(db.rules):
        _, got_c = lm.prefill(cfg, p_mesh, batch["tokens"], max_len=1024)
    step = want_l.argmax(-1)[:, None]
    (got_l, _), _ = counted(lambda: db(p_mesh, got_c, SH.place(
        step, db.in_shardings[2]), 512), True)
    want_l, _ = lm.decode_step(cfg, params, want_c, step, 512)
    same("decode bundle logits", got_l, want_l)
    print(f"[mesh] {cfg.name} bundles: make_prefill_step on 4 x 512 and "
          f"make_decode_step on a 1,024-row cache give lm.prefill's and "
          f"lm.decode_step's outputs" + lap())
    del plain_srv, mesh_srv, params, p_mesh, got_c, want_c, got_l, want_l
    torch.cuda.empty_cache()

    # mamba2-2.7b cut: the prefill's ssd calls on the mesh
    scfg = dataclasses.replace(get_config(SSM_ARCH), n_layers=MESH_SSM_LAYERS)
    sp = lm.init_cast(scfg, torch.Generator(device=dev).manual_seed(0), dev)
    srules = SH.make_rules(scfg, mesh)
    sp_mesh = SH.distribute(sp, lm.param_specs(scfg), srules)
    stok = torch.from_numpy(rng.integers(0, scfg.vocab_size,
                                         (4, 512))).to(dev)
    want_l, want_c = lm.prefill(scfg, sp, stok)

    def ssm_prefill():
        with SH.use_rules(srules):
            return lm.prefill(scfg, sp_mesh, SH.place(
                stok, srules.sharding_for(("batch", None), (4, 512))))
    (got_l, got_c), n = counted(ssm_prefill, True)
    require(n["ssd"] == MESH_SSM_LAYERS, f"{n['ssd']} ssd calls on the mesh")
    same(f"{scfg.name} cut prefill logits", got_l, want_l)
    same(f"{scfg.name} cut prefill SSD state",
         SH.full(got_c)["pos0"]["state"], want_c["pos0"]["state"])
    print(f"[mesh] {scfg.name} ({MESH_SSM_LAYERS} of 64 layers) prefill on "
          f"the mesh: {n['ssd']} ssd calls, logits and state as without it" + lap())
    del sp, sp_mesh, got_c, want_c
    torch.cuda.empty_cache()

    # whisper-medium cut: encoder, prefill and decode on the mesh
    wcfg = dataclasses.replace(get_config(WHISPER_ARCH),
                               n_layers=MESH_WHISPER_LAYERS,
                               encoder_layers=MESH_WHISPER_LAYERS)
    wp = encdec.init_cast(wcfg, torch.Generator(device=dev).manual_seed(0),
                          dev)
    wrules = SH.make_rules(wcfg, mesh)
    wp_mesh = SH.distribute(wp, encdec.param_specs(wcfg), wrules)
    frames = torch.from_numpy(rng.standard_normal(
        (WHISPER_BATCH, WHISPER_FRAMES, wcfg.d_model)).astype(
            np.float32)).to(dev)
    wtok = torch.from_numpy(rng.integers(
        0, wcfg.vocab_size, (WHISPER_BATCH, WHISPER_PROMPT))).to(dev)

    def whisper(on_mesh):
        def run():
            ctx = SH.use_rules(wrules) if on_mesh else contextlib.nullcontext()
            p = wp_mesh if on_mesh else wp

            def put(t):
                return SH.place(t, wrules.sharding_for(
                    ("batch",) + (None,) * (t.dim() - 1), tuple(t.shape))) \
                    if on_mesh else t
            with ctx:
                logits, cache = encdec.prefill(wcfg, p, put(frames),
                                               put(wtok), WHISPER_MAX_LEN)
                steps = [SH.full(logits)]
                for t in range(MESH_DECODE_STEPS):
                    nxt = steps[-1].argmax(-1)[:, None]
                    logits, cache = encdec.decode_step(
                        wcfg, p, cache, put(nxt), WHISPER_PROMPT + t)
                    steps.append(SH.full(logits))
            return steps
        return run
    want, _ = counted(whisper(False), False)
    got, n = counted(whisper(True), True)
    for t, (g, w) in enumerate(zip(got, want)):
        same(f"{wcfg.name} cut step {t}", g, w)
    print(f"[mesh] {wcfg.name} ({MESH_WHISPER_LAYERS} + "
          f"{MESH_WHISPER_LAYERS} layers) on the mesh: encoder over "
          f"{WHISPER_FRAMES} frames, prefill and {MESH_DECODE_STEPS} decode "
          f"steps as without it ({n['sfu_layernorm']} sfu_layernorm, "
          f"{n['flash_attention']} flash_attention)" + lap())
    del wp, wp_mesh, frames
    torch.cuda.empty_cache()

    # training: qwen3-4b's training cut, with and without the mesh
    tcfg = dataclasses.replace(get_config(TRAIN_ARCH),
                               n_layers=MESH_TRAIN_LAYERS)
    work = Path(tempfile.mkdtemp(prefix="mesh_ckpt_", dir=Path.cwd()))

    def trainer(on_mesh):
        return Trainer(
            tcfg, ShapeSpec("chip", TRAIN_SEQ, TRAIN_BATCH, "train"),
            opt=OptConfig(peak_lr=TRAIN_PEAK_LR, warmup_steps=TRAIN_WARMUP,
                          total_steps=MESH_TRAIN_STEPS),
            options=TrainOptions(steps=MESH_TRAIN_STEPS,
                                 ckpt_every=MESH_TRAIN_STEPS,
                                 ckpt_dir=str(work / ("mesh" if on_mesh
                                                      else "none")),
                                 log_every=MESH_TRAIN_STEPS),
            seed=0, device=dev, mesh=mesh if on_mesh else None)
    t_none = trainer(False)
    (p0, o0), n0 = counted(lambda: t_none.run(resume=False), False)

    # int8 gradient compression on a few of the meshless state's
    # gradients (MESH_COMPRESS_LEAVES): the card's ef_tree_quantize is
    # decompress(compress(g + 0)) leaf by leaf, and compress on the card
    # gives the CPU's payloads and scales bit for bit
    batch = t_none.data.device_batch(MESH_TRAIN_STEPS, dev)
    named = dict(T.leaves_with_paths(p0))
    for k, p in named.items():
        p.requires_grad_(k in MESH_COMPRESS_LEAVES)
    loss = lm.loss_fn(tcfg, p0, batch["tokens"], batch["labels"])
    grads = dict(zip(MESH_COMPRESS_LEAVES, torch.autograd.grad(
        loss, [named[k] for k in MESH_COMPRESS_LEAVES])))
    for p in named.values():
        p.requires_grad_(False)
    del named, loss, batch
    ghat, new_err = compression.ef_tree_quantize(
        grads, compression.ef_tree_init(grads))
    for k, g in grads.items():
        q, sc = compression.compress(g)
        require(torch.equal(ghat[k], compression.decompress(q, sc, g.dtype))
                and torch.equal(new_err[k],
                                g.float() - compression.decompress(q, sc)),
                f"ef_tree_quantize on the card is not decompress(compress) "
                f"at {k}")
        cq, cs = compression.compress(g.cpu())
        require(torch.equal(q.cpu(), cq) and torch.equal(sc.cpu(), cs),
                f"compress on the card differs from the CPU's at {k}")
    del ghat, new_err
    g0 = grads[MESH_COMPRESS_LEAVES[0]]
    mean, _ = compression.compressed_psum(
        g0, mesh.get_group("data"), torch.zeros_like(g0, dtype=torch.float32))
    q, sc, _ = compression.ef_quantize(g0, torch.zeros_like(
        g0, dtype=torch.float32))
    require(torch.equal(mean, compression.decompress(q, sc, g0.dtype)),
            "compressed_psum over the world of one differs")
    print(f"[mesh] int8 error-feedback compression of step "
          f"{MESH_TRAIN_STEPS}'s gradients of {', '.join(grads)}: "
          f"ef_tree_quantize on the card is decompress(compress) of each, "
          f"and compress's payloads and scales are the CPU's bit for bit; "
          f"compressed_psum (one fp32 all-reduce) over the world of one is "
          f"decompress(ef_quantize(g))" + lap())
    # the meshless state is in its checkpoint: the card is freed for the
    # mesh's run
    del grads, g0, mean, q, sc, p0, o0
    torch.cuda.empty_cache()

    t_mesh = trainer(True)
    torch.cuda.reset_peak_memory_stats()
    (p1, o1), n1 = counted(lambda: t_mesh.run(resume=False), True)
    l0 = [m["loss"] for m in t_none.metrics_log]
    l1 = [m["loss"] for m in t_mesh.metrics_log]
    require(l1 == l0, f"losses on the mesh {l1} vs without {l0}")
    require(n1 == n0 and n1["rmsnorm_bwd"] > 0
            and n1["flash_attention_bwd"] > 0,
            f"training launches on the mesh {n1} vs without {n0}")
    print(f"[mesh] {tcfg.name} ({MESH_TRAIN_LAYERS} of 36 layers) Trainer on "
          f"the mesh, {MESH_TRAIN_STEPS} steps of {TRAIN_BATCH}x{TRAIN_SEQ}: "
          f"losses {l1} as without it; launches {n1}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB" + lap())

    # the two step checkpoints hold the same bytes: every leaf's key,
    # shape, dtype and crc32 in their manifests agree
    def manifest(name):
        with open(work / name / f"step_{MESH_TRAIN_STEPS:08d}"
                  / "manifest.json") as f:
            return json.load(f)
    m_mesh, m_none = manifest("mesh"), manifest("none")
    for key in ("step", "keys", "shapes", "dtypes", "crc32", "extra"):
        require(m_mesh[key] == m_none[key],
                f"the mesh's and no mesh's checkpoints differ in {key}")
    # no mesh's checkpoint onto the mesh (the rules' placements), against
    # the mesh's own state
    p_sh, o_sh = t_mesh.step_fn.in_shardings[:2]
    state1 = {"params": p1, "opt": o1}
    onto_mesh, _ = ckpt.restore(str(work / "none"), MESH_TRAIN_STEPS,
                                state1, verify=False,
                                shardings={"params": p_sh, "opt": o_sh})
    def whole(t):
        return t.full_tensor() if isinstance(t, SH.DTensor) else t
    for (k, a), b in zip(T.leaves_with_paths(onto_mesh), T.leaves(state1)):
        require(isinstance(a, SH.DTensor) == isinstance(b, SH.DTensor)
                and a.dtype == b.dtype and torch.equal(whole(a), whole(b)),
                f"the meshless checkpoint restored onto the mesh differs at "
                f"{k}: {type(a).__name__} {a.dtype} "
                f"{getattr(a, 'placements', None)} against "
                f"{type(b).__name__} {b.dtype} "
                f"{getattr(b, 'placements', None)}")
    print(f"[mesh] checkpoints: the mesh's step {MESH_TRAIN_STEPS} and no "
          f"mesh's hold the same bytes ({len(m_mesh['keys'])} leaves' "
          f"crc32, shapes and dtypes), and no mesh's restores onto the "
          f"mesh bit for bit" + lap())
    del onto_mesh, p1, o1, state1
    import shutil
    shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    secs = time.perf_counter() - t_phase
    print(f"[mesh] phase: {secs:.1f} s on {smi}")


def counted_run(fn, counters, launches, zero_counts):
    """``fn()`` with the kernels' counts from 0: (its result, the counts,
    its host seconds, the card synchronized); the counts join
    ``launches``, the main paths' counts."""
    import torch
    zero_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = {k: f.launches for k, f in counters.items()}
    for k, n in got.items():
        launches[k] += n
    return out, got, secs


def examples_phase(counters, launches, zero_counts, smi) -> None:
    """The examples of ``examples_torch/`` on the card, each through its
    ``run`` with the counts from 0 (see ``EX_*``); their launches are
    added to ``launches``."""
    import tempfile

    import numpy as np
    import torch

    from examples_torch import (grad_compression, quickstart, serve_batch,
                                train_lm)
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    dev = torch.device("cuda")

    def counted(fn):
        return counted_run(fn, counters, launches, zero_counts)

    # quickstart: BERT-S through the DORA kernels
    qs, ran, secs = counted(lambda: quickstart.run(quickstart.parse_args([]),
                                                   device=dev))
    res, graph = qs["result"], qs["graph"]
    want = binary_launches(res)
    print(f"[examples] quickstart: {graph.name}, stage-2 MILP optimal="
          f"{res.optimal}, makespan {res.makespan_s * 1e3:.3f} ms, "
          f"{len(res.codegen.program)} instructions; launches {ran} "
          f"[{secs:.1f} s]")
    require(ran == want, f"quickstart launches {ran} differ from the "
            f"binary's instruction counts {want}")
    rels = {}
    for layer in graph.layers:
        got, ref_out = qs["outputs"][layer.name], qs["reference"][layer.name]
        require(bool(np.isfinite(got).all()) and got.shape == ref_out.shape,
                f"quickstart {layer.name}: {got.shape} or non-finite")
        rels[layer.name] = float(np.linalg.norm(got - ref_out) / max(
            np.linalg.norm(ref_out), 1e-30))
    worst = max(rels, key=rels.get)
    print(f"[examples] quickstart vs reference_execute: last layer rel L2 "
          f"{qs['rel_l2']:.4g}, max abs err {qs['max_abs_err']:.4g}; worst "
          f"chained layer {worst} {rels[worst]:.4g} (limit {CHAIN_RTOL})")
    require(max(rels.values()) <= CHAIN_RTOL,
            f"quickstart chained rel L2 errors {rels}")

    # serve_batch at its defaults, its weights from seed 0
    args = serve_batch.parse_args([])
    cfg = get_config(args.arch, reduced=True)
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    per_step, per_prefill, why = path_launches(cfg)
    want = dict.fromkeys(counters, 0) | {
        k: args.gen * n for k, n in per_step.items()} | per_prefill
    sv, ran, secs = counted(lambda: serve_batch.run(args, device=dev,
                                                    params=params))
    print(f"[examples] serve_batch: {cfg.name}, {args.batch} requests of "
          f"{[len(r.prompt) for r in sv['requests']]} prompt tokens, "
          f"{args.gen} new; prefill {sv['prefill_s'] * 1e3:.2f} ms, decode "
          f"{sv['decode_tok_per_s']:.1f} tok/s (host clock around "
          f"synchronize, one call) on {smi}; launches {ran}, expected "
          f"{args.gen} steps {why} [{secs:.1f} s]")
    require(ran == want, f"serve_batch launches {ran} differ from {want}")
    reqs, outs = sv["requests"], sv["outputs"]
    require(all(len(outs[r.id]) == args.gen and all(
        0 <= t < cfg.vocab_size for t in outs[r.id]) for r in reqs),
        f"serve_batch outputs malformed: {outs}")
    # the served tokens teacher-forced through the kernels (the greedy
    # rows' argmax must give them again) and the plain versions
    plen = max(len(r.prompt) for r in reqs)
    padded = np.zeros((len(reqs), plen), np.int64)
    for i, r in enumerate(reqs):
        padded[i, plen - len(r.prompt):] = r.prompt
    tokens = torch.from_numpy(padded).to(dev)
    served = torch.tensor([outs[r.id] for r in reqs], device=dev)
    greedy = [i for i, r in enumerate(reqs) if r.temperature == 0]
    cast, caches, rel = lm.cast_params(cfg, params), {}, []
    with torch.no_grad():
        for t in range(args.gen):
            logits = {}
            for plain in (False, True):
                if t == 0:
                    logits[plain], caches[plain] = lm.prefill(
                        cfg, cast, tokens, max_len=128, plain=plain)
                else:
                    logits[plain], caches[plain] = lm.decode_step(
                        cfg, cast, caches[plain], served[:, t - 1:t],
                        plen + t - 1, plain=plain)
            rel.append(rel_l2(logits[False], logits[True]))
            require(torch.equal(logits[False].argmax(-1)[greedy],
                                served[greedy, t]),
                    f"serve_batch step {t}: the kernels' greedy tokens "
                    f"differ from the served ones")
    print(f"[examples] serve_batch greedy requests {greedy}: the served "
          f"tokens teacher-forced through the kernels give them again; "
          f"logits vs the plain versions rel L2 max {max(rel):.4g} (limit "
          f"{SERVE_RTOL})")
    require(max(rel) <= SERVE_RTOL, f"serve_batch logits rel L2 {rel}")
    del params, cast, caches, logits

    # train_lm's 100m preset with a fault near the middle
    cfg, shape = train_lm.preset_config("100m")
    per_step, why = train_launches(cfg)
    resume = EX_TRAIN_FAIL_AT // train_lm.CKPT_EVERY * train_lm.CKPT_EVERY
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory() as tmp:
        args = train_lm.parse_args(
            ["--preset", "100m", "--steps", str(EX_TRAIN_STEPS), "--fail-at",
             str(EX_TRAIN_FAIL_AT), "--ckpt-dir", tmp])
        tr, ran, secs = counted(lambda: train_lm.run(args, device=dev))
    peak = torch.cuda.max_memory_allocated()
    metrics, losses = tr["metrics"], tr["losses"]
    steps = [m["step"] for m in metrics]
    want = dict.fromkeys(counters, 0) | {
        k: len(metrics) * n for k, n in per_step.items()}
    print(f"[examples] train_lm --preset 100m: {cfg.name} "
          f"({cfg.param_count() / 1e6:.1f} M parameters, d {cfg.d_model}, "
          f"{cfg.n_layers} layers, {cfg.compute_dtype} compute, remat "
          f"{cfg.remat}), {shape.global_batch} x {shape.seq_len} tokens a "
          f"step, {EX_TRAIN_STEPS} steps, a fault at step "
          f"{EX_TRAIN_FAIL_AT}, resumed from step {resume}: {len(metrics)} "
          f"steps run; launches {ran}, expected {len(metrics)} x {why} "
          f"[{secs:.1f} s, checkpoints and the restore included]")
    require(ran == want, f"train_lm launches {ran} differ from {want}")
    require(tr["failures"] == 1 and steps == list(range(EX_TRAIN_FAIL_AT))
            + list(range(resume, EX_TRAIN_STEPS)),
            f"train_lm: {tr['failures']} failures, steps {steps}")
    first = {}
    for m in metrics:
        first.setdefault(m["step"], m["loss"])
    replay = max(abs(m["loss"] - first[m["step"]]) / abs(first[m["step"]])
                 for m in metrics)
    tail = float(np.mean(losses[-EX_TRAIN_TAIL:]))
    dts = sorted(m["dt"] for m in metrics[EX_TRAIN_WARM:])
    step_ms = 1e3 * dts[len(dts) // 2]
    print(f"[examples] train_lm 100m: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, mean of the last {EX_TRAIN_TAIL} {tail:.4f} "
          f"< first; replayed steps' losses within {replay:.3g} relative of "
          f"their first run (limit {FAULT_RTOL}); step host ms past the "
          f"first {EX_TRAIN_WARM}: median {step_ms:.2f}, least "
          f"{1e3 * dts[0]:.2f}, most {1e3 * dts[-1]:.2f}; "
          f"{shape.global_batch * shape.seq_len / (step_ms / 1e3):,.0f} "
          f"tokens/s at the median (the example's mean "
          f"{tr['mean_tok_per_s']:,.0f}); {len(tr['straggler_steps'])} "
          f"straggler steps; peak {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated, {base / 2**30:.2f} held before) on {smi}")
    require(all(np.isfinite(losses)) and tail < losses[0]
            and replay <= FAULT_RTOL,
            f"train_lm 100m: losses {losses}, replay {replay}")

    # grad_compression over the card's NCCL world
    gc, ran, secs = counted(lambda: grad_compression.run(
        grad_compression.parse_args([]), device=dev))
    world = gc["world"]
    require(world == torch.cuda.device_count(), f"grad_compression world "
            f"{world} of {torch.cuda.device_count()} cards")
    X, y = grad_compression.problem(world)
    xs, ys = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)
    w = torch.zeros(grad_compression.D, device=dev)
    for _ in range(grad_compression.STEPS):
        w = w - grad_compression.LR * grad_compression.local_grad(w, xs, ys)
    paths = gc["paths"]
    fp32 = torch.tensor(paths["fp32 all-reduce"]["w"], device=dev)
    err = float((fp32 - w).abs().max())
    print(f"[examples] grad_compression over a NCCL world of {world}: "
          + "; ".join(f"{name} final mse {r['mse']:.4g}, all-reduced bytes "
                      f"a step {r['wire_bytes']:.0f}" for name, r in
                      paths.items())
          + f"; fp32 path vs full-batch descent max |dw| {err:.3g} (limit "
          f"{EX_GD_TOL} x max|w| = {EX_GD_TOL * float(w.abs().max()):.3g})"
          f" [{secs:.1f} s]")
    require(err <= EX_GD_TOL * float(w.abs().max()) and all(
        r["wire_bytes"] == 4 * grad_compression.D and np.isfinite(r["mse"])
        for r in paths.values()), f"grad_compression: {paths}")
    print(f"[examples] phase: {time.perf_counter() - t_phase:.1f} s on {smi}")


def long_phase(counters, launches, zero_counts, smi) -> None:
    """The reference's assigned sequence lengths on the card (see
    ``LONG_*``), a cell at a time, batches cut to fit: the kernels alone at
    the cells' shapes; L1 qwen3-4b's prefill_32k and decode_32k, L4-L7
    the other dense archs', L8 whisper-medium's; L2 mamba2-2.7b's
    long_500k; L3 train_4k (qwen3-4b's cut, mamba2-2.7b, whisper-medium,
    qwen2-vl-2b); the kernels alone at the MoE archs' and mamba2-2.7b's
    32k shapes, L9-L11 the MoE cuts' prefill_32k and decode_32k
    (``LONG_MOE_CUTS``) and L12 mamba2-2.7b's.  The main paths'
    launches, each counted from 0, are added to ``launches``."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, enc_len
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import (decode_plan,
                                                     flash_attention)
    from repro_torch.kernels.sfu import layernorm_rows, rmsnorm_rows
    from repro_torch.kernels.ssd import ssd
    from repro_torch.launch.serve import BatchServer, Request
    from repro_torch.launch.train import TrainOptions, Trainer
    from repro_torch.models import encdec, lm
    from repro_torch.optim import OptConfig

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    GiB = 2 ** 30
    sms = _build.sm_count(dev)
    fp32_peak, bf16_peak, bw_peak = peaks(torch.cuda.get_device_name(0))
    batch32 = (f"prefill_32k + decode_32k, batch {LONG_BATCH} of "
               f"{SHAPES['prefill_32k'].global_batch} / "
               f"{SHAPES['decode_32k'].global_batch}")
    note32 = f"{batch32}, full depth"

    def fresh() -> int:
        """Returns the cache to the card and restarts the peak; the bytes
        still allocated."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    def counted(fn):
        return counted_run(fn, counters, launches, zero_counts)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    def server_for(cfg, max_len, prompts, note):
        """A ``BatchServer`` of ``cfg`` drawn from seed 0, its load peak
        held as the serving phase holds it; then ``prompts`` served with
        LONG_NEW new tokens, counted: the launches must be ``path_
        launches``'.  (The server, the served tokens (B, LONG_NEW).)"""
        before = fresh()
        t0 = time.perf_counter()
        server = BatchServer(cfg, max_len=max_len, seed=0, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        cast_bytes, item_bytes, held_bytes = load_bytes(cfg)
        limit = min(cast_bytes + item_bytes, held_bytes) + GiB
        print(f"[long] {cfg.name} [{note}]: drawn and cast in {load_s:.2f} "
              f"s, load peak {peak / GiB:.3f} GiB (limit {limit / GiB:.3f}: "
              f"the lesser of the cast parameters + the largest fp32 item "
              f"and one fp32 item held at a time, + 1 GiB)")
        require(peak <= limit, f"{cfg.name}: load peak {peak} over {limit}")
        # warm-up: cuBLAS's plans, the allocator
        server.serve([Request(0, prompts[0][:64], 2)])
        per_step, per_prefill, why = path_launches(cfg)
        want = dict.fromkeys(counters, 0) | {
            k: LONG_NEW * n for k, n in per_step.items()} | per_prefill
        base = fresh()
        stats, ran, secs = counted(lambda: server.serve(
            [Request(i, p, LONG_NEW) for i, p in enumerate(prompts)]))
        peak = torch.cuda.max_memory_allocated()
        outs = stats["outputs"]
        print(f"[long] {cfg.name} [{note}]: {len(prompts)} x "
              f"{len(prompts[0])} prompt tokens, {LONG_NEW} new: prefill "
              f"{stats['prefill_s']:.4f} s, decode "
              f"{stats['decode_tok_per_s']:.2f} tok/s ({len(prompts)} x "
              f"{LONG_NEW - 1} tokens; host clock around synchronize), "
              f"{secs:.1f} s in all; peak {peak / GiB:.2f} GiB "
              f"({base / GiB:.2f} held before: the parameters and what "
              f"earlier phases keep); launches "
              f"{ran}, expected {LONG_NEW} steps {why} on {smi}")
        require(ran == want, f"{cfg.name} [{note}]: launches {ran} differ "
                f"from {want}")
        require(sorted(outs) == list(range(len(prompts))) and all(
            len(t) == LONG_NEW and all(0 <= x < cfg.vocab_size for x in t)
            for t in outs.values()), f"served outputs malformed: {outs}")
        return server, torch.tensor([outs[i] for i in range(len(prompts))],
                                    device=dev)

    def forced(server, tokens, served, cfg=None, params=None, plain=False,
               frames=None):
        """``tokens`` prefilled into a cache of the prompt and LONG_NEW
        more rows (an encoder-decoder's after its encoder over
        ``frames``), then a decode step fed each column of ``served`` but
        the last, through ``server``'s weights (or ``cfg`` and
        ``params``) on the kernels or the plain versions: each pass's
        logits, finite and of the right shape.  One cache, freed after."""
        cfg, params = cfg or server.cfg, params or server.params
        model, head = (encdec, (frames,)) if cfg.is_encdec else (lm, ())
        out, cache, plen = [], None, tokens.shape[1]
        with torch.no_grad():
            for t in range(served.shape[1]):
                if t == 0:
                    logits, cache = model.prefill(cfg, params, *head, tokens,
                                                  max_len=plen + LONG_NEW,
                                                  plain=plain)
                else:
                    logits, cache = model.decode_step(
                        cfg, params, cache, served[:, t - 1:t], plen + t - 1,
                        plain=plain)
                require(bool(torch.isfinite(logits).all()) and logits.shape
                        == (tokens.shape[0], cfg.vocab_size),
                        f"{cfg.name} pass {t}: logits "
                        f"{tuple(logits.shape)} or non-finite")
                out.append(logits)
        del cache
        return out

    def timed(name, shape, kernel, plain_ms, library, flops, nbytes, peak):
        return time_row(smi, bw_peak, name, shape, kernel, plain_ms, library,
                        flops, nbytes, peak, iters=LONG_TIME_ITERS)

    def prefill_alone(label, B, Hq, Hkv, S, D, causal, dt) -> None:
        """flash_attention's prefill (B, Hq, S, D) over (B, Hkv, S) in
        ``dt`` against the chunked plain version the model's plain path
        takes at this length, within LONG_ATTN_RTOL by relative L2 (over
        thousands of keys an output is of order 1/sqrt(keys) of v, so an
        absolute tolerance would not see a fault); each timed once by
        CUDA events, and bf16 by ``cuda_ms`` beside SDPA and its bound."""
        fresh()
        name = str(dt)[6:]
        tol = LONG_ATTN_RTOL[name]
        q = randn(B, Hq, S, D, dtype=dt)
        k, v = (randn(B, Hkv, S, D, dtype=dt) for _ in range(2))
        got, kernel_ms = event_ms(torch, lambda: flash_attention(
            q, k, v, causal=causal))
        want, plain_ms = event_ms(torch, lambda: ref.mha_attention_chunked(
            q, k, v, causal=causal))
        rel, scale = rel_l2(got, want), float(want.float().abs().max())
        del got, want
        shape = (f"{label} prefill ({B}, {Hq}, {S}, {D}) over ({B}, {Hkv}, "
                 f"{S}) {'causal' if causal else 'non-causal'} {name}")
        print(f"[long] flash_attention {shape} against "
              f"ref.mha_attention_chunked: rel L2 {rel:.3g} (limit {tol}; "
              f"max |out| {scale:.3g}); one call's device ms: kernel "
              f"{kernel_ms:.2f}, plain {plain_ms:.2f}")
        require(rel <= tol, f"flash_attention {shape}: rel L2 {rel} over "
                f"{tol}")
        if dt == torch.bfloat16:
            pairs = causal_pairs(S, S) if causal else S * S
            timed("flash_attention", shape, lambda: flash_attention(
                q, k, v, causal=causal), plain_ms, sdpa_call(q, k, v, causal),
                4 * D * B * Hq * pairs, 2 * (2 * q.numel() + 2 * k.numel()),
                bf16_peak)
        del q, k, v

    def decode_alone(label, B, Hq, Hkv, cache, rows, D, dt) -> None:
        """flash_attention's decode of one query row a head over the first
        r of ``cache`` KV rows, for each r of ``rows``, against
        ``ref.mha_attention`` within LONG_ATTN_RTOL by relative L2; over
        the last of ``rows`` without its plan's first split it must sit
        outside that bound (the plan's splits and their combine carry the
        whole); bf16 timed at the last beside SDPA and its bound."""
        fresh()
        name = str(dt)[6:]
        tol = LONG_ATTN_RTOL[name]
        q = randn(B, Hq, 1, D, dtype=dt)
        k, v = (randn(B, Hkv, cache, D, dtype=dt) for _ in range(2))
        rel = {}
        for r in rows:
            want, plain_ms = event_ms(torch, lambda: ref.mha_attention(
                q, k, v, causal=False, kv_len=r))
            rel[r] = rel_l2(flash_attention(q, k, v, causal=False, kv_len=r),
                            want)
        r = rows[-1]
        plan = decode_plan(r, B * Hkv, sms)
        kd, vd, left = drop_first_split(q, k, v, r, sms)
        dropped = rel_l2(flash_attention(q, kd, vd, causal=False,
                                         kv_len=left), want)
        del kd, vd, want
        shape = (f"{label} decode ({B}, {Hq}, 1, {D}) over {r} of ({B}, "
                 f"{Hkv}, {cache}) rows {name} ({plan.splits} splits of "
                 f"{plan.rows_per_split})")
        print(f"[long] flash_attention {shape} against ref.mha_attention: "
              f"rel L2 " + ", ".join(f"over {n} rows {e:.3g}"
                                     for n, e in rel.items())
              + f" (limit {tol}); planted, without its first split: "
              f"{dropped:.3g} (must exceed {tol})")
        require(max(rel.values()) <= tol, f"flash_attention {shape}: rel L2 "
                f"{rel} over {tol}")
        require(dropped > tol, f"flash_attention {shape}: a dropped split "
                f"sits {dropped} from the whole, within {tol}")
        if dt == torch.bfloat16:
            timed("flash_attention", shape, lambda: flash_attention(
                q, k, v, causal=False, kv_len=r), plain_ms,
                sdpa_call(q, k[:, :, :r], v[:, :, :r], False),
                4 * D * B * Hq * r, 2 * (2 * q.numel() + 2 * B * Hkv * r * D),
                bf16_peak)
        del q, k, v

    def norm_alone(kind, R, N, dt, label) -> None:
        """``rmsnorm`` (+gamma) or ``sfu_layernorm`` (+gamma +beta) on (R, N)
        rows of ``dt`` against the plain version, as the card's norm checks
        hold it (fp32 rtol 1e-4 / atol 1e-5, bf16 one ulp), the same bits on
        a repeated call; bf16 timed beside F.rms_norm / F.layer_norm and
        its bound."""
        fresh()
        x = randn(R, N, dtype=dt, scale=2.0)
        g, bt = randn(N), randn(N)
        if kind == "rmsnorm":
            fn, plain, args, flops = rmsnorm_rows, ref.rmsnorm_rows, (g,), 4
            gl = g.to(dt)
            library = lambda: F.rms_norm(x, (N,), gl, 1e-6)  # noqa: E731
        else:
            fn, plain, args, flops = layernorm_rows, ref.layernorm_rows, \
                (g, bt), 7
            gb = ln_affine(x, g, bt)
            library = lambda: F.layer_norm(x, (N,), *gb, 1e-5)  # noqa: E731
        got, again = fn(x, *args), fn(x, *args)
        want, plain_ms = event_ms(torch, lambda: plain(x, *args))
        rtol, atol = (1e-4, 1e-5) if dt == torch.float32 else (2 ** -7, 1e-6)
        err, same = max_err(got, want), torch.equal(got, again)
        ok = got.dtype == dt and same and close(got, want, rtol, atol)
        shape = (f"{R}x{N} {str(dt)[6:]} +gamma"
                 f"{' +beta' if kind == 'sfu_layernorm' else ''} ({label})")
        del got, again, want
        print(f"[long] {kind} {shape}: max err {err:.3g} against the plain "
              f"version (rtol {rtol:.3g}, atol {atol}), a repeated call "
              f"{'equal' if same else 'different'}")
        require(ok, f"{kind} {shape}: max err {err}, repeat equal {same}")
        if dt == torch.bfloat16:
            timed(kind, shape, lambda: fn(x, *args), plain_ms, library,
                  flops * x.numel(),
                  2 * x.numel() * x.element_size() + 4 * len(args) * N,
                  fp32_peak)
        del x

    def kernels_alone() -> None:
        # flash_attention alone at L1's and L4-L8's shapes (a prefill of
        # LONG_BATCH prompts, a decode over the cache's rows past the
        # prompt), then the norms on the rows of those prefills
        qcfg, wcfg = get_config(SERVE_ARCH), get_config(WHISPER_ARCH)
        icfg, q15 = get_config("internlm2-20b"), get_config("qwen1.5-4b")
        B, S, M = LONG_BATCH, LONG_PROMPT, LONG_MAX_LEN
        for dt in (torch.bfloat16, torch.float32):
            for cfg, causal in ((qcfg, True), (wcfg, False), (icfg, True),
                                (q15, True)):
                prefill_alone(cfg.name + (" encoder and cross" if not causal
                                          else ""), B, cfg.n_heads,
                              cfg.n_kv_heads, S, cfg.head_dim, causal, dt)
            for cfg in (qcfg, q15):
                decode_alone(cfg.name, B, cfg.n_heads, cfg.n_kv_heads, M,
                             (S + 1, M), cfg.head_dim, dt)
            decode_alone(f"{wcfg.name} cross", B, wcfg.n_heads,
                         wcfg.n_kv_heads, S, (S,), wcfg.head_dim, dt)
            for kind, arch in (("sfu_layernorm", "nemotron-4-15b"),
                               ("sfu_layernorm", WHISPER_ARCH),
                               ("rmsnorm", "internlm2-20b"),
                               ("rmsnorm", MROPE_ARCH)):
                norm_alone(kind, B * S, get_config(arch).d_model, dt, arch)

    def long_prompts(cfg) -> list:
        return [np.random.default_rng(i).integers(
            0, cfg.vocab_size, LONG_PROMPT).astype(np.int32)
            for i in range(LONG_BATCH)]

    def kv_cache_bytes(cfg, rows: int) -> int:
        """Bytes of the self-attention k and v caches of LONG_BATCH rows
        in bf16."""
        attn = sum(cfg.pattern[i % cfg.pattern_len].mixer == "attn"
                   for i in range(cfg.n_layers))
        return (2 * attn * LONG_BATCH * cfg.n_kv_heads * cfg.kv_cache_repeat
                * rows * cfg.head_dim * 2)

    def shallow(label, cut, params, tokens, served, frames=None) -> None:
        """``cut`` on ``params`` (the served weights' first layers)
        teacher-forced on the served tokens: bf16, the kernels against the
        plain versions within SERVE_RTOL at every pass; fp32 compute on the
        same weights, the prefill and LONG_FP32_STEPS decode steps, the
        kernels against the plain versions within FP32_DECODE_TOL x
        max|logit| at every pass."""
        def run(c, plain, steps):
            fresh()
            return forced(None, tokens, served[:, :steps], cfg=c,
                          params=params, plain=plain, frames=frames)

        bf16 = [rel_l2(k, p) for k, p in zip(run(cut, False, LONG_NEW),
                                            run(cut, True, LONG_NEW))]
        c32 = dataclasses.replace(cut, compute_dtype="float32")
        steps = LONG_FP32_STEPS + 1
        fp32 = [max_err(k, p) / float(p.abs().max()) for k, p in zip(
            run(c32, False, steps), run(c32, True, steps))]
        depth = (f"{cut.encoder_layers} + {cut.n_layers}" if cut.is_encdec
                 else f"{cut.n_layers}")
        print(f"[long] {label} cut to its first {depth} layers, teacher-"
              f"forced on the served tokens, kernels vs plain versions: bf16 "
              f"logits rel L2 prefill {bf16[0]:.4g}, decode max "
              f"{max(bf16[1:]):.4g} (step {int(np.argmax(bf16[1:])) + 1}; "
              f"limit {SERVE_RTOL}); fp32 compute on the same weights, "
              f"prefill + {LONG_FP32_STEPS} decode steps: max |err| / "
              f"max|logit| prefill {fp32[0]:.3g}, decode max "
              f"{max(fp32[1:]):.3g} (limit {FP32_DECODE_TOL})")
        require(max(bf16) <= SERVE_RTOL, f"{label} cut to {depth} layers: "
                f"bf16 logits rel L2 {bf16}")
        require(max(fp32) <= FP32_DECODE_TOL, f"{label} cut to {depth} "
                f"layers: fp32 max |err| / max|logit| {fp32}")

    scfg = get_config(SSM_ARCH)
    S = LONG_SSM_PROMPT
    require(S == SHAPES["long_500k"].seq_len, f"{S} is not long_500k's")
    H, P = scfg.ssm_heads, scfg.ssm_head_dim
    G, N = scfg.ssm_groups, scfg.ssm_state

    def serve_dense() -> None:
        # L1: prefill_32k and decode_32k, qwen3-4b at full width and depth
        cfg = get_config(SERVE_ARCH)
        require(LONG_PROMPT == SHAPES["prefill_32k"].seq_len
                == SHAPES["decode_32k"].seq_len
                and LONG_PROMPT >= cfg.attn_chunk_threshold
                and LONG_PROMPT % 1024 == 0,
                f"{LONG_PROMPT} is no prompt of prefill_32k's chunked path")
        note = note32
        prompts = long_prompts(cfg)
        server, served = server_for(cfg, LONG_MAX_LEN, prompts, note)
        kv_bytes = kv_cache_bytes(cfg, LONG_MAX_LEN)
        tokens = torch.from_numpy(np.stack(prompts).astype(np.int64)).to(dev)
        # teacher-forced on the served tokens: the kernels, the plain versions
        # and fp32 arithmetic on the same bf16 weights through the plain
        # versions, one pass after the other, one cache held at a time
        fp32 = dataclasses.replace(cfg, compute_dtype="float32")
        peaks, logits = {}, {}
        for path, pcfg, plain in (("kernels", cfg, False),
                                  ("plain", cfg, True), ("fp32", fp32, True)):
            base = fresh()
            t0 = time.perf_counter()
            logits[path] = forced(server, tokens, served, cfg=pcfg,
                                  plain=plain)
            peaks[path] = (torch.cuda.max_memory_allocated(),
                           time.perf_counter() - t0)
        for t, got in enumerate(logits["kernels"]):
            require(torch.equal(got.argmax(-1), served[:, t]), f"{cfg.name} "
                    f"step {t}: the kernels' greedy tokens differ from the "
                    f"served ones")
        witness = logits.pop("fp32")

        def near(passes, rows=LONG_BATCH):
            """Each pass's and row's relative L2 from the fp32 witness."""
            return np.array([[rel_l2(o[r], w[r]) for r in range(rows)]
                             for o, w in zip(passes, witness)])

        rel = [rel_l2(k, p)
               for k, p in zip(logits["kernels"], logits["plain"])]
        dist = {path: near(logits[path]) for path in ("kernels", "plain")}
        ratio = dist["kernels"] / dist["plain"]
        print(f"[long] {cfg.name} [{note}]: the KV cache {kv_bytes / GiB:.3f} "
              f"GiB ({LONG_MAX_LEN} rows); teacher-forced on the served "
              f"tokens (the kernels give them again): kernels vs plain "
              f"versions (their attention over 1,024-row query chunks) logits "
              f"rel L2 prefill {rel[0]:.4g}, decode max {max(rel[1:]):.4g}, "
              f"mean {float(np.mean(rel)):.4g}; against fp32 arithmetic on "
              f"the same bf16 weights (the plain versions), mean of "
              f"{ratio.shape[0]} passes x {LONG_BATCH} rows: kernels "
              f"{float(dist['kernels'].mean()):.4g}, plain "
              f"{float(dist['plain'].mean()):.4g}, ratio mean "
              f"{float(ratio.mean()):.4g}, worst {float(ratio.max()):.4g} "
              f"(pass {int(ratio.argmax()) // LONG_BATCH}, limit "
              f"{LONG_FP32_SLACK}); peak GiB, host s: " + ", ".join(
                  f"{path} {pk / GiB:.2f}, {sec:.1f}"
                  for path, (pk, sec) in peaks.items())
              + f" ({base / GiB:.2f} held: the parameters and what earlier "
              f"phases keep) on {smi}")
        require(float(ratio.max()) <= LONG_FP32_SLACK, f"{cfg.name} [{note}]: "
                f"the kernels sit {dist['kernels'].tolist()} from fp32 "
                f"arithmetic, the plain versions {dist['plain'].tolist()}")
        # the bound's power: the kernels with a fault planted, the first row
        for what, size in LONG_FAULTS:
            fresh()
            with planted(what, size, sms):
                got = near(forced(server, tokens[:1], served[:1]), rows=1)
            bad = got[:, 0] / dist["plain"][:, 0]
            over = int((bad > LONG_FP32_SLACK).sum())
            fault = (f"every rmsnorm x (1 + {size})" if what == "rmsnorm"
                     else f"decode's attention without its {size}")
            print(f"[long] {cfg.name} [{note}], planted: {fault}, row 0: "
                  f"the kernels {float(got.mean()):.4g} from fp32 "
                  f"arithmetic (mean of {len(bad)} passes), ratio to the "
                  f"plain versions' mean {float(bad.mean()):.4g}, worst "
                  f"{float(bad.max()):.4g}, {over} passes over "
                  f"{LONG_FP32_SLACK} (at least one must be)")
            require(over > 0, f"{cfg.name}: planted {what} {size} "
                    f"sits within the bound: ratios {bad.tolist()}")
        # the same weights cut to their first LONG_SHALLOW_LAYERS layers,
        # where a rounding has not yet spread through the stack
        n = LONG_SHALLOW_LAYERS
        cut = dataclasses.replace(cfg, n_layers=n)
        cut_params = {**server.params, "layers": server.params["layers"][:n]}
        cut_rel = [rel_l2(k, p) for k, p in zip(
            *(forced(server, tokens, served, cfg=cut, params=cut_params,
                     plain=plain) for plain in (False, True)))]
        print(f"[long] {cfg.name} [{note}] cut to its first {n} layers: "
              f"kernels vs plain versions, teacher-forced, logits rel L2 "
              f"prefill {cut_rel[0]:.4g}, decode max {max(cut_rel[1:]):.4g} "
              f"(limit {SERVE_RTOL})")
        require(max(cut_rel) <= SERVE_RTOL, f"{cfg.name} [{note}] cut to "
                f"{n} layers: logits rel L2 {cut_rel}")

    def serve_archs() -> None:
        # L4-L7: prefill_32k and decode_32k of the other dense archs at full
        # width and depth, one server at a time; then the served weights'
        # first LONG_SHALLOW_LAYERS layers, the rest freed
        for arch in DENSE_ARCHS:
            cfg = get_config(arch)
            server, served = server_for(cfg, LONG_MAX_LEN, long_prompts(cfg),
                                        note32)
            tokens = torch.from_numpy(np.stack(long_prompts(cfg)).astype(
                np.int64)).to(dev)
            print(f"[long] {cfg.name} [{note32}]: the KV cache "
                  f"{kv_cache_bytes(cfg, LONG_MAX_LEN) / GiB:.3f} GiB "
                  f"({LONG_MAX_LEN} rows, heads {cfg.n_heads}/"
                  f"{cfg.n_kv_heads})")
            n = LONG_SHALLOW_LAYERS
            params = {**server.params, "layers": server.params["layers"][:n]}
            del server
            shallow(f"{cfg.name} [{note32}]", dataclasses.replace(
                cfg, n_layers=n), params, tokens, served)
            del params

    def serve_whisper() -> None:
        # L8: whisper-medium's prefill_32k and decode_32k through encdec (no
        # server, as in the reference): its encoder over as many stub
        # frames as the cell's sequence, LONG_BATCH prompts, greedy tokens;
        # then its first LONG_SHALLOW_LAYERS encoder and decoder layers
        cfg = get_config(WHISPER_ARCH)
        frames_n = enc_len(cfg, SHAPES["prefill_32k"])
        require(frames_n == LONG_PROMPT >= cfg.attn_chunk_threshold,
                f"{frames_n} frames: not prefill_32k's chunked path")
        before = fresh()
        t0 = time.perf_counter()
        params = encdec.init_cast(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        cast = sum(t.numel() * t.element_size() for t in T.leaves(params))
        item = 4 * max(cfg.vocab_size * cfg.d_model, *(
            sum(t.numel() for t in T.leaves(lp))
            for lp in params["encoder"] + params["decoder"]))
        print(f"[long] {cfg.name} [{note32}]: drawn and cast in {load_s:.2f}"
              f" s, load peak {peak / GiB:.3f} GiB (limit "
              f"{(cast + item + GiB) / GiB:.3f}: the cast parameters + the "
              f"largest fp32 item + 1 GiB)")
        require(peak <= cast + item + GiB, f"{cfg.name}: load peak {peak} "
                f"over {cast + item + GiB}")
        frames = torch.randn(
            (LONG_BATCH, frames_n, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(0)).to(
                torch.bfloat16)
        tokens = torch.from_numpy(np.stack(long_prompts(cfg)).astype(
            np.int64)).to(dev)

        def decode(cache, first):
            out = [first]
            for t in range(1, LONG_NEW):
                logits, cache = encdec.decode_step(
                    cfg, params, cache, out[-1][:, None], LONG_PROMPT + t - 1)
                out.append(logits.argmax(-1))
            return torch.stack(out, 1)

        # warm-up: cuBLAS's plans, the allocator
        _, cache = encdec.prefill(cfg, params, frames[:, :64], tokens[:, :64],
                                  max_len=65)
        encdec.decode_step(cfg, params, cache, tokens[:, 64:65], 64)
        per_prefill, per_step, why = encdec_launches(cfg)
        want_pre = dict.fromkeys(counters, 0) | per_prefill
        want_dec = dict.fromkeys(counters, 0) | {
            k: (LONG_NEW - 1) * n for k, n in per_step.items()}
        base = fresh()
        (logits, cache), pre, pre_s = counted(lambda: encdec.prefill(
            cfg, params, frames, tokens, max_len=LONG_MAX_LEN))
        served, dec, dec_s = counted(lambda: decode(cache, logits.argmax(-1)))
        cache_bytes = sum(t.numel() * t.element_size()
                          for t in cache.values())
        del cache, logits
        peak = torch.cuda.max_memory_allocated()
        print(f"[long] {cfg.name} [{note32}]: {LONG_BATCH} x {frames_n} stub "
              f"frames and {LONG_BATCH} x {LONG_PROMPT} prompt tokens, "
              f"{LONG_NEW} new: prefill {pre_s:.4f} s (the encoder "
              f"included), decode {LONG_BATCH * (LONG_NEW - 1) / dec_s:.2f} "
              f"tok/s ({LONG_BATCH} x {LONG_NEW - 1} tokens; host clock "
              f"around synchronize); peak {peak / GiB:.2f} GiB "
              f"({base / GiB:.2f} held before); the self and cross caches "
              f"{cache_bytes / GiB:.3f} GiB; launches prefill {pre}, decode "
              f"steps {dec}, expected {why}, {LONG_NEW - 1} decode steps on "
              f"{smi}")
        require(pre == want_pre and dec == want_dec, f"{cfg.name}: launches "
                f"{pre} / {dec} differ from {want_pre} / {want_dec}")
        require(served.shape == (LONG_BATCH, LONG_NEW) and bool(
            ((served >= 0) & (served < cfg.vocab_size)).all()),
            f"{cfg.name}: served tokens malformed")
        n = LONG_SHALLOW_LAYERS
        cut_params = {**params, "encoder": params["encoder"][:n],
                      "decoder": params["decoder"][:n]}
        del params
        shallow(f"{cfg.name} [{note32}]", dataclasses.replace(
            cfg, n_layers=n, encoder_layers=n), cut_params, tokens, served,
            frames)

    def ssd_alone(B, S, H, dt, init, label) -> None:
        """The ssd kernel at (B, S, H, P, G, N) of mamba2-2.7b's head width
        and state in ``dt``, from zero or from a drawn initial state,
        against ``ref.ssd_chained``, y a segment at a time and the final
        state (check_ssd's tolerances); bf16 from zero timed beside its
        bound (no PyTorch call computes the scan)."""
        fresh()
        dts = torch.rand((B, S, H), generator=gen, device=dev)
        a = -torch.linspace(1.0, 16.0, H, device=dev)[None, None] * (
            dts * 0.095 + 0.005)
        del dts
        x = randn(B, S, H, P, dtype=dt)
        b, c = (randn(B, S, G, N, dtype=dt, scale=0.3) for _ in range(2))
        s0 = randn(B, H, P, N) if init else None
        rtol = 1e-4 if dt == torch.float32 else 2 ** -7
        atol = 1e-4
        what = (f"ssd {(B, S, H, P, G, N)} chunk 128 {str(dt)[6:]}, from "
                f"{'an initial state' if init else 'zero'}")
        (y, st), kernel_ms = event_ms(torch, lambda: ssd(
            x, a, b, c, chunk=128, initial_state=s0))
        worst = 0.0
        for s, yw, stw in ref.ssd_chained(
                x, a, b, c, segment=LONG_SSD_SEGMENT, chunk=128,
                initial_state=s0):
            yk = y[:, s:s + LONG_SSD_SEGMENT]
            require(close(yk, yw, rtol, atol), f"{what}: y at {s}: max "
                    f"err {max_err(yk, yw)}")
            worst = max(worst, max_err(yk, yw))
        require(close(st, stw, 1e-4, 1e-4), f"{what}: final state max err "
                f"{max_err(st, stw)}")
        del y
        print(f"[long] {what} ({label}): max "
              f"err y {worst:.3g}, final state {max_err(st, stw):.3g} "
              f"against ref.ssd_chained over {S // LONG_SSD_SEGMENT} "
              f"segments of {LONG_SSD_SEGMENT} (limits rtol {rtol:.3g}, "
              f"atol {atol}; state 1e-4); one call's device ms: kernel "
              f"{kernel_ms:.2f}; peak "
              f"{torch.cuda.max_memory_allocated() / GiB:.2f} GiB")
        if dt == torch.bfloat16 and not init:
            def chained():
                # the plain version alone, each segment dropped after
                for _ in ref.ssd_chained(x, a, b, c, chunk=128,
                                         segment=LONG_SSD_SEGMENT):
                    pass
            _, plain_ms = event_ms(torch, chained)
            timed("ssd", f"{(B, S, H, P, G, N)} chunk 128 bf16 ({label})",
                  lambda: ssd(x, a, b, c, chunk=128),
                  plain_ms, None, *ssd_work(B, S, H, P, G, N, 128, 2),
                  bf16_peak)

    def serve_ssm() -> None:
        # L2: long_500k, mamba2-2.7b at full width and depth; first its ssd
        # kernel alone against the chained plain version
        for dt in (torch.bfloat16, torch.float32):
            for init in (False, True):
                ssd_alone(1, S, H, dt, init,
                          f"long_500k at {scfg.name}'s widths")

        note = (f"long_500k, batch 1 of {SHAPES['long_500k'].global_batch}, "
                f"full depth")
        prompt = np.random.default_rng(0).integers(
            0, scfg.vocab_size, S).astype(np.int32)
        server, served = server_for(scfg, S + LONG_NEW, [prompt], note)
        tokens = torch.from_numpy(prompt.astype(np.int64))[None].to(dev)
        fresh()
        passes = forced(server, tokens, served)
        require(all(torch.equal(got.argmax(-1), served[:, t])
                    for t, got in enumerate(passes)),
                f"{scfg.name}: the kernels' greedy tokens differ from the "
                f"served ones")
        step1 = passes[1]
        del passes
        with torch.no_grad():
            ext, cache = lm.prefill(scfg, server.params,
                                    torch.cat([tokens, served[:, :1]], dim=1))
        del cache
        peak = torch.cuda.max_memory_allocated()
        rel = rel_l2(step1, ext)
        print(f"[long] {scfg.name} [{note}]: teacher-forced on the served "
              f"tokens, every pass's logits finite (the kernels give the "
              f"tokens again); the first decode step at position {S} vs the "
              f"kernels' prefill over the prompt and that token ({S + 1} "
              f"positions, a tail chunk of one): logits rel L2 {rel:.4g} "
              f"(limit {SSM_RTOL}); peak {peak / GiB:.2f} GiB on {smi}")
        require(rel <= SSM_RTOL, f"{scfg.name}: decode after {S} positions "
                f"differs from the prefill by {rel}")

    def train() -> None:
        # L3: train_4k, Trainer on qwen3-4b's training cut, then on
        # mamba2-2.7b, whisper-medium (as many frames as tokens a row) and
        # qwen2-vl-2b whole (phase 6 holds the backward kernels at these
        # shapes)
        cut = dataclasses.replace(get_config(TRAIN_ARCH),
                                  n_layers=TRAIN_LAYERS)
        for arch, tcfg in ((TRAIN_ARCH, cut), (SSM_ARCH, scfg),
                           (WHISPER_ARCH, get_config(WHISPER_ARCH)),
                           (MROPE_ARCH, get_config(MROPE_ARCH))):
            rows = LONG_TRAIN_BATCH[arch]
            shape = dataclasses.replace(SHAPES["train_4k"], global_batch=rows)
            depth = (f"{tcfg.encoder_layers} + {tcfg.n_layers}"
                     if tcfg.is_encdec else
                     f"{tcfg.n_layers} of {get_config(arch).n_layers}")
            note = (f"train_4k, batch {rows} of "
                    f"{SHAPES['train_4k'].global_batch}, {depth} layers")
            per_step, why = train_launches(tcfg)
            want = dict.fromkeys(counters, 0) | {
                k: LONG_TRAIN_STEPS * n for k, n in per_step.items()}
            base = fresh()
            peak_lr = LONG_TRAIN_PEAK_LR.get(arch, TRAIN_PEAK_LR)
            trainer = Trainer(tcfg, shape, opt=OptConfig(
                peak_lr=peak_lr, warmup_steps=TRAIN_WARMUP,
                total_steps=LONG_TRAIN_STEPS), options=TrainOptions(
                    steps=LONG_TRAIN_STEPS, ckpt_every=0,
                    log_every=LONG_TRAIN_STEPS), seed=0, device=dev)
            (params, opt_state), ran, secs = counted(
                lambda: trainer.run(resume=False))
            peak = torch.cuda.max_memory_allocated()
            losses = [m["loss"] for m in trainer.metrics_log]
            dts = sorted(m["dt"] for m in trainer.metrics_log[1:])
            step_ms = 1e3 * dts[len(dts) // 2]
            print(f"[long] {tcfg.name} Trainer [{note}; fp32 parameters, "
                  f"{tcfg.moment_dtype} moments, {tcfg.compute_dtype} "
                  f"compute, remat {tcfg.remat}]: {LONG_TRAIN_STEPS} steps "
                  f"of {rows} x {LONG_TRAIN_SEQ}, AdamW peak lr {peak_lr} "
                  f"after {TRAIN_WARMUP} warm-up steps, losses " + ", ".join(
                      f"{v:.4f}" for v in losses)
                  + f"; step host ms median {step_ms:.2f} (least "
                  f"{1e3 * dts[0]:.2f}), "
                  f"{rows * LONG_TRAIN_SEQ / (step_ms / 1e3):,.0f} tokens/s; "
                  f"peak {peak / GiB:.2f} GiB ({peak / 1e9:.2f} GB; "
                  f"{base / GiB:.2f} held before) [{secs:.1f} s]; launches "
                  f"{ran}, expected {LONG_TRAIN_STEPS} x {why} on {smi}")
            require(ran == want, f"{tcfg.name} [{note}]: launches {ran} "
                    f"differ from {want}")
            require(trainer.failures == 0 and len(losses) == LONG_TRAIN_STEPS
                    and all(np.isfinite(losses))
                    and np.mean(losses[-3:]) < losses[0],
                    f"{tcfg.name} [{note}]: {trainer.failures} failures, "
                    f"losses {losses}")
            require(peak < CARD_TRAIN_GB * 1e9, f"{tcfg.name} [{note}]: peak "
                    f"{peak / 1e9:.2f} GB (limit {CARD_TRAIN_GB} GB)")
            del trainer, params, opt_state

    def moe_kernels_alone() -> None:
        # the kernels alone at L9-L12's shapes that L1-L8's do not cover:
        # llama4-maverick's 40 and jamba-1.5-large's 64 query heads over 8
        # (dbrx-132b's 48 over 8 are internlm2-20b's), the rmsnorm kernel
        # on the prefill's 65,536 rows of llama4's 5,120, jamba's 8,192 and
        # its gated norm's 16,384 (dbrx's layernorm rows of 6,144 are
        # nemotron-4-15b's), ssd at jamba's 256 heads and mamba2-2.7b's 80
        # over 2 x 32,768 positions
        lcfg, jcfg = (get_config(a) for a in ("llama4-maverick-400b-a17b",
                                              "jamba-1.5-large-398b"))
        require((jcfg.ssm_head_dim, jcfg.ssm_groups, jcfg.ssm_state)
                == (P, G, N), f"{jcfg.name}'s SSD heads are not {scfg.name}'s")
        B, S32, M = LONG_BATCH, LONG_PROMPT, LONG_MAX_LEN
        for dt in (torch.bfloat16, torch.float32):
            for cfg in (lcfg, jcfg):
                prefill_alone(cfg.name, B, cfg.n_heads, cfg.n_kv_heads, S32,
                              cfg.head_dim, True, dt)
                decode_alone(cfg.name, B, cfg.n_heads, cfg.n_kv_heads, M,
                             (S32 + 1, M), cfg.head_dim, dt)
            for n, label in ((lcfg.d_model, lcfg.name),
                             (jcfg.d_model, jcfg.name),
                             (jcfg.ssm_expand * jcfg.d_model,
                              f"{jcfg.name}'s gated norm")):
                norm_alone("rmsnorm", B * S32, n, dt, label)
            for cfg in (jcfg, scfg):
                for init in (False, True):
                    ssd_alone(B, S32, cfg.ssm_heads, dt, init,
                              f"prefill_32k, {cfg.name}'s heads")

    def pinned_held(label, rcfg, o, limit) -> None:
        """A teacher-forced run of the kernels with each MoE call pinned to
        the plain path's routes (``o``): its own differing decisions
        printed and its logits within ``limit`` of the plain path's; at
        SERVE_RTOL, but on LONG_ROUTES_VS_FP32's cuts, each decision its
        own router would have made otherwise within ROUTE_MARGIN of a
        tie (there the ROUTE_MARGIN reading is printed; ``routes_near_
        fp32`` holds their routes; on LONG_LOGITS_VS_FP32's the SERVE_RTOL
        reading is printed, ``logits_near_fp32`` holds their logits)."""
        label = f"{label} kernels with each route pinned to the plain path's"
        margins = route_report(f"{label} (their own decisions) vs plain "
                               f"versions", o["routes"])
        logits_report(label, o, limit, tag="long",
                      held=limit != SERVE_RTOL
                      or rcfg.name not in LONG_LOGITS_VS_FP32)
        if limit != SERVE_RTOL:
            return
        worst = max(margins, default=0)
        if rcfg.name in LONG_ROUTES_VS_FP32:
            print(f"[routes] {label}: the largest differing decision's "
                  f"margin {worst:.4g} against ROUTE_MARGIN {ROUTE_MARGIN} "
                  f"(printed: held against fp32 below)")
            return
        require(all(m < ROUTE_MARGIN for m in margins), f"{label}: a route "
                f"differs {worst} from a tie (limit {ROUTE_MARGIN})")
        print(f"[routes] {label}: every differing decision within "
              f"{ROUTE_MARGIN} of a tie over {rcfg.n_layers} layers")

    def logits_near_fp32(label, rcfg, params, tokens, served) -> None:
        """The pinned kernels' teacher-forced logits of ``rcfg`` and
        ``params`` held as near an fp32 witness as the plain versions'
        (``pinned_witness``): each row's mean distance over its passes
        within LONG_FP32_SLACK times the plain versions' (each pass's
        ratio printed); with every norm kernel's output scaled by 1 +
        LONG_ROUTE_FAULT, over that."""
        norm = "layernorm" if rcfg.norm_kind == "layernorm" else "rmsnorm"
        d = pinned_witness(rcfg, params, tokens, served, LONG_MAX_LEN,
                           (norm, LONG_ROUTE_FAULT))
        ratio, bad = (d[path].mean(0) / d["plain"].mean(0)
                      for path in ("kernels", "fault"))
        each = d["kernels"] / d["plain"]
        print(f"[long] {label}, pinned, against fp32 arithmetic on the "
              f"same bf16 weights (the plain versions, pinned alike), mean "
              f"of {each.shape[0]} passes: kernels "
              f"{float(d['kernels'].mean()):.4g}, plain "
              f"{float(d['plain'].mean()):.4g}, ratio "
              f"{float(ratio.max()):.4g} (limit {LONG_FP32_SLACK}; a "
              f"pass's from {float(each.min()):.4g} to "
              f"{float(each.max()):.4g}); planted, every {norm} kernel's "
              f"output x (1 + {LONG_ROUTE_FAULT}): "
              f"{float(d['fault'].mean()):.4g}, ratio "
              f"{float(bad.min()):.4g} (must exceed {LONG_FP32_SLACK}) on "
              f"{smi}")
        require(float(ratio.max()) <= LONG_FP32_SLACK, f"{label}: the "
                f"kernels sit {d['kernels'].tolist()} from fp32 "
                f"arithmetic, the plain versions {d['plain'].tolist()}")
        require(float(bad.min()) > LONG_FP32_SLACK, f"{label}: the planted "
                f"{norm} fault sits within the bound: {d['fault'].tolist()}")

    def routes_near_fp32(label, rcfg, params, tokens) -> None:
        """The prefill's MoE decisions of ``rcfg`` and ``params`` on the
        kernels, pinned to the plain path's routes, held no farther from
        an fp32 evaluation than the plain versions' (``routes_vs_fp32``,
        ``hold_fp32_routes``); then with every norm kernel's output
        scaled by 1 + LONG_ROUTE_FAULT (the plain and fp32 runs as they
        were), outside those bounds."""
        vs32, pin, f32 = routes_vs_fp32(rcfg, params, tokens, pinned=True,
                                        max_len=LONG_MAX_LEN)
        hold_fp32_routes(f"{label}, prefill", vs32)
        norm = "layernorm" if rcfg.norm_kind == "layernorm" else "rmsnorm"
        with torch.no_grad(), planted(norm, LONG_ROUTE_FAULT), \
                moe_calls(pin) as faulted:
            lm.prefill(rcfg, params, tokens, max_len=LONG_MAX_LEN)
        near, why = fp32_routes_near(
            {"plain": vs32["plain"], "kernels": route_diffs(faulted, f32)})
        del pin, f32, faulted
        print(f"[routes] {label}, prefill, planted: every {norm} kernel's "
              f"output x (1 + {LONG_ROUTE_FAULT}): the kernels against "
              f"fp32 beside the plain versions: {why} (must fall outside)")
        require(not near, f"{label}: the planted {norm} fault sits within "
                f"the fp32 route bounds: {why}")

    def serve_moe() -> None:
        # L9-L11: prefill_32k and decode_32k of the MoE archs at full width,
        # cut (LONG_MOE_CUTS), held as the serving phase holds MOE_CUTS, a
        # teacher-forced pass LONG_MOE_ROWS rows at a time
        for arch, cut in LONG_MOE_CUTS.items():
            serve_moe_arch(arch, cut)

    def serve_moe_arch(arch, cut) -> None:
        """One MoE cut of LONG_MOE_CUTS, served and held."""
        t_arch = time.perf_counter()
        full = get_config(arch)
        cfg = dataclasses.replace(full, **cut,
                                  pattern=full.pattern[:cut["n_layers"]])
        why = "cut: " + ", ".join(f"{k} {v} of {getattr(full, k)}"
                                  for k, v in cut.items())
        note = f"{batch32}, {why}"
        prompts = long_prompts(cfg)
        server, served = server_for(cfg, LONG_MAX_LEN, prompts, note)
        tokens = torch.from_numpy(np.stack(prompts).astype(
            np.int64)).to(dev)
        label = f"{cfg.name} [{note}]"
        groups = LONG_BATCH * LONG_PROMPT // 1024
        cap = math.ceil(1024 * cfg.top_k / cfg.n_experts
                        * cfg.capacity_factor)
        print(f"[long] {label}: the KV cache "
              f"{kv_cache_bytes(cfg, LONG_MAX_LEN) / GiB:.3f} GiB "
              f"({LONG_MAX_LEN} rows, heads {cfg.n_heads}/"
              f"{cfg.n_kv_heads}); a MoE layer's prefill routes "
              f"{groups} groups of 1,024 tokens, top-{cfg.top_k} of "
              f"{cfg.n_experts} experts, cap {cap}: "
              f"{groups * cap * cfg.n_experts:,} slots")
        rows = LONG_MOE_ROWS[arch]
        blocks = [slice(r, r + rows) for r in range(0, LONG_BATCH, rows)]

        def part(sl) -> str:
            return "" if rows == LONG_BATCH else f", row {sl.start}"
        m = MOE_SHALLOW_LAYERS
        # the served batch teacher-forced through the kernels gives the
        # served tokens again (one row alone takes other product shapes,
        # and so other roundings)
        fresh()
        passes = forced(server, tokens, served)
        require(all(torch.equal(got.argmax(-1), served[:, t])
                    for t, got in enumerate(passes)),
                f"{label}: the kernels' greedy tokens differ from the "
                f"served ones")
        del passes
        # the whole cut, teacher-forced on the served tokens: the kernels
        # (their own routes), the kernels pinned to the plain path's
        for sl in blocks:
            fresh()
            t0 = time.perf_counter()
            o = teacher_forced(cfg, server.params, tokens[sl], served[sl],
                               ("kernels", "pinned"), LONG_MAX_LEN)
            peak, secs = (torch.cuda.max_memory_allocated(),
                          time.perf_counter() - t0)
            free = o["kernels"]
            route_report(f"{label}{part(sl)} kernels vs plain versions",
                         free["routes"])
            print(f"[long] {label}{part(sl)} kernels vs plain versions, "
                  f"teacher-forced (the served batch through the kernels "
                  f"gives the served tokens again), routes free: logits "
                  f"rel L2 prefill "
                  f"{free['rel'][0]:.4g}, decode max "
                  f"{max(free['rel'][1:]):.4g}; greedy tokens agree on "
                  f"{float(np.mean(free['agree'])):.1%} (held on the "
                  f"pinned runs); the three runs' peak {peak / GiB:.2f} "
                  f"GiB, {secs:.1f} s")
            pinned_held(f"{label}{part(sl)}", cfg, o["pinned"],
                        SERVE_RTOL if cfg.n_layers <= m else MOE_RTOL)
            del o
        # the served weights' first MOE_SHALLOW_LAYERS layers, the rest
        # freed: pinned in bf16, and at fp32 compute
        cfg_s = dataclasses.replace(cfg, n_layers=m,
                                    pattern=cfg.pattern[:m])
        p_s = {**server.params, "layers": server.params["layers"][:m]}
        del server
        shallow_label = f"{label}, cut to its first {m} layers"
        if cfg.n_layers > m:
            for sl in blocks:
                fresh()
                o = teacher_forced(cfg_s, p_s, tokens[sl], served[sl],
                                   ("pinned",), LONG_MAX_LEN)["pinned"]
                pinned_held(f"{shallow_label}{part(sl)}", cfg_s, o,
                            SERVE_RTOL)
                del o
                if cfg.name in LONG_LOGITS_VS_FP32:
                    fresh()
                    logits_near_fp32(f"{shallow_label}{part(sl)}", cfg_s,
                                     p_s, tokens[sl], served[sl])
                if cfg.name in LONG_ROUTES_VS_FP32:
                    fresh()
                    routes_near_fp32(f"{shallow_label}{part(sl)}", cfg_s,
                                     p_s, tokens[sl])
        steps = LONG_FP32_STEPS + 1
        if arch in MOE_FP32_LAYERS:
            c32 = dataclasses.replace(cfg_s, compute_dtype="float32")
            for sl in blocks:
                fresh()
                moe_fp32_check(c32, p_s, tokens[sl], served[sl, :steps],
                               f"{note}; fp32 check: the first {m} "
                               f"layers{part(sl)}", LONG_MAX_LEN,
                               tag="long", free=False)
        else:
            # llama4: its fp32 MoE layer alone (60 GiB) on the MoE
            # inputs of the kernels' prefill and first decode step
            with torch.no_grad():
                with moe_calls() as pre:
                    _, cache = lm.prefill(cfg_s, p_s, tokens,
                                          max_len=LONG_MAX_LEN)
                with moe_calls() as dec:
                    lm.decode_step(cfg_s, p_s, cache, served[:, :1],
                                   LONG_PROMPT)
            d = cfg.d_model
            x_pre = pre[0].xg.reshape(LONG_BATCH, LONG_PROMPT, d)
            xs = [x_pre[r:r + 1].float() for r in range(LONG_BATCH)] \
                + [dec[0].xg.reshape(LONG_BATCH, 1, d).float()]
            del cache, pre, dec, x_pre, p_s
            fresh()
            moe_layer_fp32_check(cfg, f"{note}; the MoE inputs of the "
                                 f"kernels' prefill, a row at a time, "
                                 f"and first decode step", xs,
                                 tag="long")
            del xs
        print(f"[long] {cfg.name} [{note}]: "
              f"{time.perf_counter() - t_arch:.1f} s on {smi}")

    def serve_ssm_32k() -> None:
        # L12: mamba2-2.7b's prefill_32k and decode_32k at full width and
        # depth, held as the serving phase holds it: launches, every pass's
        # logits finite, the first SSM_SHALLOW_LAYERS layers' bf16 prefill
        # and the full depth's at fp32 compute, kernels vs plain versions
        prompts = long_prompts(scfg)
        server, served = server_for(scfg, LONG_MAX_LEN, prompts, note32)
        tokens = torch.from_numpy(np.stack(prompts).astype(np.int64)).to(dev)
        fresh()
        passes = forced(server, tokens, served)
        require(all(torch.equal(got.argmax(-1), served[:, t])
                    for t, got in enumerate(passes)),
                f"{scfg.name}: the kernels' greedy tokens differ from the "
                f"served ones")
        del passes
        n = SSM_SHALLOW_LAYERS
        rel = {}
        for what, c, p in (
                (f"bf16, the served weights' first {n} layers",
                 *cut_to(scfg, server.params, n)),
                ("fp32 compute on the served weights, full depth",
                 dataclasses.replace(scfg, compute_dtype="float32"),
                 server.params)):
            fresh()
            with torch.no_grad():
                k, _ = lm.prefill(c, p, tokens, max_len=LONG_MAX_LEN)
                pl, _ = lm.prefill(c, p, tokens, max_len=LONG_MAX_LEN,
                                   plain=True)
            require(bool(torch.isfinite(k).all()), f"{scfg.name} {what}: "
                    f"non-finite logits")
            rel[what] = (rel_l2(k, pl), torch.cuda.max_memory_allocated())
            del k, pl
        limits = (SSM_SHALLOW_RTOL, SSM_FP32_RTOL)
        print(f"[long] {scfg.name} [{note32}]: teacher-forced on the served "
              f"tokens, every pass's logits finite (the kernels give the "
              f"tokens again); prefill logits kernels vs plain versions rel "
              f"L2: " + "; ".join(
                  f"{what} {e:.4g} (limit {lim}, peak {pk / GiB:.2f} GiB)"
                  for (what, (e, pk)), lim in zip(rel.items(), limits))
              + f" on {smi}")
        require(all(e <= lim for (e, _), lim in zip(rel.values(), limits)),
                f"{scfg.name} [{note32}]: kernels vs plain {rel}")

    for cell in (kernels_alone, serve_dense, serve_archs, serve_whisper,
                 serve_ssm, train, moe_kernels_alone, serve_moe,
                 serve_ssm_32k):
        t_cell = time.perf_counter()
        cell()
        fresh()
        print(f"[long] {cell.__name__}: {time.perf_counter() - t_cell:.1f} s "
              f"on {smi}")
    print(f"[long] phase: {time.perf_counter() - t_phase:.1f} s on {smi}")


def drop_first_split(q, k, v, kv_len: int, sms: int):
    """The operands of a decode over ``kv_len`` rows without the first split
    of its plan on ``sms`` SMs: (k, v, kv_len) past those rows."""
    from repro_torch.kernels.flash_attention import decode_plan
    r = decode_plan(kv_len, q.shape[0] * k.shape[1], sms).rows_per_split
    return (k[:, :, r:].contiguous(), v[:, :, r:].contiguous(),
            kv_len - r)


@contextlib.contextmanager
def planted(what: str, size, sms: int = 0):
    """``kernels.ops``' kernel path with one of LONG_FAULTS while open, or
    the layernorm kernel's output scaled as that fault scales rmsnorm's
    (``sms``: the card's, for the attention fault's plan); the plain
    versions stay as they are.  On a mesh the rmsnorm fault scales each
    rank's output."""
    from repro_torch.kernels import ops
    own = getattr(ops, what)

    def norm(x, *args, plain=False, **kw):
        out = own(x, *args, plain=plain, **kw)
        return out if plain else (out.float() * (1 + size)).to(out.dtype)

    def attention(q, k, v, *, kv_len=None, plain=False, **kw):
        if not plain and kv_len is not None and q.shape[2] == 1:
            k, v, kv_len = drop_first_split(q, k, v, kv_len, sms)
        return own(q, k, v, kv_len=kv_len, plain=plain, **kw)

    setattr(ops, what, {"rmsnorm": norm, "layernorm": norm,
                        "attention": attention}[what])
    try:
        yield
    finally:
        setattr(ops, what, own)


# ---------------------------------------------------------------- four cards

def kernel_counters() -> dict:
    """The kernels' wrappers by name; each counts in ``.launches`` the
    launches of its kernel."""
    from repro_torch.kernels import sfu as sfu_k
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.flex_gemm import flex_gemm
    from repro_torch.kernels.sfu import (act_rows, layernorm_rows,
                                         rmsnorm_rows, softmax_rows)
    from repro_torch.kernels.ssd import ssd, ssd_bwd
    return {"flex_gemm": flex_gemm, "sfu_softmax": softmax_rows,
            "sfu_layernorm": layernorm_rows, "sfu_act": act_rows,
            "rmsnorm": rmsnorm_rows, "flash_attention": flash_attention,
            "ssd": ssd, "rmsnorm_bwd": sfu_k.rmsnorm_bwd,
            "flash_attention_bwd": flash_attention_bwd,
            "layernorm_bwd": sfu_k.layernorm_bwd, "ssd_bwd": ssd_bwd}


def cast_block_bytes(cfg, rules) -> int:
    """Bytes of this rank's blocks of ``cfg``'s parameters in the compute
    dtype, reckoned from their specs under ``rules``."""
    from repro_torch.models import lm
    from repro_torch.parallel import sharding as SH
    aparams, specs = lm.abstract_init(cfg)
    total = []

    def block(t, spec):
        sh = rules.sharding_for(spec, tuple(t.shape))
        total.append(math.prod(b.stop - b.start for b in SH.block_index(
            tuple(t.shape), sh.mesh, sh.placements)) * t.element_size())
    SH.map_specs(block, lm.cast_params(cfg, aparams), specs)
    return sum(total)


def largest_fp32_item(cfg) -> int:
    """Bytes of the largest fp32 item ``lm.init_cast`` draws whole on
    every rank: the embedding, the head, a layer, or in a MoE layer its
    mixer, norms and router, or one expert matrix."""
    from repro_torch import tree as T
    from repro_torch.models import lm
    aparams, _ = lm.abstract_init(cfg)
    items = [aparams["embed"].numel(), aparams["lm_head"].numel()]
    for lp in aparams["layers"]:
        experts = sum(t.numel() for k, t in lp.get("moe", {}).items()
                      if k != "router")
        items.append(sum(t.numel() for t in T.leaves(lp)) - experts)
        if experts:
            items.append(cfg.d_model * cfg.d_ff)
    return 4 * max(items)


def serve_prompts(cfg, dev):
    """The serving phase's prompts (seed 0) and the batch left-padded to
    the longest."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in SERVE_PROMPTS]
    padded = np.zeros((len(prompts), max(SERVE_PROMPTS)), np.int64)
    for i, p in enumerate(prompts):
        padded[i, padded.shape[1] - len(p):] = p
    return prompts, torch.from_numpy(padded).to(dev)


def pass_logits(srv, tokens, served, t: int, cache, cfg=None, params=None,
                plain: bool = False):
    """Pass ``t`` of a teacher-forced run through ``srv`` (on its mesh
    where it has one), or through ``cfg`` and ``params`` under its rules:
    the prefill of ``tokens`` (t = 0) or the decode step fed column t - 1
    of ``served``.  (Its full logits, the cache.)"""
    from repro_torch.models import lm
    cfg, params = cfg or srv.cfg, params or srv.params
    if t == 0:
        return srv._on_mesh(lambda x: lm.prefill(
            cfg, params, x, max_len=SERVE_MAX_LEN, plain=plain), tokens)
    return srv._on_mesh(lambda s, c, q: lm.decode_step(
        cfg, params, c, s, q, plain=plain), served[:, t - 1:t], cache,
        tokens.shape[1] + t - 1)


def forced_logits(srv, tokens, served, steps: int, cfg=None,
                  params=None, plain: bool = False) -> list:
    """The prefill of ``tokens`` and ``steps`` decode steps fed the
    columns of ``served`` through ``srv`` (or ``cfg`` and ``params``
    there), on the kernels or the plain versions: each pass's full
    logits."""
    out, cache = [], None
    for t in range(steps + 1):
        logits, cache = pass_logits(srv, tokens, served, t, cache, cfg,
                                    params, plain)
        out.append(logits)
    return out


def cut_to(cfg, params, n: int):
    """``cfg`` and ``params`` cut to their first ``n`` layers."""
    import dataclasses
    return (dataclasses.replace(cfg, n_layers=n),
            {**params, "layers": params["layers"][:n]})


def depth_logits(srv, tokens, cfg=None, params=None,
                 plain: bool = False) -> dict:
    """The prefill's logits of ``tokens`` through ``srv`` (or ``cfg`` and
    ``params`` there) after the first k layers, for each k of
    CARDS_DEPTHS: where a gap between two runs opens."""
    cfg, params = cfg or srv.cfg, params or srv.params
    return {k: pass_logits(srv, tokens, None, 0, None, *cut_to(cfg, params, k),
                           plain)[0] for k in CARDS_DEPTHS}


@contextlib.contextmanager
def moe_calls(pin=None):
    """Every MoE layer's route while open, in the order of the layers'
    first calls: ``layers.moe_route`` as the layer's ``moe_fwd`` calls it
    (on a mesh each rank's route of its rows, inside the route's
    ``local_map`` region; remat's recompute calls a layer's ``moe_fwd``
    again on the same tokens, and that call is not recorded again).  With
    ``pin``, the plain path's routes of the same pass (on the same mesh),
    each call dispatches its tokens by the pinned choices of its own
    layer instead of its own, gated by its own router probabilities at
    them (renormalised as ``moe_route`` does), on the index path, and
    returns the aux loss of its own router probabilities and the pinned
    choices' kept shares: what differs from the plain path is then the
    kernels' rounding alone, with no expert swapped, and the router's
    gradient flows through the gates and the aux loss as on the plain
    path."""
    from repro_torch.models import layers
    calls, fwd, route, layer_of = [], layers.moe_fwd, layers.moe_route, {}

    def wrapped(mcfg, p, x, *args, **kwargs):
        first = id(p) not in layer_of
        if first:
            layer_of[id(p)] = len(calls)
        fixed = None if pin is None else pin[layer_of[id(p)]]

        def own(*a, **k):
            r = route(*a, **k)
            if first:
                calls.append(r)
            if fixed is None:
                return r
            gate = r.probs.gather(-1, fixed.idx)
            gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
            return r._replace(idx=fixed.idx, gate=gate, pos=fixed.pos)

        layers.moe_route = own
        try:
            return fwd(mcfg, p, x, *args, **(kwargs if fixed is None
                                              else kwargs | {"plain": False}))
        finally:
            layers.moe_route = route

    layers.moe_fwd = wrapped
    try:
        yield calls
    finally:
        layers.moe_fwd = fwd


def route_diffs(kcalls, pcalls, batch: int | None = None):
    """One pass's routing, MoE layer by layer, on a kernels' path
    (``kcalls``) against the plain path (``pcalls``): the decisions
    (expert or kept) that differ at each layer, the decisions a layer,
    the margin of each differing choice (the plain path's gap between
    that choice's router probability and its nearer top-k neighbour),
    the largest margin and the relative L2 difference of the MoE
    input at each layer, and the rows (``batch``; by default one a route
    group) with any difference."""
    import torch
    require(len(kcalls) == len(pcalls), f"{len(kcalls)} MoE calls on "
            f"the kernels' path, {len(pcalls)} on the plain one")
    d = {"per_layer": [], "margins": [], "layer_margin": [], "drift": [],
         "n": 0, "rows": None}
    for kr, pr in zip(kcalls, pcalls):
        B, K = batch or kr.probs.shape[0], kr.idx.shape[-1]
        top = pr.probs.sort(-1, descending=True).values[..., :K + 1]
        gap = top[..., :-1] - top[..., 1:]
        near = torch.minimum(gap, torch.cat([gap[..., :1], gap[..., :-1]],
                                            -1))
        choice = kr.idx != pr.idx
        diff = choice | ((kr.pos < kr.cap) != (pr.pos < pr.cap))
        margins = near[choice].tolist()
        d["margins"] += margins
        d["layer_margin"].append(max(margins, default=0.0))
        d["per_layer"].append(int(diff.sum()))
        d["drift"].append(rel_l2(kr.xg.detach(), pr.xg.detach()))
        d["n"] = diff.numel()
        rows = diff.reshape(B, -1).any(1)
        d["rows"] = rows if d["rows"] is None else d["rows"] | rows
    return d


def route_report(label, passes) -> list[float]:
    """Prints one run's differing decisions: the prefill's by MoE layer
    (with their largest margins and the MoE inputs' drift), the decode
    steps' that have any, the largest margin and the rows whose routes
    all agree; returns every differing choice's margin."""
    pre = passes[0]
    margins = [m for d in passes for m in d["margins"]]
    rows = pre["rows"]
    for d in passes[1:]:
        rows = rows | d["rows"]
    moved = {t: d["per_layer"] for t, d in enumerate(passes)
             if t and any(d["per_layer"])}
    steps = (f"; decode steps 1-{len(passes) - 1} (of {passes[-1]['n']} "
             f"a layer): {moved or 'none'}"
             f"{', every other step none' if moved else ''}"
             if len(passes) > 1 else "")
    print(f"[routes] {label}: prefill, differing decisions by MoE layer "
          f"{pre['per_layer']} of {pre['n']} each (largest margins "
          f"{[float(f'{m:.3g}') for m in pre['layer_margin']]}, MoE "
          f"input rel L2 {[float(f'{x:.3g}') for x in pre['drift']]})"
          f"{steps}; {len(margins)} differing choices, largest margin "
          f"{max(margins, default=0):.4g}; rows whose routes all agree: "
          f"{int((~rows).sum())} of {rows.numel()}")
    return margins


def teacher_forced(cfg, params, tokens, served, paths,
                   max_len: int = SERVE_MAX_LEN):
    """Tokens teacher-forced through the plain versions and through
    each of ``paths``: the prefill of ``tokens`` into caches of
    ``max_len`` rows, then one decode step for each column of ``served``
    but the last, fed that column's tokens.  A path is "kernels", or
    "pinned": the kernels with each MoE call dispatched by the plain
    path's choices of the same call (``moe_calls(pin=)``).  Returns, per
    path, each pass's logits relative L2 and max |err| against the plain
    path's, max|logit| of the plain path's, its greedy tokens, the share
    of them the plain path's agree with, and its ``route_diffs`` (none
    without MoE)."""
    import torch

    from repro_torch.models import lm
    plen = tokens.shape[1]
    caches = {}
    out = {path: {"rel": [], "err": [], "scale": [], "argmax": [],
                  "agree": [], "routes": []} for path in paths}
    for t in range(served.shape[1]):
        logits, calls = {}, {}
        for path in ("plain", *paths):
            with moe_calls(calls["plain"] if path == "pinned" else None
                           ) as calls[path]:
                if t == 0:
                    logits[path], caches[path] = lm.prefill(
                        cfg, params, tokens, max_len=max_len,
                        plain=path == "plain")
                else:
                    logits[path], _ = lm.decode_step(
                        cfg, params, caches[path], served[:, t - 1:t],
                        plen + t - 1, plain=path == "plain")
            require(bool(torch.isfinite(logits[path]).all())
                    and logits[path].shape == (tokens.shape[0],
                                               cfg.vocab_size),
                    f"{path} step {t}: logits "
                    f"{tuple(logits[path].shape)} or non-finite")
        want = logits["plain"]
        for path in paths:
            o = out[path]
            o["rel"].append(rel_l2(logits[path], want))
            o["err"].append(max_err(logits[path], want))
            o["scale"].append(float(want.abs().max()))
            o["argmax"].append(logits[path].argmax(-1))
            o["agree"].append(float((o["argmax"][-1] == want.argmax(-1))
                                    .float().mean()))
            if calls["plain"]:
                o["routes"].append(route_diffs(calls[path], calls["plain"],
                                               tokens.shape[0]))
    caches.clear()
    return out


def logits_report(label, o, rtol, tag="serve", held=True):
    """Prints (as a ``tag`` line) and, if ``held``, holds a teacher-forced
    path's logits: relative L2 to the plain path's <= ``rtol`` at every
    pass."""
    import numpy as np
    rel = o["rel"]
    steps = (f", decode max {max(rel[1:]):.4g} (step "
             f"{int(np.argmax(rel[1:])) + 1}), mean "
             f"{float(np.mean(rel[1:])):.4g}" if len(rel) > 1 else "")
    print(f"[{tag}] {label} vs plain versions, teacher-forced: logits rel "
          f"L2 prefill {rel[0]:.4g}{steps}; greedy tokens agree on "
          f"{float(np.mean(o['agree'])):.1%} ("
          + (f"limit rel L2 {rtol})" if held else
             f"{sum(r > rtol for r in rel)} of {len(rel)} passes over "
             f"{rtol}: printed, held against fp32 below)"))
    require(not held or max(rel) <= rtol, f"{label}: logits differ from "
            f"the plain path: {rel}")


def pinned_witness(cfg, params, tokens, served, max_len: int,
                   fault) -> dict:
    """Tokens teacher-forced as ``teacher_forced`` forces them through
    the plain versions, which choose the routes, through the kernels and
    through fp32 compute on the same weights on the plain versions (the
    witness, sharing no kernel with the kernels' path), these two with
    each MoE call pinned to the plain path's choices of the same call,
    and through the pinned kernels with ``fault`` (``planted``'s what and
    size) planted.  Each pass's and row's relative L2 from the witness,
    by path: arrays (passes, rows)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.models import lm
    runs = {"plain": (cfg, True, None), "kernels": (cfg, False, None),
            "fault": (cfg, False, fault),
            "fp32": (dataclasses.replace(cfg, compute_dtype="float32"),
                     True, None)}
    plen, rows, caches = tokens.shape[1], tokens.shape[0], {}
    dist = {path: [] for path in runs if path != "fp32"}
    with torch.no_grad():
        for t in range(served.shape[1]):
            logits, pin = {}, None
            for path, (c, plain, f) in runs.items():
                with contextlib.ExitStack() as stack:
                    if f is not None:
                        stack.enter_context(planted(*f))
                    calls = stack.enter_context(moe_calls(pin))
                    if t == 0:
                        logits[path], caches[path] = lm.prefill(
                            c, params, tokens, max_len=max_len, plain=plain)
                    else:
                        logits[path], _ = lm.decode_step(
                            c, params, caches[path], served[:, t - 1:t],
                            plen + t - 1, plain=plain)
                if path == "plain":
                    pin = calls
            witness = logits.pop("fp32")
            for path, got in logits.items():
                dist[path].append([rel_l2(got[r], witness[r])
                                   for r in range(rows)])
    caches.clear()
    return {path: np.array(d) for path, d in dist.items()}


def moe_fp32_check(cfg32, params, tokens, served, cut,
                   max_len: int = SERVE_MAX_LEN, tag="serve", free=True):
    """fp32 compute at full width and cut depth: ``tokens``' prefill and
    a decode step fed each column of ``served`` but the last, through
    the kernels with each route pinned to the plain path's, and with
    ``free`` through the kernels on their own routes (printed), against
    the plain versions (the MoE in its one-hot form): the decisions that
    differ (each of the pinned run's within FP32_ROUTE_MARGIN of a tie),
    and the pinned run's logits within FP32_DECODE_TOL x max|logit| at
    every pass."""
    forced = teacher_forced(cfg32, params, tokens, served,
                            ("kernels", "pinned") if free else ("pinned",),
                            max_len)
    label = f"fp32 {cfg32.name} [{cut}]"
    if free:
        route_report(f"{label} kernels vs plain versions",
                     forced["kernels"]["routes"])
    margins = route_report(f"{label} kernels with each route pinned to "
                           f"the plain path's (their own decisions) vs "
                           f"plain versions", forced["pinned"]["routes"])
    o = forced["pinned"]
    err, scale = o["err"][0], o["scale"][0]
    ratios = [e / s for e, s in zip(o["err"], o["scale"])]
    steps = (f"; {len(ratios) - 1} decode steps: max |err| / max|logit| "
             f"{max(ratios[1:]):.3g} (limit {FP32_DECODE_TOL})"
             if len(ratios) > 1 else "")
    print(f"[{tag}] {label} at full width: prefill {tuple(tokens.shape)}, "
          f"kernels with the routes pinned vs plain versions max |err| "
          f"{err:.4g} (limit {FP32_DECODE_TOL} x max|logit| {scale:.4g} = "
          f"{FP32_DECODE_TOL * scale:.4g}), rel L2 {o['rel'][0]:.3g}"
          + (f"; routes free: max |err| {forced['kernels']['err'][0]:.4g}"
             if free else "") + steps)
    require(all(m < FP32_ROUTE_MARGIN for m in margins),
            f"{label}: a route differs {max(margins, default=0)} from a "
            f"tie (limit {FP32_ROUTE_MARGIN})")
    require(max(ratios) <= FP32_DECODE_TOL,
            f"{label}: kernels differ from the plain versions: {ratios}")


def moe_layer_fp32_check(cfg, cut, xs=None, tag="serve"):
    """One MoE layer at full width in fp32, drawn one expert at a time
    (llama4's is 60 GiB, so its fp32 check runs the layer alone):
    ``moe_fwd`` by index against its one-hot plain version on each of
    ``xs`` (B, S, d) in turn, by default N(0, 1) rows of the served
    prefill's shape and a decode step's; y within FP32_DECODE_TOL x
    max|y|, the aux loss equal."""
    import torch

    from repro_torch.models import layers
    dev = torch.device("cuda")
    gen1 = torch.Generator(device=dev).manual_seed(1)
    p = layers.init_moe(cfg, gen1, dev)
    gib = sum(t.numel() for t in p.values()) * 4 / 2**30
    for x in xs or (torch.randn((len(SERVE_PROMPTS), S, cfg.d_model),
                                generator=gen1, device=dev)
                    for S in (max(SERVE_PROMPTS), 1)):
        r = layers.moe_route(cfg, p, x)
        (y, aux), (yp, auxp) = (layers.moe_fwd(cfg, p, x, plain=plain)
                                for plain in (False, True))
        err, scale = max_err(y, yp), float(yp.abs().max())
        print(f"[{tag}] fp32 {cfg.name} [{cut}] MoE layer alone at full "
              f"width ({cfg.n_experts} experts of {cfg.d_model} x "
              f"{cfg.d_ff}, top-{cfg.top_k}, "
              f"{gib:.2f} GiB): "
              f"{tuple(x.shape)}, cap {r.cap}, "
              f"{float((r.pos < r.cap).float().mean()):.1%} of choices "
              f"kept; by index vs one-hot max |err| {err:.4g} (limit "
              f"{FP32_DECODE_TOL} x max|y| {scale:.4g}), aux {float(aux)} "
              f"vs {float(auxp)}")
        require(bool(torch.isfinite(y).all())
                and err <= FP32_DECODE_TOL * scale
                and abs(float(aux) - float(auxp)) <= 1e-6 * float(auxp),
                f"fp32 {cfg.name} MoE layer: index and one-hot differ")
    del p


def routes_vs_fp32(mcfg, params, tokens, pinned, max_len=None):
    """The plain versions' and the kernels' MoE decisions in ``mcfg``'s
    compute dtype, each against an fp32 evaluation of the same weights
    and tokens (``route_diffs``, margins in the fp32 run's router
    probabilities); with ``pinned`` the kernels' and the fp32 run's MoE
    calls dispatch by the plain run's choices of their layer, so that
    every layer decides on the same upstream routes.  Each run is
    ``lm.forward``, or with ``max_len`` ``lm.prefill`` into a cache of
    that many rows (the last position's logits alone: at 32k a forward's
    would take gigabytes).  Returns those two comparisons, the plain
    run's routes and the fp32 run's."""
    import dataclasses

    import torch

    from repro_torch.models import lm

    def run(cfg, plain=False):
        if max_len is None:
            return lm.forward(cfg, params, tokens, plain=plain)
        return lm.prefill(cfg, params, tokens, max_len=max_len, plain=plain)
    calls = {}
    fp32 = dataclasses.replace(mcfg, compute_dtype="float32")
    with torch.no_grad():
        with moe_calls() as calls["plain"]:
            run(mcfg, plain=True)
        pin = calls["plain"] if pinned else None
        with moe_calls(pin) as calls["kernels"]:
            run(mcfg)
        with moe_calls(pin) as calls["fp32"]:
            run(fp32, plain=True)
    return ({who: route_diffs(calls[who], calls["fp32"])
             for who in ("plain", "kernels")}, calls["plain"], calls["fp32"])


def print_routes(label, routes) -> float:
    """Prints a pass's differing MoE decisions by layer, with their
    margins (the reference path's gap to the neighbouring top-k
    probability) and the MoE inputs' drift; returns the largest
    margin."""
    m = routes["margins"]
    worst = max(m, default=0.0)
    print(f"[routes] {label}: differing decisions by MoE layer "
          f"{routes['per_layer']} of {routes['n']} each (largest "
          f"margins {[float(f'{x:.3g}') for x in routes['layer_margin']]}"
          f", MoE input rel L2 "
          f"{[float(f'{x:.3g}') for x in routes['drift']]}); "
          f"{len(m)} differing choices, margins "
          f"{[float(f'{x:.3g}') for x in sorted(m, reverse=True)[:12]]}"
          f"{' ...' if len(m) > 12 else ''}; largest {worst:.4g}")
    return worst


def hold_routes(label, routes, limit) -> None:
    """Prints a pass's differing MoE decisions by layer and holds each
    one's margin below ``limit``."""
    if routes is None:
        return
    worst = print_routes(f"{label} (limit {limit})", routes)
    require(worst < limit, f"{label}: a route differs {worst} from a "
            f"tie (limit {limit})")


def hold_moe_routes(label, mcfg, routes, vs32) -> None:
    """A bf16 pass's routes on the kernels: against the plain versions'
    within ROUTE_MARGIN of a tie (printed only on ROUTES_VS_FP32's
    cuts), and against an fp32 evaluation (``routes_vs_fp32``) no
    farther than the plain versions' are: differing decisions n_k <= n
    + 3 sqrt(2n) for the plain versions' n, the largest margin within
    ROUTE_FP32_SLACK x theirs (at least ROUTE_MARGIN) and each MoE
    layer's input drift within ROUTE_FP32_SLACK x theirs."""
    if mcfg.name in ROUTES_VS_FP32:
        print_routes(f"{label}, against the plain versions (held to the "
                     f"fp32 evaluation below instead: ROUTES_VS_FP32)",
                     routes)
    else:
        hold_routes(label, routes, ROUTE_MARGIN)
    hold_fp32_routes(label, vs32)


def hold_fp32_routes(label, vs32) -> None:
    """Prints the kernels' and the plain versions' MoE decisions against
    an fp32 evaluation (``routes_vs_fp32``) and holds the kernels' no
    farther from it than the plain versions' (``fp32_routes_near``)."""
    print_routes(f"{label}; the kernels against an fp32 evaluation",
                 vs32["kernels"])
    print_routes(f"{label}; the plain versions against an fp32 evaluation",
                 vs32["plain"])
    near, why = fp32_routes_near(vs32)
    print(f"[routes] {label}, the kernels against fp32 as far as the "
          f"plain versions: {why}")
    require(near, f"{label}: the kernels' routes are farther from fp32 "
            f"than the plain versions': {why}")


def fp32_routes_near(vs32) -> tuple[bool, str]:
    """Whether the kernels' MoE decisions (``routes_vs_fp32``) lie no
    farther from an fp32 evaluation than the plain versions' do:
    differing decisions n_k <= n + 3 sqrt(2n) for the plain versions' n,
    the largest margin within ROUTE_FP32_SLACK x theirs (at least
    ROUTE_MARGIN) and each MoE layer's input drift within
    ROUTE_FP32_SLACK x theirs; and those numbers against their limits."""
    kern, plain = vs32["kernels"], vs32["plain"]
    n_k, n_p = sum(kern["per_layer"]), sum(plain["per_layer"])
    n_lim = n_p + 3 * math.sqrt(2 * max(n_p, 1))
    m_k = max(kern["margins"], default=0.0)
    m_lim = max(ROUTE_FP32_SLACK * max(plain["margins"], default=0.0),
                ROUTE_MARGIN)
    drift = [(k, ROUTE_FP32_SLACK * p)
             for k, p in zip(kern["drift"], plain["drift"])]
    return (n_k <= n_lim and m_k <= m_lim
            and all(k <= x for k, x in drift),
            f"{n_k} differing decisions (limit {n_lim:.1f} from the plain "
            f"versions' {n_p}), largest margin {m_k:.4g} (limit "
            f"{m_lim:.4g}), MoE input rel L2 "
            f"{[float(f'{k:.3g}') for k, _ in drift]} (limits "
            f"{[float(f'{x:.3g}') for _, x in drift]})")


class Cards:
    """One rank of the four-card world: its device, the kernels' counts,
    the readings rank 0 keeps, and what rank 0 prints."""

    def __init__(self, rank: int, world: int, dev):
        self.rank, self.world, self.dev = rank, world, dev
        self.counters = kernel_counters()
        self.readings: dict = {}
        self.t_lap = time.perf_counter()
        self.meshes: dict = {}
        self.failed: list[str] = []

    def mesh(self, shape: tuple[int, int]):
        """The (data, model) mesh ``shape`` of the world, made once (each
        of its groups sets up its NCCL communicator once)."""
        from repro_torch.launch.mesh import make_local_mesh
        if shape not in self.meshes:
            self.meshes[shape] = make_local_mesh(shape[1], self.dev)
        require(tuple(self.meshes[shape].shape) == tuple(shape),
                f"mesh {tuple(self.meshes[shape].shape)}, not {shape}")
        return self.meshes[shape]

    def say(self, msg: str) -> None:
        if self.rank == 0:
            print(f"[cards] {msg}", flush=True)

    def hold(self, cond: bool, msg: str) -> None:
        """A bound the rank's result must meet: a miss is printed and
        counted, the phases go on, and the rank fails at their end (so
        one run reads every phase; the world still exits non-zero)."""
        if not cond:
            print(f"[cards] FAILED on rank {self.rank}: {msg}", flush=True)
            self.failed.append(msg)

    def lap(self) -> str:
        now = time.perf_counter()
        dt, self.t_lap = now - self.t_lap, now
        return f" [{dt:.1f} s]"

    def gather(self, obj) -> list:
        import torch.distributed as dist
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier(device_ids=[self.dev.index]
                     if self.dev.type == "cuda" else None)

    def sync(self) -> None:
        import torch
        torch.cuda.synchronize(self.dev)

    def counted(self, fn):
        """``fn()`` with the counts from 0: (its result, the counts)."""
        for f in self.counters.values():
            f.launches = 0
        out = fn()
        self.sync()
        return out, {k: f.launches for k, f in self.counters.items()}

    def hold_launches(self, what: str, got: dict, want: dict) -> None:
        """Each rank's counts of one run are ``want`` (the meshless
        path's; every other kernel 0); rank 0 prints them."""
        want = dict.fromkeys(self.counters, 0) | want
        require(got == want, f"rank {self.rank}: {what}: launches {got}, "
                f"the meshless path's {want}")
        self.gather(None)
        self.say(f"{what}: launches on each of the {self.world} ranks "
                 f"{ {k: n for k, n in want.items() if n} }, the meshless "
                 f"path's")

    def peak_reset(self) -> int:
        import torch
        self.sync()
        torch.cuda.reset_peak_memory_stats(self.dev)
        return torch.cuda.memory_allocated(self.dev)

    def peak(self) -> int:
        import torch
        self.sync()
        return torch.cuda.max_memory_allocated(self.dev)

    def load_server(self, cfg, mesh, label: str):
        """``BatchServer`` of ``cfg`` drawn onto ``mesh`` from seed 0; each
        card's load peak held under its block of the cast parameters plus
        the largest fp32 item plus 1 GiB.  (The server, the peaks.)"""
        from repro_torch.launch.serve import BatchServer
        from repro_torch.parallel.sharding import make_rules
        before = self.peak_reset()
        t0 = time.perf_counter()
        srv = BatchServer(cfg, max_len=SERVE_MAX_LEN, seed=0, device=self.dev,
                          mesh=mesh)
        self.sync()
        secs = time.perf_counter() - t0
        peak = self.peak() - before
        block = cast_block_bytes(cfg, make_rules(cfg, mesh))
        item = largest_fp32_item(cfg)
        self.hold(peak <= block + item + 2**30, f"rank {self.rank}: {label} "
                  f"load peak {peak} B over {block} + {item} + 1 GiB")
        peaks = [p / 2**30 for p in self.gather(peak)]
        self.say(f"{label}: {cfg.param_count() / 1e9:.3f} B parameters "
                 f"drawn onto the mesh in {secs:.2f} s; load peak a card "
                 f"{[round(p, 3) for p in peaks]} GiB, limit "
                 f"{block / 2**30:.3f} GiB block of the cast parameters + "
                 f"{item / 2**30:.3f} GiB largest fp32 item + 1 GiB")
        return srv, peaks

    def serve_counted(self, srv, prompts, label: str) -> dict:
        """The serving traffic through ``srv`` (after a 2-token warm-up),
        its launches held to ``path_launches``; every rank's greedy
        tokens the same.  Returns ``serve``'s stats."""
        from repro_torch.launch.serve import Request

        def requests(n):
            return [Request(i, p, n) for i, p in enumerate(prompts)]
        srv.serve(requests(2))
        stats, got = self.counted(lambda: srv.serve(requests(SERVE_NEW)))
        per_step, per_prefill, why = path_launches(srv.cfg)
        self.hold_launches(f"{label} serving, 1 prefill + {SERVE_NEW - 1} "
                           f"decode steps {why}", got, {
                               k: SERVE_NEW * n for k, n in per_step.items()}
                           | per_prefill)
        outs = self.gather(stats["outputs"])
        require(all(o == outs[0] for o in outs), f"{label}: the ranks' "
                f"greedy tokens differ")
        self.say(f"{label}: prefill {stats['prefill_s']} s, decode "
                 f"{stats['decode_tok_per_s']} tok/s ({len(prompts)} x "
                 f"{SERVE_NEW - 1} tokens, host clock around synchronize); "
                 f"every rank sampled the same tokens")
        return stats


@contextlib.contextmanager
def wo_fault(params, mesh, size: float):
    """While open, every layer's block of ``wo`` on the ranks at the model
    axis's first coordinate scaled by 1 + ``size``: a fault that only a
    mesh that splits ``wo`` over its model axis can have (one rank's share
    of the row-parallel product wrong).  The blocks are restored after."""
    import torch
    from torch.distributed.tensor import Shard
    axis = mesh.mesh_dim_names.index("model")
    mine = mesh.get_local_rank("model") == 0
    saved = []
    with torch.no_grad():
        for layer in params["layers"]:
            w = layer["attn"]["wo"]
            require(isinstance(w.placements[axis], Shard), f"wo is "
                    f"{w.placements} on {tuple(mesh.shape)}, not split over "
                    f"the model axis")
            if mine:
                local = w.to_local()
                saved.append((local, local.clone()))
                local.mul_(1 + size)
    try:
        yield
    finally:
        with torch.no_grad():
            for local, was in saved:
                local.copy_(was)


def cards_serve(c: Cards, work: str) -> None:
    """M4.1: qwen3-4b at full width and depth on each of CARD_MESHES.  Its
    bf16 logits, teacher-forced on the served tokens, every pass and row,
    are held as near fp32 arithmetic on the same bf16 weights (the plain
    versions on one card) as one card's bf16 logits are, within
    LONG_FP32_SLACK times (ROADMAP C.7), and to one card's within
    SERVE_RTOL over the first LONG_SHALLOW_LAYERS layers; each planted
    fault (CARDS_FAULTS: every rmsnorm, and where the model axis splits
    ``wo`` one rank's block of it) must fail the first bound on some pass.
    Where the two bf16 runs part is read by depth."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchServer

    cfg = get_config(SERVE_ARCH)
    prompts, tokens = serve_prompts(cfg, c.dev)
    steps, n = SERVE_NEW - 1, LONG_SHALLOW_LAYERS
    c.readings["serve"] = {}
    for shape in CARD_MESHES:
        mesh = c.mesh(shape)
        label = f"{cfg.name} on {shape}"
        seen = c.readings["serve"][str(shape)] = {}
        srv, peaks = c.load_server(cfg, mesh, label)
        stats = c.serve_counted(srv, prompts, label)
        served = torch.tensor([stats["outputs"][i]
                               for i in range(len(prompts))], device=c.dev)
        got = forced_logits(srv, tokens, served, steps)
        depth = depth_logits(srv, tokens)
        got_cut = forced_logits(srv, tokens, served, steps,
                                *cut_to(cfg, srv.params, n))
        # the bound's power: the mesh's run with each fault planted
        faulty = {}
        rms, wo = CARDS_FAULTS
        with planted("rmsnorm", rms):
            faulty[f"every rmsnorm x (1 + {rms})"] = forced_logits(
                srv, tokens, served, steps)
        if shape[1] > 1:
            with wo_fault(srv.params, mesh, wo):
                faulty[f"every wo's block at model rank 0 x (1 + {wo})"] = \
                    forced_logits(srv, tokens, served, steps)
        del srv
        torch.cuda.empty_cache()

        # fp32 compute, CARDS_FP32_LAYERS layers: the mesh's prefill and
        # decode against one card's (it tells a fault from the bf16
        # roundings the checks after it bound)
        cfg32 = dataclasses.replace(cfg, n_layers=CARDS_FP32_LAYERS,
                                    compute_dtype="float32")
        srv32 = BatchServer(cfg32, max_len=SERVE_MAX_LEN, seed=0,
                            device=c.dev, mesh=mesh)
        got32 = forced_logits(srv32, tokens, served, MESH_DECODE_STEPS)
        del srv32
        c.barrier()
        if c.rank == 0:      # the others wait at the barrier below
            one = BatchServer(cfg32, max_len=SERVE_MAX_LEN, seed=0,
                              device=c.dev)
            want = forced_logits(one, tokens, served, MESH_DECODE_STEPS)
            del one
            worst = max(max_err(g, w) / float(w.abs().max())
                        for g, w in zip(got32, want))
            c.say(f"{label}, fp32 compute, {CARDS_FP32_LAYERS} layers: "
                  f"prefill + {MESH_DECODE_STEPS} decode steps against one "
                  f"card's, max |err| / max|logit| {worst:.3g} (limit "
                  f"{FP32_DECODE_TOL})")
            c.hold(worst <= FP32_DECODE_TOL, f"{label}: fp32 logits "
                   f"{worst} from one card's")
            seen["fp32_err_over_max_logit"] = worst
            # one card in bf16 and the witness: the same bf16 weights in
            # fp32 arithmetic on the plain versions, sharing no code with
            # the kernels
            one = BatchServer(cfg, max_len=SERVE_MAX_LEN, seed=0,
                              device=c.dev)
            want = forced_logits(one, tokens, served, steps)
            want_d = depth_logits(one, tokens)
            want_cut = forced_logits(one, tokens, served, steps,
                                     *cut_to(cfg, one.params, n))
            cfg_x = dataclasses.replace(cfg, compute_dtype="float32")
            p_x = T.tree_map(lambda t: t.float(), one.params)
            exact = forced_logits(one, tokens, served, steps, cfg_x, p_x,
                                  plain=True)
            exact_d = depth_logits(one, tokens, cfg_x, p_x, plain=True)
            del one, p_x
            torch.cuda.empty_cache()

            def near(passes):
                """Each pass's and row's relative L2 from the witness."""
                return np.array([[rel_l2(o[r], w[r]) for r in range(len(o))]
                                 for o, w in zip(passes, exact)])

            base = near(want)
            dist = near(got)
            ratio = dist / base
            c.say(f"{label}, bf16 teacher-forced on the served tokens, "
                  f"against fp32 arithmetic on the same bf16 weights (the "
                  f"plain versions on one card), mean of {ratio.shape[0]} "
                  f"passes x {ratio.shape[1]} rows: the mesh {dist.mean():.4g}"
                  f", one card {base.mean():.4g}; ratio mean "
                  f"{ratio.mean():.4g}, worst {ratio.max():.4g} (pass "
                  f"{int(ratio.argmax()) // ratio.shape[1]}, limit "
                  f"{LONG_FP32_SLACK})")
            c.hold(float(ratio.max()) <= LONG_FP32_SLACK, f"{label}: the "
                   f"mesh sits {dist.tolist()} from fp32 arithmetic, one "
                   f"card {base.tolist()}")
            shallow = [rel_l2(g, w) for g, w in zip(got_cut, want_cut)]
            c.say(f"{label} cut to its first {n} layers, teacher-forced, "
                  f"against the one-card server: logits rel L2 prefill "
                  f"{shallow[0]:.4g}, decode max {max(shallow[1:]):.4g} "
                  f"(limit {SERVE_RTOL})")
            c.hold(max(shallow) <= SERVE_RTOL, f"{label} cut to {n} "
                   f"layers: logits rel L2 {shallow}")
            seen["faults"] = {}
            for fault, passes in faulty.items():
                bad = near(passes) / base
                over = int((bad > LONG_FP32_SLACK).sum())
                c.say(f"{label}, planted: {fault}: ratio to one card's "
                      f"distance from fp32 mean {bad.mean():.4g}, worst "
                      f"{bad.max():.4g}, {over} of {bad.size} passes x rows "
                      f"over {LONG_FP32_SLACK} (at least one must be)")
                c.hold(over > 0, f"{label}: planted {fault} sits within "
                       f"the bound: ratios {bad.tolist()}")
                seen["faults"][fault] = {"ratio_mean": float(bad.mean()),
                                         "ratio_worst": float(bad.max())}
            # read, not held: the mesh against the one-card server, and by
            # depth where the two part
            rel = [rel_l2(g, w) for g, w in zip(got, want)]
            c.say(f"{label} against the one-card server (read, not held): "
                  f"logits rel L2 prefill {rel[0]:.4g}, decode max "
                  f"{max(rel[1:]):.4g}")
            by_depth = {
                "mesh vs one card": {k: rel_l2(depth[k], want_d[k])
                                     for k in CARDS_DEPTHS},
                "mesh vs fp32": {k: rel_l2(depth[k], exact_d[k])
                                 for k in CARDS_DEPTHS},
                "one card vs fp32": {k: rel_l2(want_d[k], exact_d[k])
                                     for k in CARDS_DEPTHS}}
            c.say(f"{label}, the prefill's logits after the first k layers, "
                  f"rel L2 by k: " + "; ".join(
                      f"{who} " + ", ".join(f"{k}: {r:.3g}"
                                            for k, r in d.items())
                      for who, d in by_depth.items()))
            seen |= {"bf16_rel_l2_max": max(rel),
                     "fp32_ratio_mean": float(ratio.mean()),
                     "fp32_ratio_worst": float(ratio.max()),
                     "bf16_vs_fp32": {"mesh": float(dist.mean()),
                                      "one card": float(base.mean())},
                     "shallow_rel_l2_max": max(shallow),
                     "prefill_by_depth": by_depth}
            del want, want_d, want_cut, exact, exact_d
            torch.cuda.empty_cache()
        c.barrier()
        del got, got32, got_cut, depth, faulty
        torch.cuda.empty_cache()
        seen |= {"load_peak_gib": peaks, "prefill_s": stats["prefill_s"],
                 "decode_tok_per_s": stats["decode_tok_per_s"]}
        c.say(f"{label} done" + c.lap())


def cards_moe(c: Cards, work: str) -> None:
    """M4.2: dbrx-132b at full depth on CARDS_MOE_MESH, the experts over
    the model axis."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config

    cfg = get_config(CARDS_MOE_ARCH)
    mesh = c.mesh(CARDS_MOE_MESH)
    label = f"{cfg.name} ({cfg.n_layers} layers) on {CARDS_MOE_MESH}"
    srv, peaks = c.load_server(cfg, mesh, label)
    local = cfg.n_experts // CARDS_MOE_MESH[1]
    for i, lp in enumerate(srv.params["layers"]):
        for k, t in lp.get("moe", {}).items():
            if k != "router":
                require(t.to_local().shape[0] == local, f"rank {c.rank}: "
                        f"layer {i} {k} holds {t.to_local().shape[0]} "
                        f"experts, not {local}")
    c.say(f"{label}: each rank holds {local} of {cfg.n_experts} experts a "
          f"MoE leaf")
    prompts, tokens = serve_prompts(cfg, c.dev)
    stats = c.serve_counted(srv, prompts, label)
    served = torch.tensor([stats["outputs"][i] for i in range(len(prompts))],
                          device=c.dev)
    cuts = {}
    for n, limit in ((MOE_SHALLOW_LAYERS, SERVE_RTOL),
                     (CARDS_MOE_CUT, MOE_RTOL)):
        cut = dataclasses.replace(cfg, n_layers=n)
        params = {**srv.params, "layers": srv.params["layers"][:n]}
        rel, margins, caches = [], [], {}
        for t in range(SERVE_NEW):
            logits, calls = {}, {}
            for path in ("plain", "pinned"):
                with moe_calls(calls.get("plain")) as calls[path]:
                    logits[path], caches[path] = pass_logits(
                        srv, tokens, served, t, caches.get(path), cut,
                        params, plain=path == "plain")
            rel.append(rel_l2(logits["pinned"], logits["plain"]))
            margins += route_diffs(calls["pinned"], calls["plain"])[
                "margins"]
        del caches
        c.say(f"{cfg.name} cut to its first {n} layers on "
              f"{CARDS_MOE_MESH}, teacher-forced, each MoE call pinned to "
              f"the plain path's routes: kernels vs plain logits rel L2 "
              f"prefill {rel[0]:.4g}, decode max {max(rel[1:]):.4g} (limit "
              f"{limit}); {len(margins)} decisions of the kernels' own "
              f"router differ, largest margin {max(margins, default=0):.3g}")
        c.hold(max(rel) <= limit, f"rank {c.rank}: {cfg.name} cut to {n}: "
               f"logits {rel}")
        cuts[n] = {"rel_l2_max": max(rel), "route_diffs": len(margins),
                   "largest_margin": max(margins, default=0.0)}
        if limit == SERVE_RTOL:
            c.hold(all(m < ROUTE_MARGIN for m in margins), f"rank "
                   f"{c.rank}: a route differs {max(margins, default=0)} "
                   f"from a tie")
    del srv, params
    torch.cuda.empty_cache()
    c.readings["moe"] = {"mesh": str(CARDS_MOE_MESH), "load_peak_gib": peaks,
                         "prefill_s": stats["prefill_s"],
                         "decode_tok_per_s": stats["decode_tok_per_s"],
                         "pinned_cuts": cuts}
    c.say(f"{label} done" + c.lap())


def cards_trainer(c: Cards, cfg, mesh, steps: int, ckpt_dir: str,
                  ckpt_every: int = 0, device=None, shape=None):
    """``Trainer`` of ``cfg`` on ``mesh`` (None: one card) from seed 0,
    the training phase's optimizer and 4 x 512-token batches."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.train import TrainOptions, Trainer
    from repro_torch.optim import OptConfig
    return Trainer(
        cfg, shape or ShapeSpec("cards", TRAIN_SEQ, TRAIN_BATCH, "train"),
        opt=OptConfig(peak_lr=TRAIN_PEAK_LR, warmup_steps=TRAIN_WARMUP,
                      total_steps=steps),
        options=TrainOptions(steps=steps, ckpt_every=ckpt_every,
                             ckpt_dir=ckpt_dir, log_every=steps),
        seed=0, device=device or c.dev, mesh=mesh)


def first_step(tr) -> tuple[float, "torch.Tensor"]:
    """Step 0 of ``tr``'s own ``step_fn`` (on its mesh: the gradients laid
    out by the step's hooks, reduced and taken into ZeRO-1's layout) from
    its drawn state on batch 0: (the loss, the step's gradient flattened
    in the tree's order, fp32, whole on every rank).  From zero moments
    the first moment is (1 - b1) times the clipped gradient, so the
    gradient is read back from it and the step's grad_norm."""
    import torch

    from repro_torch import tree as T
    from repro_torch.parallel import sharding as SH
    params, opt_state, _ = tr.init_state()
    _, opt_state, metrics = tr.step_fn(params, opt_state, tr.batch(0))
    del params
    opt = tr.opt_cfg
    scale = min(1.0, opt.grad_clip / (float(metrics["grad_norm"]) + 1e-9))
    flat = torch.cat([(m.full_tensor() if isinstance(m, SH.DTensor) else m)
                      .float().flatten() for m in T.leaves(opt_state["m"])])
    return float(metrics["loss"]), flat.div_((1 - opt.b1) * scale)


def cards_train(c: Cards, work: str) -> None:
    """M4.3: qwen3-4b's training cut on each of CARD_MESHES (reversed),
    against rank 0's one-card loss and gradients, then trained."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config

    tcfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    per_step, why = train_launches(tcfg)
    c.readings["train"] = {}
    for shape in reversed(CARD_MESHES):
        mesh = c.mesh(shape)
        label = f"{tcfg.name} ({TRAIN_LAYERS} of 36 layers) on {shape}"
        tr = cards_trainer(c, tcfg, mesh, TRAIN_STEPS, work)
        loss, flat = first_step(tr)
        c.barrier()
        if c.rank == 0:      # the others wait at the barrier below
            loss1, flat1 = first_step(cards_trainer(c, tcfg, None,
                                                    TRAIN_STEPS, work))
            rel = rel_l2(flat, flat1)
            c.say(f"{label}: the Trainer's step 0, loss {loss:.6f} vs one "
                  f"card's {loss1:.6f} (rel "
                  f"{abs(loss - loss1) / abs(loss1):.3g}, limit "
                  f"{CARDS_LOSS_RTOL}); the whole bf16 gradient read back "
                  f"from the first moments ({flat.numel():,} elements) rel "
                  f"L2 {rel:.4g} (limit {MODEL_BF16_RTOL})")
            c.hold(abs(loss - loss1) <= CARDS_LOSS_RTOL * abs(loss1)
                   and rel <= MODEL_BF16_RTOL, f"{label}: loss {loss} vs "
                   f"{loss1}, gradient rel L2 {rel}")
            c.readings["train"][f"{shape} vs one card"] = {
                "loss_rel": abs(loss - loss1) / abs(loss1), "grad_rel_l2": rel}
            del flat1
        del flat
        torch.cuda.empty_cache()
        c.barrier()
        before = c.peak_reset()
        _, got = c.counted(lambda: tr.run(resume=False))
        c.hold_launches(f"{label} Trainer, {TRAIN_STEPS} steps of "
                        f"{TRAIN_BATCH}x{TRAIN_SEQ} ({why})", got,
                        {k: TRAIN_STEPS * n for k, n in per_step.items()})
        losses = [m["loss"] for m in tr.metrics_log]
        c.hold(np.mean(losses[-3:]) < losses[0], f"rank {c.rank}: {label}: "
               f"losses {losses} do not fall")
        peaks = [p / 2**30 for p in c.gather(c.peak() - before)]
        ms = 1e3 * float(np.median([m["dt"] for m in tr.metrics_log[1:]]))
        c.say(f"{label} Trainer: losses {[round(x, 4) for x in losses]}; "
              f"step ms median after the first {ms:.2f}, "
              f"{TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:,.0f} tokens/s; peak a "
              f"card {[round(p, 2) for p in peaks]} GiB" + c.lap())
        c.readings["train"][str(shape)] = {"losses": losses, "step_ms": ms,
                                           "peak_gib": peaks}
        del tr, mesh
        torch.cuda.empty_cache()


def cards_nemotron(c: Cards, work: str) -> None:
    """M4.4: nemotron-4-15b trained at full width and depth on
    CARDS_TRAIN_MESH (FSDP over data, tensor parallel over model, ZeRO-1
    moments)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config

    cfg = get_config(CARDS_TRAIN_ARCH)
    mesh = c.mesh(CARDS_TRAIN_MESH)
    label = f"{cfg.name} ({cfg.n_layers} layers) on {CARDS_TRAIN_MESH}"
    per_step, why = train_launches(cfg)
    tr = cards_trainer(c, cfg, mesh, TRAIN_STEPS, work)
    before = c.peak_reset()
    _, got = c.counted(lambda: tr.run(resume=False))
    c.hold_launches(f"{label} Trainer, {TRAIN_STEPS} steps of "
                    f"{TRAIN_BATCH}x{TRAIN_SEQ} ({why})", got,
                    {k: TRAIN_STEPS * n for k, n in per_step.items()})
    peak = c.peak() - before
    c.hold(peak < CARD_TRAIN_GB * 1e9, f"rank {c.rank}: {label}: peak "
           f"{peak} B")
    losses = [m["loss"] for m in tr.metrics_log]
    c.hold(np.mean(losses[-3:]) < losses[0], f"rank {c.rank}: {label}: "
           f"losses {losses} do not fall")
    peaks = [p / 1e9 for p in c.gather(peak)]
    ms = 1e3 * float(np.median([m["dt"] for m in tr.metrics_log[1:]]))
    tok_s = TRAIN_BATCH * TRAIN_SEQ / ms * 1e3
    c.say(f"{label} Trainer, {cfg.param_count() / 1e9:.3f} B parameters: "
          f"losses {[round(x, 4) for x in losses]}; step ms median after "
          f"the first {ms:.2f}, {tok_s:,.0f} tokens/s; peak a card "
          f"{[round(p, 2) for p in peaks]} GB (limit {CARD_TRAIN_GB})"
          + c.lap())
    c.readings["nemotron"] = {"mesh": str(CARDS_TRAIN_MESH), "losses": losses,
                              "step_ms": ms, "tokens_per_s": tok_s,
                              "peak_gb": peaks}
    del tr, mesh
    torch.cuda.empty_cache()


def cards_state(c: Cards, work: str) -> None:
    """M4.5: grad_compression over the world (its CPU run is the parent's)
    and a reduced dbrx-132b training state saved from (2, 2), restored
    onto (1, 4) and onto one card bit for bit."""
    import dataclasses

    import torch

    from examples_torch import grad_compression
    from repro_torch import checkpoint as ckpt
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.parallel import sharding as SH

    gc = grad_compression.run(grad_compression.parse_args([]), device=c.dev)
    require(gc["world"] == c.world, f"grad_compression's world "
            f"{gc['world']}")
    c.readings["grad_compression"] = gc
    c.say(f"grad_compression over the NCCL world of {gc['world']}: "
          + "; ".join(f"{k}: mse {v['mse']:.4g}, all-reduced bytes "
                      f"{v['wire_bytes']}" for k, v in gc["paths"].items())
          + c.lap())

    rcfg = get_config(CARDS_MOE_ARCH, reduced=True)
    shape = ShapeSpec("state", 64, 8, "train")
    steps, saved = 2, f"{work}/state"
    tr = cards_trainer(c, rcfg, c.mesh((2, 2)), steps, saved,
                       ckpt_every=steps, shape=shape)
    p, o = tr.run(resume=False)
    want = SH.full({"params": p, "opt": o})
    del p, o
    c.barrier()            # rank 0 has written the checkpoint

    def same(got, where):
        for (k, a), b in zip(T.leaves_with_paths(SH.full(got)),
                             T.leaves(want)):
            require(a.dtype == b.dtype and torch.equal(a, b), f"rank "
                    f"{c.rank}: the state restored {where} differs at {k}")

    t14 = cards_trainer(c, rcfg, c.mesh((1, 4)), steps, saved,
                        shape=shape)
    p, o, _ = t14.init_state()
    got, _ = ckpt.restore(saved, steps, {"params": p, "opt": o},
                          shardings=t14._shardings())
    experts = got["params"]["layers"][0]["moe"]["w_up"].to_local().shape[0]
    require(experts == rcfg.n_experts // 4, f"{experts} experts a rank")
    same(got, "onto (1, 4)")
    del p, o, got, t14
    if c.rank == 0:
        t1 = cards_trainer(c, rcfg, None, steps, saved, shape=shape)
        p, o, _ = t1.init_state()
        got, _ = ckpt.restore(saved, steps, {"params": p, "opt": o})
        same(got, "onto one card")
    c.barrier()
    c.say(f"{rcfg.name} (reduced, {rcfg.n_experts} experts over the model "
          f"axis) trained {steps} steps on (2, 2): its checkpoint restores "
          f"onto (1, 4) ({experts} expert a rank) and onto one card without "
          f"a mesh bit for bit" + c.lap())


CARD_PHASES = (cards_serve, cards_moe, cards_train, cards_nemotron,
               cards_state)


def cards_rank(rank: int, world: int, store: str, out: str, work: str,
               device_type: str = "cuda") -> None:
    """One rank of the four-card mode: joins the world (its card set
    first), waits while rank 0 builds the kernels, runs the phases and,
    on rank 0, writes the readings to ``out``."""
    import torch.distributed as dist

    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import join_world

    import torch

    # fp32 products in full fp32, as in the one-card check
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = join_world(rank, world, store, device_type)
    c = Cards(rank, world, dev)
    if rank == 0:
        t0 = time.perf_counter()
        _build.build()
        c.say(f"rank 0 built {len(_build.SOURCES)} libraries in "
              f"{time.perf_counter() - t0:.2f} s; the other ranks waited")
    c.barrier()
    # a rank that raises exits at once (the parent stops the others), and
    # tears down no communicator the others may still be waiting on
    for phase in CARD_PHASES:
        phase(c, work)
    c.barrier()
    if rank == 0:
        Path(out).write_text(json.dumps(c.readings))
    require(not c.failed, f"rank {rank}: {len(c.failed)} bounds missed: "
            + "; ".join(m[:300] for m in c.failed))
    dist.destroy_process_group()


def wait_world(procs, deadline_s: float) -> None:
    """Waits for every process of a world; the first that fails, or the
    deadline, stops the others and raises."""
    deadline = time.monotonic() + deadline_s
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            require(not bad, f"rank {bad[0][0] if bad else -1} of the world "
                    f"exited with {bad[0][1] if bad else 0}")
            if all(c == 0 for c in codes):
                return
            require(time.monotonic() < deadline, f"the world ran past "
                    f"{deadline_s} s")
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def cards_main(n: int) -> None:
    """The four-card mode: ``n`` ranks, a card each (raises at once where
    the machine has fewer), then grad_compression's gloo run on the CPU
    against the ranks' NCCL run."""
    import torch
    require(torch.cuda.is_available(), "no CUDA device")
    have = torch.cuda.device_count()
    require(have >= n, f"--cards {n} needs {n} CUDA devices; this machine "
            f"has {have}")
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    for i, line in enumerate(smi[:n]):
        print(f"[device] card {i}: {torch.cuda.get_device_name(i)}; "
              f"nvidia-smi: {line}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="cards_") as tmp:
        out = Path(tmp) / "readings.json"
        env = dict(os.environ, PYTHONUNBUFFERED="1")
        wait_world([subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--cards",
             str(n), "--rank", str(r), "--store", f"{tmp}/store", "--out",
             str(out), "--work", tmp],
            env=env) for r in range(n)], CARDS_DEADLINE_S)
        readings = json.loads(out.read_text())
    # grad_compression's gloo world of n on the CPU, against the cards' run
    from examples_torch import grad_compression
    cpu = grad_compression.run(grad_compression.parse_args(
        ["--device", "cpu", "--world", str(n)]), device="cpu")
    card = readings["grad_compression"]
    for name, res in cpu["paths"].items():
        got = card["paths"][name]
        require(got["wire_bytes"] == res["wire_bytes"], f"{name}: "
                f"all-reduced bytes {got['wire_bytes']} on the cards, "
                f"{res['wire_bytes']} on the CPU")
    w = torch.tensor(card["paths"]["fp32 all-reduce"]["w"])
    w_cpu = torch.tensor(cpu["paths"]["fp32 all-reduce"]["w"])
    err = max_err(w, w_cpu) / float(w_cpu.abs().max())
    require(err <= EX_GD_TOL, f"grad_compression's fp32 path on the "
            f"cards {err} x max|w| from its gloo run")
    wire = [r["wire_bytes"] for r in cpu["paths"].values()]
    print(f"[cards] grad_compression: the NCCL world's fp32 weights "
          f"{err:.3g} x max|w| from the gloo world's on the CPU (limit "
          f"{EX_GD_TOL}); all-reduced bytes equal on both paths {wire}")
    for res in card["paths"].values():
        res.pop("w")
    secs = time.perf_counter() - t0
    print(f"[cards] the {n}-card mode took {secs:.1f} s")
    print(json.dumps({"cards": n, "seconds": secs, "readings": readings}))
    for line in smi[:n]:
        print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def cli() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, CARDS),
                    help=f"1: the one-card check; {CARDS}: the four-card "
                         f"mode, a rank a card")
    for flag in ("--rank", "--store", "--out", "--work"):
        ap.add_argument(flag, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank is not None:
        cards_rank(int(args.rank), args.cards, args.store, args.out,
                   args.work)
    elif args.cards == 1:
        main()
    else:
        cards_main(args.cards)


def main() -> None:
    import dataclasses

    import torch
    require(torch.cuda.is_available(), "no CUDA device")
    import numpy as np
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config, paper_models
    from repro_torch.core import (CompileOptions, DoraCompiler, DoraMesh,
                                  DoraMeshCompiler, Epilogue,
                                  MultiTenantWorkload, OpType, UnitKind,
                                  interleave_stream)
    from repro_torch.core.graph import LayerKind, WorkloadGraph
    from repro_torch.core.runtime import EPILOGUE_NAME, SFU_ACT
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import sfu as sfu_k
    from repro_torch import tree as T
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data import for_arch
    from repro_torch.kernels.flash_attention import (attention_lse,
                                                     flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.flex_gemm import flex_gemm, gemm_plan
    from repro_torch.kernels.ref import EPILOGUES
    from repro_torch.kernels.sfu import (act_rows, layernorm_rows,
                                         rmsnorm_rows, softmax_rows)
    from repro_torch.kernels.ssd import ssd, ssd_bwd, ssd_states
    from repro_torch.launch.serve import BatchServer, Request
    from repro_torch.launch.train import TrainOptions, Trainer
    from repro_torch.optim import OptConfig, adamw
    from repro_torch.models import encdec, layers, lm

    # fp32 products in full fp32 for the plain versions and yardsticks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_script = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    fp32_peak, bf16_peak, bw_peak = peaks(kind)

    def mark(phase: str) -> None:
        """Prints where the script's clock stands as ``phase`` begins."""
        print(f"[main] {phase} begins at {time.perf_counter() - t_script:.1f}"
              f" s")

    # ---------------------------------------------------------------- build
    mark("build")
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {len(_build.SOURCES)} libraries in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for lib, names in PTXAS_KERNELS.items():
        usage = _build.ptxas_usage(_build.build_log(lib))
        for name in names:
            found = sorted((fn, u) for fn, u in usage.items()
                           if mangled_is(fn, name))
            require(found, f"no ptxas -v line for {name} in {lib}'s build "
                    f"log")
            for fn, (regs, st, ld) in found:
                print(f"[build] ptxas {kernel_label(fn, name)}: {regs} "
                      f"registers, spill stores {st} B, spill loads {ld} B")

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # ------------------------------------------------------- kernel checks
    mark("kernel checks")
    def check_gemm(M, K, N, dt, epis, accs) -> tuple[float, str]:
        """Max |kernel - plain| over ``epis`` x ``accs``; raises past
        tests/test_kernels.py's tolerance (fp32 2e-5*sqrt(K), bf16 2e-2)."""
        a, b = randn(M, K, dtype=dt), randn(K, N, dtype=dt)
        bias, c = randn(N, dtype=dt), randn(M, N, dtype=dt)
        rtol, atol = (2e-2, 2e-2 * K ** 0.5) if dt == torch.bfloat16 \
            else (2e-5, 2e-5 * K ** 0.5)
        worst = (0.0, "")
        for epi in epis:
            for acc in accs:
                got = flex_gemm(a, b, bias, epilogue=epi, c=c if acc else None)
                want = ref.gemm(a, b, bias, epi, c if acc else None)
                torch.cuda.synchronize()
                require(close(got, want, rtol, atol),
                        f"flex_gemm {M}x{K}x{N} {dt} {epi} acc={acc}: "
                        f"max err {max_err(got, want)}")
                worst = max(worst, (max_err(got, want),
                                    f"{epi}{'+c' if acc else ''}"))
        return worst

    def check_sfu(kernel, R, N, form=None) -> float:
        """Max |kernel - plain| for one SFU kernel; raises past
        tests/test_kernels.py's tolerance."""
        if kernel == "sfu_softmax":
            x = randn(R, N, scale=3.0)
            pairs = [(softmax_rows(x), ref.softmax_rows(x), 1e-5, 1e-6)]
        elif kernel == "sfu_layernorm":
            x, g, bt = randn(R, N), randn(N), randn(N)
            forms = [form] if form else [(None, None), (g, None), (None, bt),
                                         (g, bt)]
            pairs = [(layernorm_rows(x, *f), ref.layernorm_rows(x, *f),
                      1e-4, 1e-5) for f in forms]
        else:
            x = randn(R, N, scale=2.0)
            pairs = [(act_rows(x, act), ref.ACT_FN[act](x), 1e-5, 1e-6)
                     for act in ([form] if form else ref.ACTIVATIONS)]
        torch.cuda.synchronize()
        for got, want, rtol, atol in pairs:
            require(close(got, want, rtol, atol),
                    f"{kernel} {R}x{N}: max err {max_err(got, want)}")
        return max(max_err(got, want) for got, want, _, _ in pairs)

    # the reference's sweeps: every epilogue, accumulator on and off, both
    # dtypes; every affine form and activation
    for M, K, N in GEMM_SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            worst = check_gemm(M, K, N, dt, EPILOGUES, (False, True))
            print(f"[check] flex_gemm {M}x{K}x{N} {str(dt)[6:]} 20 cases: "
                  f"max err {worst[0]:.3g} ({worst[1]})")
    for R, N in SFU_SHAPES:
        print(f"[check] sfu {R}x{N}: " + ", ".join(
            f"{k} {check_sfu(k, R, N):.3g}"
            for k in ("sfu_softmax", "sfu_layernorm", "sfu_act")))

    def offset_view(R, N, offset, dtype=torch.float32, scale=1.0):
        """A contiguous (R, N) view ``offset`` elements into its buffer."""
        return randn(R * N + offset, dtype=dtype, scale=scale)[offset:].view(
            R, N)

    def check_norm(kernel, R, N, dt, offset=0) -> float:
        """Max |kernel - plain| of ``rmsnorm`` (with and without gamma) or
        ``sfu_layernorm`` (with and without gamma and beta), x, gamma and
        beta ``offset`` elements into their buffers; fp32 at
        tests/test_kernels.py's tolerance, bf16 within one bf16 ulp (both
        compute in fp32 and may round to neighbouring values); a repeated
        call gives the same bits."""
        x = offset_view(R, N, offset, dt, scale=2.0)
        g, bt = (offset_view(1, N, offset)[0] for _ in range(2))
        if kernel == "rmsnorm":
            fn, plain, forms = rmsnorm_rows, ref.rmsnorm_rows, [(), (g,)]
        else:
            fn, plain = layernorm_rows, ref.layernorm_rows
            forms = [(None, None), (g, None), (None, bt), (g, bt)]
        rtol, atol = (1e-4, 1e-5) if dt == torch.float32 else (2 ** -7, 1e-6)
        worst = 0.0
        for form in forms:
            got, want, again = fn(x, *form), plain(x, *form), fn(x, *form)
            torch.cuda.synchronize()
            require(got.dtype == dt and close(got, want, rtol, atol)
                    and torch.equal(got, again),
                    f"{kernel} {R}x{N} {dt} offset {offset}: max err "
                    f"{max_err(got, want)}, repeat equal "
                    f"{torch.equal(got, again)}")
            worst = max(worst, max_err(got, want))
        return worst

    def check_softmax_odd(R, N, offset) -> float:
        """Max |kernel - plain| of softmax on a view ``offset`` elements
        into its buffer (rtol 1e-5, atol 1e-6, as check_sfu)."""
        x = offset_view(R, N, offset, scale=3.0)
        got, want, again = softmax_rows(x), ref.softmax_rows(x), \
            softmax_rows(x)
        torch.cuda.synchronize()
        require(close(got, want, 1e-5, 1e-6) and torch.equal(got, again),
                f"sfu_softmax {R}x{N} offset {offset}: max err "
                f"{max_err(got, want)}")
        return max_err(got, want)

    def check_act_odd(R, N, offset) -> float:
        """Max |kernel - plain| of every activation on a view ``offset``
        elements into its buffer (rtol 1e-5, atol 1e-6, as check_sfu)."""
        x = offset_view(R, N, offset, scale=2.0)
        worst = 0.0
        for act in ref.ACTIVATIONS:
            got, want, again = act_rows(x, act), ref.ACT_FN[act](x), \
                act_rows(x, act)
            torch.cuda.synchronize()
            require(close(got, want, 1e-5, 1e-6) and torch.equal(got, again),
                    f"sfu_act {act} {R}x{N} offset {offset}: max err "
                    f"{max_err(got, want)}")
            worst = max(worst, max_err(got, want))
        return worst

    def check_attention(B, Hq, Hkv, Sq, Skv, D, causal, dt, cache=None
                        ) -> float:
        """Max |kernel - plain|; tests/test_kernels.py's tolerances (fp32
        1e-4 / 2e-5, bf16 3e-2).  ``cache`` rows: decode reads the first
        Skv rows of a longer cache, the rest NaN."""
        rows = cache or Skv
        q = randn(B, Hq, Sq, D, dtype=dt)
        k, v = randn(B, Hkv, rows, D, dtype=dt), randn(B, Hkv, rows, D, dtype=dt)
        k[:, :, Skv:] = float("nan")
        v[:, :, Skv:] = float("nan")
        got = flash_attention(q, k, v, causal=causal, kv_len=Skv)
        want = ref.mha_attention(q, k, v, causal=causal, kv_len=Skv)
        torch.cuda.synchronize()
        rtol, atol = (1e-4, 2e-5) if dt == torch.float32 else (3e-2, 3e-2)
        require(close(got, want, rtol, atol),
                f"flash_attention {(B, Hq, Hkv, Sq, Skv, D)} causal={causal} "
                f"{dt}: max err {max_err(got, want)}")
        return max_err(got, want)

    def ssd_inputs(B, S, H, P, G, N, dt):
        """x ~ N(0, 1), b and c ~ N(0, 0.3²) in ``dt``; a in fp32 as
        mamba2 makes it, -exp(A_log) dt with A_log's 1..16 over the heads
        and dt in [0.005, 0.1]: the last heads decay by up to e^-1.6 a
        step, so exp(acs) underflows within a chunk of 128."""
        dts = torch.rand((B, S, H), generator=gen, device=dev) * 0.095 + 0.005
        a = -torch.linspace(1.0, 16.0, H, device=dev)[None, None] * dts
        return (randn(B, S, H, P, dtype=dt), a,
                randn(B, S, G, N, dtype=dt, scale=0.3),
                randn(B, S, G, N, dtype=dt, scale=0.3))

    def check_ssd(B, S, H, P, G, N, chunk, dt) -> float:
        """Max |kernel - plain| over y and the final state, from zero and
        from an initial state, against ``ref.ssd_plain`` (the chunked
        algorithm when S is a multiple of the chunk and longer, else the
        recurrence).  y: fp32 to 1e-4 (reordered fp32 sums; the reference
        holds its kernel to 5e-5 at unit-scale inputs), bf16 to that plus
        one bf16 ulp (the plain version computes in fp32 and rounds once;
        the kernel's tensor-core products take each fp32 operand as a
        bf16 high and low part, about fp32 sums, and round y once); the
        fp32 state to 1e-4."""
        x, a, b, c = ssd_inputs(B, S, H, P, G, N, dt)
        rtol, atol = (1e-4, 1e-4) if dt == torch.float32 else (2 ** -7, 1e-4)
        worst = 0.0
        for init in (None, randn(B, H, P, N)):
            (y, st), (yw, stw) = (
                ssd(x, a, b, c, chunk=chunk, initial_state=init),
                ref.ssd_plain(x, a, b, c, chunk=chunk, initial_state=init))
            torch.cuda.synchronize()
            require(y.dtype == dt and close(y, yw, rtol, atol)
                    and close(st, stw, 1e-4, 1e-4),
                    f"ssd {(B, S, H, P, G, N)} chunk {chunk} {dt} init="
                    f"{init is not None}: max err y {max_err(y, yw)}, state "
                    f"{max_err(st, stw)}")
            worst = max(worst, max_err(y, yw), max_err(st, stw))
        return worst

    for R, N in SFU_SHAPES:
        print(f"[check] rmsnorm {R}x{N} fp32: max err "
              f"{check_norm("rmsnorm", R, N, torch.float32):.3g}")
    for shape in ATTN_SHAPES:
        print(f"[check] flash_attention {shape} fp32: max err causal "
              f"{check_attention(*shape, True, torch.float32):.3g}, "
              f"full {check_attention(*shape, False, torch.float32):.3g}")
    print(f"[check] flash_attention (1, 4, 2, 32, 64, 64) bf16 causal: max "
          f"err {check_attention(1, 4, 2, 32, 64, 64, True, torch.bfloat16):.3g}")
    for *shape, chunk in SSD_SHAPES + SSD_WIDE:
        for dt in (torch.float32, torch.bfloat16):
            print(f"[check] ssd {tuple(shape)} chunk {chunk} "
                  f"{str(dt)[6:]}, from zero and from an initial state: max "
                  f"err (y, state) {check_ssd(*shape, chunk, dt):.3g}")

    # every shape the main path gives each kernel, as its binaries give it
    # (fp32, the instruction's epilogue and accumulate flag); these errors
    # go into the kernels' JSON record
    programs = {name: DoraCompiler().compile(paper_models.get(name),
                                             CompileOptions(engine="list"))
                for name in MAIN_MODELS}

    def workload(scenario):
        mt = MultiTenantWorkload(scenario)
        for name, cut in MT_SCENARIOS[scenario].items():
            mt.add_tenant(name, paper_models.get(name) if cut is None else
                          paper_models.from_arch(name, seq=cut[0],
                                                 blocks=cut[1]))
        return mt

    def tenants(label, res) -> str:
        """The run's tenants, each with its layers and, for a ``from_arch``
        tenant, its cut beside the config's full depth and widths."""
        cuts = MT_SCENARIOS[label.split("/")[0]]
        out = []
        for t in res.workload.tenants:
            note = f"{len(t.graph.layers)} layers"
            if cuts[t.name] is not None:
                tcfg = get_config(t.name)
                note += (f"; from_arch seq {cuts[t.name][0]}, cut to "
                         f"{cuts[t.name][1]} of "
                         f"{tcfg.n_layers + tcfg.encoder_layers} blocks at "
                         f"d {tcfg.d_model}, d_ff {tcfg.d_ff}")
            out.append(f"{t.name} ({note})")
        return ", ".join(out)

    # the multi-tenant runs: label -> (CompileResult, compile seconds); the
    # interleaved streams are the joint small_pair result with its codegen
    # reordered, each mesh PE's result is that PE's own compile
    mt_runs = {}
    for scenario in MT_JOINT:
        t0 = time.perf_counter()
        mt_runs[scenario] = (DoraCompiler().compile(
            workload(scenario), CompileOptions(engine="list")),
            time.perf_counter() - t0)
    joint, _ = mt_runs["small_pair"]
    for policy in ("rr", "priority"):
        t0 = time.perf_counter()
        cg = interleave_stream(joint.codegen, policy=policy,
                               priorities=MT_PRIORITIES)
        require(cg is not joint.codegen, f"{policy}: interleave left the "
                f"stream as it was")
        mt_runs[f"small_pair/{policy}"] = (
            dataclasses.replace(joint, codegen=cg),
            time.perf_counter() - t0)
    t0 = time.perf_counter()
    mesh = DoraMeshCompiler(DoraMesh.homogeneous(2)).compile(
        workload("small_trio"), CompileOptions(engine="list"))
    mesh_s = time.perf_counter() - t0
    require(sorted(mesh.pe_results) == [0, 1], f"small_trio placed on PEs "
            f"{sorted(mesh.pe_results)}, not on both")
    for pe, res in sorted(mesh.pe_results.items()):
        mt_runs[f"small_trio/pe{pe}"] = (res, mesh_s)
    instrs = [i for res in (*programs.values(),
                            *(r for r, _ in mt_runs.values()))
              for i in res.codegen.program.instructions]
    errs = {k: 0.0 for k in REPLACES}
    for M, K, N, acc, epi in sorted(
            {(b.bound_i, b.bound_k, b.bound_j, b.accumulate,
              EPILOGUE_NAME[Epilogue(b.epilogue)])
             for i in instrs if i.op_type == OpType.MMU_GEMM
             for b in [i.body] if b.ping_op == 1}):
        worst = check_gemm(M, K, N, torch.float32, (epi,), (bool(acc),))
        errs["flex_gemm"] = max(errs["flex_gemm"], worst[0])
        print(f"[check] main-path tile flex_gemm {M}x{K}x{N} fp32 {worst[1]}: "
              f"max err {worst[0]:.3g}")
    for op, R, N in sorted({(i.op_type, i.body.count, i.body.ele_num)
                            for i in instrs if i.unit_kind == UnitKind.SFU}):
        kernel = ("sfu_softmax" if op == OpType.SFU_SOFTMAX else
                  "sfu_layernorm" if op == OpType.SFU_LAYERNORM else "sfu_act")
        form = (None, None) if op == OpType.SFU_LAYERNORM else SFU_ACT.get(op)
        e = check_sfu(kernel, R, N, form)
        errs[kernel] = max(errs[kernel], e)
        print(f"[check] main-path {op.name} {R}x{N}: max err {e:.3g}")
    # every shape the serving paths give the serving kernels (bf16); ssd at
    # mamba2-2.7b's prefill was checked above
    for R, N in RMS_SERVING + RMS_SSM + RMS_WIDE + RMS_VL + RMS_MOE:
        errs["rmsnorm"] = max(errs["rmsnorm"],
                              check_norm("rmsnorm", R, N, torch.bfloat16))
        print(f"[check] serving rmsnorm {R}x{N} bf16: max err so far "
              f"{errs['rmsnorm']:.3g}")
    # jamba's fp32 check (2 layers): its gated norm over 16,384 fp32 rows
    # (the block kernel) and its norms at 8192
    for R, N in RMS_MOE:
        e = check_norm("rmsnorm", R, N, torch.float32)
        errs["rmsnorm"] = max(errs["rmsnorm"], e)
        print(f"[check] rmsnorm {R}x{N} fp32 (jamba's fp32 check): max err "
              f"{e:.3g}")
    for R, N in RMS_WIDE:
        e = check_sfu("sfu_layernorm", R, N, (randn(N), randn(N)))
        errs["sfu_layernorm"] = max(errs["sfu_layernorm"], e)
        print(f"[check] serving layernorm {R}x{N} fp32 +gamma +beta "
              f"(nemotron-4-15b's 4-layer fp32 check): max err {e:.3g}")
        e = check_norm("sfu_layernorm", R, N, torch.bfloat16)
        errs["sfu_layernorm"] = max(errs["sfu_layernorm"], e)
        print(f"[check] serving layernorm {R}x{N} bf16, +-gamma +-beta "
              f"(nemotron-4-15b as served): max err {e:.3g}")
    for kernel, odd in (("rmsnorm", RMS_ODD), ("sfu_layernorm", LN_ODD)):
        for R, N, offset in odd:
            for dt in (torch.float32, torch.bfloat16):
                e = check_norm(kernel, R, N, dt, offset)
                errs[kernel] = max(errs[kernel], e)
                print(f"[check] {kernel} {R}x{N} {str(dt)[6:]} offset "
                      f"{offset}: max err {e:.3g}")
    for R, N, offset in SM_ODD:
        e = check_softmax_odd(R, N, offset)
        errs["sfu_softmax"] = max(errs["sfu_softmax"], e)
        print(f"[check] sfu_softmax {R}x{N} offset {offset} (scalar loads "
              f"or the block kernel): max err {e:.3g}")
    for R, N, offset in ACT_ODD:
        e = check_act_odd(R, N, offset)
        errs["sfu_act"] = max(errs["sfu_act"], e)
        print(f"[check] sfu_act {R}x{N} offset {offset}, 4 activations: max "
              f"err {e:.3g}")
    # qwen3-4b's, qwen2-vl-2b's (12 query heads over 2 of 128) and the MoE
    # archs' (dbrx 48 over 8, llama4 40 over 8, jamba 64 over 8)
    cfg, plen = get_config(SERVE_ARCH), max(SERVE_PROMPTS)
    vcfg = get_config(MROPE_ARCH)
    moe_cfgs = [dataclasses.replace(get_config(a), **cut)
                for a, cut in MOE_CUTS.items()]
    for acfg in (cfg, vcfg, *moe_cfgs):
        for Sq, Skv, causal, rows in (
                (plen, plen, True, None),                      # prefill
                *((1, plen + t, False, SERVE_MAX_LEN)          # decode
                  for t in (1, SERVE_NEW // 2, SERVE_NEW - 1))):
            e = check_attention(len(SERVE_PROMPTS), acfg.n_heads,
                                acfg.n_kv_heads, Sq, Skv, acfg.head_dim,
                                causal, torch.bfloat16, rows)
            errs["flash_attention"] = max(errs["flash_attention"], e)
            print(f"[check] {acfg.name} flash_attention Sq={Sq} Skv={Skv} "
                  f"{'causal' if causal else f'over a {rows}-row cache'} "
                  f"bf16: max err {e:.3g}")
    # whisper-medium's (bf16; 16 heads of 64, no GQA): non-causal over the
    # 1,500 frames (the encoder; the cross-attention prefill of the prompt
    # and its decode, which reads a cache whose stride is its length), the
    # causal self-attention prefill, its decode over the 128-row cache; and
    # its layernorm rows (1024 wide) of the encoder, the prompt and a step
    wcfg = get_config(WHISPER_ARCH)
    WB, WF, WP = WHISPER_BATCH, WHISPER_FRAMES, WHISPER_PROMPT
    for label, Sq, Skv, causal, rows in (
            ("encoder", WF, WF, False, None),
            ("cross prefill", WP, WF, False, None),
            ("cross decode", 1, WF, False, None),
            ("self prefill", WP, WP, True, None),
            ("self decode", 1, WP + WHISPER_MAX_LEN // 4, False,
             WHISPER_MAX_LEN)):
        e = check_attention(WB, wcfg.n_heads, wcfg.n_kv_heads, Sq, Skv,
                            wcfg.head_dim, causal, torch.bfloat16, rows)
        errs["flash_attention"] = max(errs["flash_attention"], e)
        print(f"[check] {WHISPER_ARCH} flash_attention {label} Sq={Sq} "
              f"Skv={Skv} {'causal' if causal else 'non-causal'} bf16: max "
              f"err {e:.3g}")
    e = check_attention(2, wcfg.n_heads, wcfg.n_kv_heads, WF, WF,
                        wcfg.head_dim, False, torch.float32)
    errs["flash_attention"] = max(errs["flash_attention"], e)
    print(f"[check] {WHISPER_ARCH} flash_attention encoder of 2 items fp32 "
          f"(its 4 + 4-layer fp32 check): max err {e:.3g}")
    for R in (WB * WF, WB * WP, WB):
        e = check_norm("sfu_layernorm", R, wcfg.d_model, torch.bfloat16)
        errs["sfu_layernorm"] = max(errs["sfu_layernorm"], e)
        print(f"[check] {WHISPER_ARCH} layernorm {R}x{wcfg.d_model} bf16, "
              f"+-gamma +-beta: max err {e:.3g}")
    # mamba2-2.7b's shapes: the served prefill (bf16, the SSM block's
    # chunk min(128, max(16, S))), the 4-layer fp32 check's prefill and
    # forward, and a 37-token prompt
    scfg = get_config(SSM_ARCH)
    heads = (scfg.ssm_heads, scfg.ssm_head_dim, scfg.ssm_groups,
             scfg.ssm_state)
    ssm_prefill = (len(SERVE_PROMPTS), plen, *heads)
    errs["ssd"] = check_ssd(*ssm_prefill, min(128, plen), torch.bfloat16)
    print(f"[check] serving ssd {ssm_prefill} chunk {min(128, plen)} bf16, "
          f"from zero and from an initial state: max err (y, state) "
          f"{errs['ssd']:.3g}")
    for S in (32, 48, 37):
        print(f"[check] ssd {(2, S, *heads)} chunk {S} fp32: max err "
              f"{check_ssd(2, S, *heads, S, torch.float32):.3g}")
    # jamba's prefill (256 SSD heads of 64, state 128), bf16 as served and
    # fp32 as its 2-layer check runs it
    jcfg = moe_cfgs[-1]
    jamba_prefill = (len(SERVE_PROMPTS), plen, jcfg.ssm_heads,
                     jcfg.ssm_head_dim, jcfg.ssm_groups, jcfg.ssm_state)
    for dt in (torch.bfloat16, torch.float32):
        e = check_ssd(*jamba_prefill, min(128, plen), dt)
        errs["ssd"] = max(errs["ssd"], e)
        print(f"[check] {jcfg.name} ssd {jamba_prefill} chunk "
              f"{min(128, plen)} {str(dt)[6:]}, from zero and from an "
              f"initial state: max err (y, state) {e:.3g}")

    # ----------------------------------------------------------- DORA path
    mark("DORA path")
    counters = kernel_counters()
    whole = dict.fromkeys(counters, 0)     # launches over the whole script

    def zero_counts():
        for k, fn in counters.items():
            whole[k] += fn.launches
            fn.launches = 0
    def run_binary(name, res, inputs):
        """Runs ``res`` on the card from ``inputs``; its launches, counted
        from zero, must be the binary's.  Returns the outputs on the host
        and the launches."""
        zero_counts()
        out = DoraCompiler().execute(res, inputs)
        torch.cuda.synchronize()
        ran = {k: fn.launches for k, fn in counters.items()}
        expected = binary_launches(res)
        print(f"[main] {name}: launches {ran}")
        require(ran == expected, f"{name}: launches {ran} differ from the "
                f"binary's instruction counts {expected}")
        return {k: v.cpu().numpy() for k, v in out.items()}, ran

    def check_layers(name, res, inputs, out):
        """Every layer against ``reference_execute`` of that layer on the
        inputs the binary gave it (LAYER_RTOL / LAYER_ATOL), and against
        ``reference_execute`` of the whole graph by relative L2
        (CHAIN_RTOL)."""
        g = res.graph
        env = {**inputs, **out}
        chained = g.reference_execute(inputs)
        worst_layer, worst_chain = (0.0, ""), (0.0, "")
        for l in g.layers:
            got = out[l.name]
            require(got.shape == (l.M, l.N) and bool(np.isfinite(got).all()),
                    f"{name}.{l.name}: shape {got.shape} or non-finite")
            sub = WorkloadGraph(l.name)
            if l.kind is LayerKind.NL:
                sub.add_input("x", l.M, l.N)
                sub.add_nl("y", "x", l.nonlinear)
                feed = {"x": env[l.lhs]}
            else:
                sub.add_input("a", l.M, l.K)
                sub.add_input("b", l.K, l.N)
                sub.add_mm("y", "a", "b", l.nonlinear)
                feed = {"a": env[l.lhs], "b": env[l.rhs]}
            want = sub.reference_execute(feed)["y"]
            atol = max(LAYER_ATOL, LAYER_ATOL_REL * float(np.abs(want).max()))
            err = np.abs(got - want)
            require(bool((err <= atol + LAYER_RTOL * np.abs(want)).all()),
                    f"{name}.{l.name}: max err {err.max()} (atol {atol})")
            worst_layer = max(worst_layer, (float(err.max()), l.name))
            rel = float(np.linalg.norm(got - chained[l.name])
                        / max(np.linalg.norm(chained[l.name]), 1e-30))
            require(rel <= CHAIN_RTOL,
                    f"{name}.{l.name}: chained rel L2 error {rel}")
            worst_chain = max(worst_chain, (rel, l.name))
        print(f"[main] {name}: {len(g.layers)} layers, "
              f"{len(res.codegen.program)} instructions; per-layer "
              f"max abs err {worst_layer[0]:.3g} ({worst_layer[1]}); chained "
              f"rel L2 err {worst_chain[0]:.3g} ({worst_chain[1]})")

    inputs, outputs = {}, {}
    launches = dict.fromkeys(counters, 0)
    for name in MAIN_MODELS:
        inputs[name] = programs[name].graph.random_inputs(0)
        outputs[name], ran = run_binary(name, programs[name], inputs[name])
        for k, n in ran.items():
            launches[k] += n
    print(f"[main] launches over the DORA path: {launches}")
    require(all(launches[k] > 0 for k in DORA_KERNELS),
            "a kernel of the DORA path was never launched")
    for name in MAIN_MODELS:
        check_layers(name, programs[name], inputs[name], outputs[name])
    del outputs

    # ROADMAP C.2: DeiT-S's chained error with one kernel family at a time
    # swapped for its plain version on the card (the runtime's references
    # to the kernels replaced for one run each, then restored), printed
    # beside the run with every kernel and the run with none; the limits
    # stay as they are
    from repro_torch.core import runtime as rt_mod
    plain_family = {
        "flex_gemm": {"flex_gemm": lambda a, b, epilogue="none", c=None:
                      ref.gemm(a, b, None, epilogue, c)},
        "sfu_softmax": {OpType.SFU_SOFTMAX: ref.softmax_rows},
        "sfu_layernorm": {OpType.SFU_LAYERNORM: ref.layernorm_rows},
        "sfu_act": {op: (lambda x, act=act: ref.ACT_FN[act](x))
                    for op, act in SFU_ACT.items()},
    }

    @contextlib.contextmanager
    def plain_kernels(families):
        saved_gemm, saved_sfu = rt_mod.flex_gemm, dict(rt_mod._SFU_FN)
        for fam in families:
            for key, fn in plain_family[fam].items():
                if key == "flex_gemm":
                    rt_mod.flex_gemm = fn
                else:
                    rt_mod._SFU_FN[key] = fn
        try:
            yield
        finally:
            rt_mod.flex_gemm = saved_gemm
            rt_mod._SFU_FN.clear()
            rt_mod._SFU_FN.update(saved_sfu)

    def chain_errors(name, families):
        """Relative L2 of every layer's chained output against
        ``reference_execute`` of the whole graph, with ``families`` run on
        their plain versions: (worst, its layer, the last layer's)."""
        res = programs[name]
        with plain_kernels(families):
            out = DoraCompiler().execute(res, inputs[name])
            torch.cuda.synchronize()
        chained = res.graph.reference_execute(inputs[name])
        rels = [(float(np.linalg.norm(out[l.name].cpu().numpy()
                                      - chained[l.name])
                       / max(np.linalg.norm(chained[l.name]), 1e-30)),
                 l.name) for l in res.graph.layers]
        return max(rels), rels[-1][0]

    c2_model = "DeiT-S"
    for label, families in (("every kernel", ()),
                            *((f"{f} plain", (f,)) for f in plain_family),
                            ("every family plain", tuple(plain_family))):
        (worst, layer), last = chain_errors(c2_model, families)
        print(f"[C.2] {c2_model} chained rel L2 vs reference_execute, "
              f"{label}: worst {worst:.4g} ({layer}), last layer {last:.4g}")
    zero_counts()

    # DORA's multi-tenant path: each joint, interleaved or per-PE binary run
    # once, counted from zero, and checked layer by layer
    mt_inputs = {}
    for label, (res, _) in mt_runs.items():
        mt_inputs[label] = res.graph.random_inputs(0)
        out, ran = run_binary(label, res, mt_inputs[label])
        for k, n in ran.items():
            launches[k] += n
        print(f"[main] {label}: tenants {tenants(label, res)}")
        check_layers(label, res, mt_inputs[label], out)

    # -------------------------------------------------------- serving path
    mark("serving")
    def device_profile(label, fn, host_s):
        """Device time by kernel over one call of ``fn`` (CUPTI trace),
        beside ``host_s``, the same call's unprofiled host time, and the
        host's self time in the PyTorch ops it traced (slowed by the
        tracing; the rest of the host's time is Python and the kernels'
        ctypes calls)."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        by_kernel = sorted(((e.self_device_time_total, e.count, e.key)
                            for e in events
                            if e.device_type == DeviceType.CUDA
                            and e.self_device_time_total > 0), reverse=True)
        busy_ms = sum(t for t, _, _ in by_kernel) / 1e3
        if not by_kernel:
            print(f"[profile] {label}: device time not measured: the "
                  f"profiler recorded no CUDA kernel")
            return
        print(f"[profile] {label}: device busy {busy_ms:.4f} ms of "
              f"{host_s * 1e3:.4f} ms unprofiled host time "
              f"({busy_ms / (host_s * 1e3):.1%}), "
              f"{sum(n for _, n, _ in by_kernel)} device activities")
        for t, n, key in by_kernel[:8]:
            print(f"[profile]   {t / 1e3:.4f} ms in {n} launches: {key[:90]}")
        ssd_ms = {k: sum(t for t, _, key in by_kernel if k in key) / 1e3
                  for k in SSD_PHASES}
        if any(ssd_ms.values()):
            ssd_n = sum(n for _, n, key in by_kernel
                        if any(k in key for k in SSD_PHASES))
            print(f"[profile]   ssd, its kernels summed: "
                  f"{sum(ssd_ms.values()):.4f} ms in {ssd_n} "
                  f"launches (" + ", ".join(f"{k.strip('_')} {t:.4f}"
                                            for k, t in ssd_ms.items())
                  + " ms)")
        for name, phases in BWD_PHASES.items():
            parts = {k: [(t, n) for t, n, key in by_kernel if k in key]
                     for k in phases}
            # the column sum is both norms': a backward shows where its own
            # kernels ran
            if any(v for k, v in parts.items() if k != "column_sum"):
                ms = {k: sum(t for t, _ in v) / 1e3 for k, v in parts.items()}
                print(f"[profile]   {name}, its kernels summed: "
                      f"{sum(ms.values()):.4f} ms in "
                      f"{sum(n for v in parts.values() for _, n in v)} "
                      f"launches (" + ", ".join(f"{k.strip('_')} {t:.4f}"
                                                for k, t in ms.items())
                      + " ms)")
        by_op = sorted(((e.self_cpu_time_total, e.count, e.key)
                        for e in events if e.device_type == DeviceType.CPU
                        and e.self_cpu_time_total > 0), reverse=True)
        host_ms = sum(t for t, _, _ in by_op) / 1e3
        print(f"[profile]   host, traced: {host_ms:.4f} ms self time in "
              f"{sum(n for _, n, _ in by_op)} PyTorch ops; "
              + "; ".join(f"{key[:40]} {t / 1e3:.4f} ms in {n}"
                          for t, n, key in by_op[:6]))

    def host_s(fn, calls=3):
        """Host seconds of a call of ``fn``: the least of ``calls`` timed
        calls after a warm-up call, each up to a synchronize (the host
        clock of a machine that shares its cores varies from call to
        call)."""
        fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(calls):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best

    def serve_model(cfg, rtol, shape, cut=""):
        """Serves ``cfg`` at full width on the card (cut in depth where
        ``cut`` says so): builds the server, checks the counted serve's
        launches against ``path_launches`` (kernel -> launches per prefill
        or decode step, and in the prefill only), the teacher-forced
        logits of the kernels against the plain versions (relative L2 <=
        ``rtol``; for a MoE arch with the kernels' routes pinned to the
        plain path's, each decision they would have made otherwise within
        ``ROUTE_MARGIN`` of a tie), and times a prefill and a decode step.
        Returns the server, the padded prompts and the served tokens."""
        per_step, per_prefill, derivation = path_launches(cfg)
        cut = f" [{cut}]" if cut else ""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        server = BatchServer(cfg, max_len=SERVE_MAX_LEN, seed=0)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        cast_bytes, item_bytes, held_bytes = load_bytes(cfg)
        print(f"[serve] {cfg.name}{cut}: {cfg.n_layers} layers, d "
              f"{cfg.d_model}, {shape}, vocab {cfg.vocab_size}, "
              f"{cfg.param_count() / 1e9:.3f} B parameters drawn on the card "
              f"and cast to {cfg.compute_dtype} in {load_s:.2f} s; "
              f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        print(f"[serve] {cfg.name}{cut} load peak (max_memory_allocated over "
              f"the build, less the {before / 2**30:.3f} GiB allocated "
              f"before): {peak / 2**30:.3f} GiB; limit "
              f"{cast_bytes / 2**30:.3f} GiB cast parameters + "
              f"{item_bytes / 2**30:.3f} GiB largest fp32 item + 1 GiB = "
              f"{(cast_bytes + item_bytes) / 2**30 + 1:.3f} GiB (drawn whole "
              f"in fp32, then cast: "
              f"{(4 * cfg.param_count() + cast_bytes) / 2**30:.3f} GiB)")
        require(peak <= cast_bytes + item_bytes + 2**30,
                f"{cfg.name}: load peak {peak} bytes over the limit")
        # tighter: a second fp32 layer held beside the first (1.45 GiB at
        # d 6144) would pass the limit above where the embedding is the
        # largest item, but not this one
        print(f"[serve] {cfg.name}{cut} load peak against one fp32 item held "
              f"at a time: at most {held_bytes / 2**30:.3f} GiB + 1 GiB")
        require(peak <= held_bytes + 2**30,
                f"{cfg.name}: load peak {peak} bytes over one fp32 item "
                f"held at a time ({held_bytes} + 1 GiB)")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in SERVE_PROMPTS]

        def requests(max_new=SERVE_NEW):
            return [Request(i, p, max_new) for i, p in enumerate(prompts)]

        server.serve(requests(2))        # warm-up: cuBLAS plans, allocator
        torch.cuda.synchronize()
        steps = SERVE_NEW
        expected = {k: 0 for k in counters} | {
            k: steps * n for k, n in per_step.items()} | per_prefill
        print(f"[serve] {cfg.name} expected launches: 1 prefill + "
              f"{steps - 1} decode steps = {steps} steps {derivation} = "
              + ", ".join(f"{k} {expected[k]}"
                          for k in {**per_step, **per_prefill})
              + "; the other kernels 0")
        zero_counts()
        stats = server.serve(requests())
        torch.cuda.synchronize()
        serve_launches = {k: fn.launches for k, fn in counters.items()}
        print(f"[serve] launches over {cfg.name}'s serving path: "
              f"{serve_launches}")
        require(serve_launches == expected,
                f"serving launches {serve_launches} differ from {expected}")
        for k, n in serve_launches.items():
            launches[k] += n
        outs = stats["outputs"]
        require(sorted(outs) == list(range(len(prompts)))
                and all(len(t) == SERVE_NEW and all(0 <= x < cfg.vocab_size
                                                    for x in t)
                        for t in outs.values()),
                f"served outputs malformed: {outs}")
        print(f"[serve] {cfg.name}{cut}: prefill {stats['prefill_s']} s, "
              f"decode {stats['decode_s']} s = {stats['decode_tok_per_s']} "
              f"tok/s ({len(prompts)} x {SERVE_NEW - 1} tokens, host clock "
              f"around synchronize) on {smi}")
        print(f"[serve] first tokens: " + "; ".join(
            f"req {i}: {t[:8]}" for i, t in outs.items()))

        # the same weights, teacher-forced on the served tokens, through the
        # kernels and the plain versions, every MoE layer's routing recorded
        # on both; for a MoE arch also through the kernels with each route
        # pinned to the plain path's, and, cut to its first
        # MOE_SHALLOW_LAYERS layers, the same
        B, plen = len(prompts), max(SERVE_PROMPTS)
        padded = np.zeros((B, plen), np.int64)
        for i, p in enumerate(prompts):
            padded[i, plen - len(p):] = p
        served = torch.tensor([outs[i] for i in range(B)], device=dev)
        tokens = torch.from_numpy(padded).to(dev)
        moe = any(p.ffn == "moe" for p in cfg.pattern)
        forced = teacher_forced(cfg, server.params, tokens, served,
                                ("kernels", "pinned") if moe else ("kernels",))
        for t, got in enumerate(forced["kernels"]["argmax"]):
            require(torch.equal(got, served[:, t]), f"step {t}: the kernels' "
                    f"greedy tokens differ from the served ones")
        if not moe:
            logits_report(f"{cfg.name}{cut} kernels", forced["kernels"], rtol)
        else:
            free = forced["kernels"]
            route_report(f"{cfg.name}{cut} kernels vs plain versions",
                         free["routes"])
            rel, agree = free["rel"], float(np.mean(free["agree"]))
            print(f"[serve] {cfg.name}{cut} kernels vs plain versions, "
                  f"teacher-forced, routes free: logits rel L2 prefill "
                  f"{rel[0]:.4g}, decode max {max(rel[1:]):.4g}; greedy "
                  f"tokens agree on {agree:.1%} (held on the pinned runs "
                  f"below)")
            shallow = cfg.n_layers <= MOE_SHALLOW_LAYERS
            runs = [(cfg, server.params, SERVE_RTOL if shallow else MOE_RTOL,
                     forced["pinned"], "")]
            if not shallow:
                n = MOE_SHALLOW_LAYERS
                cfg_s = dataclasses.replace(cfg, n_layers=n,
                                            pattern=cfg.pattern[:n])
                p_s = {**server.params, "layers": server.params["layers"][:n]}
                runs.append((cfg_s, p_s, SERVE_RTOL, teacher_forced(
                    cfg_s, p_s, tokens, served, ("pinned",))["pinned"],
                    f", cut to its first {n} layers"))
            for rcfg, _, limit, o, note in runs:
                label = (f"{cfg.name}{cut}{note} kernels with each route "
                         f"pinned to the plain path's")
                margins = route_report(f"{label} (their own decisions) vs "
                                       f"plain versions", o["routes"])
                logits_report(label, o, limit)
                if limit == SERVE_RTOL:
                    require(all(m < ROUTE_MARGIN for m in margins),
                            f"{label}: a route differs "
                            f"{max(margins, default=0)} from a tie (limit "
                            f"{ROUTE_MARGIN})")
                    print(f"[routes] {label}: every differing decision within "
                          f"{ROUTE_MARGIN} of a tie over {rcfg.n_layers} "
                          f"layers")
            del runs

        # where serving's time goes: one prefill and one decode step of the
        # served batch, each timed unprofiled after a warm-up call
        _, cache = lm.prefill(cfg, server.params, tokens,
                              max_len=SERVE_MAX_LEN)
        prefill_fn = lambda: lm.prefill(  # noqa: E731
            cfg, server.params, tokens, max_len=SERVE_MAX_LEN)
        decode_fn = lambda: lm.decode_step(  # noqa: E731
            cfg, server.params, cache, served[:, :1], plen)
        prefill_s, decode_s = host_s(prefill_fn), host_s(decode_fn)
        weight_bytes = sum(t.numel() * t.element_size() for t in
                           (server.params["lm_head"],
                            *(w for lp in server.params["layers"]
                              for sub in lp.values() for w in sub.values())))
        print(f"[time] {cfg.name}{cut} serving on {smi}: prefill {B}x{plen} "
              f"{prefill_s} s, one decode step {decode_s * 1e3:.4f} ms "
              f"({B / decode_s:.1f} tok/s); the step reads at least "
              f"{weight_bytes / 1e9:.3f} GB of bf16 weights, "
              f"{1e3 * weight_bytes / bw_peak:.4f} ms at the memory rate")
        if cfg.n_experts:
            # every expert runs on its capacity slots, chosen or not; a step
            # that ran only the experts its B x K choices name would read
            idle = sum(t.numel() * t.element_size() *
                       (1 - min(cfg.n_experts, B * cfg.top_k)
                        / cfg.n_experts)
                       for lp in server.params["layers"] if "moe" in lp
                       for k, t in lp["moe"].items() if k != "router")
            print(f"[time] {cfg.name}{cut} decode: the MoE layers read every "
                  f"expert's weights each step; running only the at most "
                  f"{B} x {cfg.top_k} chosen experts of a layer would read "
                  f"{(weight_bytes - idle) / 1e9:.3f} GB, "
                  f"{1e3 * (weight_bytes - idle) / bw_peak:.4f} ms at the "
                  f"memory rate")
        device_profile(f"{cfg.name} prefill {B}x{plen}", prefill_fn,
                       prefill_s)
        device_profile(f"{cfg.name} decode step at pos {plen}", decode_fn,
                       decode_s)
        del cache
        return server, tokens, served

    def fp32_decode_check(cfg):
        """fp32 compute at full width, 4 layers: prefill of 32 tokens + 16
        decode steps == forward of 48, and forward through the kernels ==
        through the plain versions."""
        cfg32 = dataclasses.replace(cfg, n_layers=4, compute_dtype="float32")
        p32 = lm.init(cfg32, torch.Generator(device=dev).manual_seed(1), dev)
        tok = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 48))).to(dev)
        Sp = 32
        full, _ = lm.forward(cfg32, p32, tok)
        plain_full, _ = lm.forward(cfg32, p32, tok, plain=True)
        pre, cache = lm.prefill(cfg32, p32, tok[:, :Sp], max_len=48)
        errs32 = [float((pre - full[:, Sp - 1]).abs().max())]
        for t in range(Sp, 48):
            step, cache = lm.decode_step(cfg32, p32, cache, tok[:, t:t + 1], t)
            errs32.append(float((step - full[:, t]).abs().max()))
        scale = float(full.abs().max())
        print(f"[serve] fp32 {cfg.name} at full width, 4 layers: prefill + "
              f"{48 - Sp} decode steps vs forward: max |err| "
              f"{max(errs32):.4g} (limit {FP32_DECODE_TOL} x max|logit| "
              f"{scale:.4g} = {FP32_DECODE_TOL * scale:.4g}); forward kernels "
              f"vs plain rel L2 {rel_l2(full, plain_full):.3g}")
        require(max(errs32) <= FP32_DECODE_TOL * scale,
                f"fp32 decode differs from forward: {errs32}")
        require(rel_l2(full, plain_full) <= 1e-4,
                "fp32 forward: kernels differ from the plain versions")

    # qwen3-4b: rmsnorm for norm1, norm2, and q-/k-norm, per layer, plus
    # the final norm; attention: one per layer; per prefill and decode step
    server, tokens, served = serve_model(
        cfg, SERVE_RTOL,
        f"heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}")
    fp32_decode_check(cfg)
    B = len(SERVE_PROMPTS)
    del server, tokens, served
    torch.cuda.empty_cache()

    # mamba2-2.7b: rmsnorm for norm1 and the gated norm per layer, plus the
    # final norm, per step; ssd once per layer in prefill only (decode
    # updates the state in plain PyTorch, as the reference does)
    sserver, stokens, _ = serve_model(
        scfg, SSM_RTOL,
        f"{scfg.ssm_heads} SSD heads of {scfg.ssm_head_dim}, state "
        f"{scfg.ssm_state}, groups {scfg.ssm_groups}, no FFN")
    # the served weights cut to their first layers: less depth to carry
    # the bf16 ulps, so a tighter bound on the kernels against plain
    scfg_s = dataclasses.replace(scfg, n_layers=SSM_SHALLOW_LAYERS)
    p_s = {**sserver.params,
           "layers": sserver.params["layers"][:SSM_SHALLOW_LAYERS]}
    k_logits, _ = lm.prefill(scfg_s, p_s, stokens, max_len=SERVE_MAX_LEN)
    p_logits, _ = lm.prefill(scfg_s, p_s, stokens, max_len=SERVE_MAX_LEN,
                             plain=True)
    e_s = rel_l2(k_logits, p_logits)
    print(f"[serve] bf16 {scfg.name}, the served weights' first "
          f"{SSM_SHALLOW_LAYERS} layers: prefill logits kernels vs plain "
          f"rel L2 {e_s:.4g} (limit {SSM_SHALLOW_RTOL})")
    require(bool(torch.isfinite(k_logits).all()) and e_s <= SSM_SHALLOW_RTOL,
            f"bf16 {scfg.name}, {SSM_SHALLOW_LAYERS} layers: kernels differ "
            f"from the plain versions: {e_s}")
    del sserver, p_s, k_logits, p_logits
    torch.cuda.empty_cache()
    # the same weights at fp32 compute and full depth: prefill of the
    # served prompts through the kernels against the plain versions
    scfg32 = dataclasses.replace(scfg, compute_dtype="float32")
    p32 = lm.init(scfg32, torch.Generator(device=dev).manual_seed(0), dev)
    k_logits, _ = lm.prefill(scfg32, p32, stokens, max_len=SERVE_MAX_LEN)
    p_logits, _ = lm.prefill(scfg32, p32, stokens, max_len=SERVE_MAX_LEN,
                             plain=True)
    e32 = rel_l2(k_logits, p_logits)
    print(f"[serve] fp32 {scfg.name} at full width and depth: prefill "
          f"{tuple(stokens.shape)} logits kernels vs plain rel L2 {e32:.4g} "
          f"(limit {SSM_FP32_RTOL}); greedy tokens agree on "
          f"{float((k_logits.argmax(-1) == p_logits.argmax(-1)).float().mean()):.1%}")
    require(bool(torch.isfinite(k_logits).all()) and e32 <= SSM_FP32_RTOL,
            f"fp32 {scfg.name}: kernels differ from the plain versions: {e32}")
    del p32, k_logits, p_logits
    torch.cuda.empty_cache()
    fp32_decode_check(scfg)

    def mrope_check(vcfg, params, tokens):
        """qwen2-vl-2b's ``forward`` on the first served prompt with an
        image-like (t, h, w) grid of ids, kernels against plain versions;
        the ids must move the logits away from the text positions'."""
        rows, cols = MROPE_GRID
        S = rows * cols
        tok = tokens[:1, -S:]
        t_ids = torch.arange(S, dtype=torch.int32, device=dev)
        ids = torch.stack([t_ids, t_ids // cols, t_ids % cols])[:, None]
        k_logits, _ = lm.forward(vcfg, params, tok, positions=ids)
        p_logits, _ = lm.forward(vcfg, params, tok, positions=ids,
                                 plain=True)
        e_ids = rel_l2(k_logits, p_logits)
        moved = rel_l2(lm.forward(vcfg, params, tok)[0], k_logits)
        print(f"[serve] {vcfg.name} forward on one {S}-token prompt with an "
              f"image-like (t, h, w) grid of {rows} x {cols} ids: logits "
              f"kernels vs plain rel L2 {e_ids:.4g} (limit {SERVE_RTOL}); "
              f"the same prompt on text positions differs by rel L2 "
              f"{moved:.4g}")
        require(bool(torch.isfinite(k_logits).all())
                and k_logits.shape == (1, S, vcfg.vocab_size)
                and e_ids <= SERVE_RTOL,
                f"{vcfg.name} with (t, h, w) ids: kernels differ from the "
                f"plain versions: {e_ids}")
        require(moved > 1e-3, f"{vcfg.name}: the (t, h, w) ids left the "
                f"logits as the text positions give them ({moved})")

    # the other dense archs, each server freed before the next is drawn
    for arch in DENSE_ARCHS:
        dcfg = get_config(arch)
        dserver, dtokens, _ = serve_model(
            dcfg, SERVE_RTOL,
            f"heads {dcfg.n_heads}/{dcfg.n_kv_heads}, {dcfg.mlp_kind} d_ff "
            f"{dcfg.d_ff}, {dcfg.norm_kind}"
            f"{', qkv bias' if dcfg.qkv_bias else ''}"
            f"{f', M-RoPE {dcfg.m_rope_sections}' if dcfg.m_rope else ''}")
        if dcfg.m_rope:
            mrope_check(dcfg, dserver.params, dtokens)
        del dserver, dtokens
        torch.cuda.empty_cache()
        if dcfg.norm_kind == "layernorm":
            fp32_decode_check(dcfg)
            torch.cuda.empty_cache()

    def whisper(cfg):
        """whisper-medium at full width and depth: drawn from seed 0 one
        item at a time (``encdec.init_cast``), 4 items of stub frames and a
        prompt each, greedy decoding through ``encdec.prefill`` /
        ``decode_step``; launch counts of the prefill and of the decode
        steps, then the same tokens teacher-forced through the kernels and
        through the plain versions.  Returns the parameters, frames,
        prompt tokens and served tokens."""
        Le, Ld = cfg.encoder_layers, cfg.n_layers
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params = encdec.init_cast(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - before
        nbytes = sum(t.numel() * t.element_size() for _, t in leaves(params))
        item = 4 * max(cfg.vocab_size * cfg.d_model, *(
            sum(t.numel() for _, t in leaves(lp))
            for lp in params["encoder"] + params["decoder"]))
        print(f"[serve] {cfg.name}: {Le} encoder + {Ld} decoder layers, d "
              f"{cfg.d_model}, heads {cfg.n_heads} of {cfg.head_dim}, "
              f"{cfg.mlp_kind} d_ff {cfg.d_ff}, {cfg.norm_kind}, vocab "
              f"{cfg.vocab_size}; {cfg.param_count() / 1e9:.3f} B parameters "
              f"drawn on the card and cast to {cfg.compute_dtype} in "
              f"{load_s:.2f} s; load peak {peak / 2**30:.3f} GiB, limit "
              f"{nbytes / 2**30:.3f} GiB cast + {item / 2**30:.3f} GiB "
              f"largest fp32 item + 1 GiB")
        require(peak <= nbytes + item + 2**30,
                f"{cfg.name}: load peak {peak} bytes over the limit")
        B, new = WHISPER_BATCH, SERVE_NEW
        frames = torch.randn((B, WHISPER_FRAMES, cfg.d_model),
                             generator=torch.Generator(device=dev).manual_seed(0),
                             device=dev).to(torch.bfloat16)
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, WHISPER_PROMPT))).to(dev)
        plen = WHISPER_PROMPT

        def generate(n_new, counted=False):
            zero_counts()
            logits, cache = encdec.prefill(cfg, params, frames, tokens,
                                           max_len=WHISPER_MAX_LEN)
            torch.cuda.synchronize()
            pre = {k: fn.launches for k, fn in counters.items()}
            zero_counts()
            out = [logits.argmax(-1)]
            for t in range(1, n_new):
                logits, cache = encdec.decode_step(
                    cfg, params, cache, out[-1][:, None], plen + t - 1)
                out.append(logits.argmax(-1))
            torch.cuda.synchronize()
            dec = {k: fn.launches for k, fn in counters.items()}
            return torch.stack(out, 1), pre, dec

        generate(2)              # warm-up: cuBLAS plans, allocator
        t0 = time.perf_counter()
        served, pre, dec = generate(new)
        gen_s = time.perf_counter() - t0
        per_prefill, per_step, why = encdec_launches(cfg)
        want_pre = dict.fromkeys(counters, 0) | per_prefill
        want_dec = dict.fromkeys(counters, 0) | {
            k: (new - 1) * n for k, n in per_step.items()}
        print(f"[serve] {cfg.name} expected launches: {why}, {new - 1} "
              f"decode steps; the other kernels 0")
        print(f"[serve] launches over {cfg.name}'s prefill: {pre}; its "
              f"decode steps: {dec}")
        require(pre == want_pre and dec == want_dec,
                f"{cfg.name}: launches differ from {want_pre} / {want_dec}")
        for k in counters:
            launches[k] += pre[k] + dec[k]
        require(served.shape == (B, new) and bool(
            ((served >= 0) & (served < cfg.vocab_size)).all()),
            f"{cfg.name}: served tokens malformed")
        print(f"[serve] {cfg.name}: {B} x {WHISPER_FRAMES} frames, prompts "
              f"of {plen}, {new} greedy tokens in {gen_s:.4f} s (host clock "
              f"around synchronize) on {smi}; first tokens "
              + "; ".join(f"item {i}: {served[i, :8].tolist()}"
                          for i in range(B)))

        # the served tokens teacher-forced through the kernels and through
        # the plain versions
        k_logits, k_cache = encdec.prefill(cfg, params, frames, tokens,
                                           max_len=WHISPER_MAX_LEN)
        p_logits, p_cache = encdec.prefill(cfg, params, frames, tokens,
                                           max_len=WHISPER_MAX_LEN, plain=True)
        errs_l2, agree = [], []
        for t in range(new):
            require(bool(torch.isfinite(k_logits).all())
                    and k_logits.shape == (B, cfg.vocab_size),
                    f"step {t}: logits {tuple(k_logits.shape)} or non-finite")
            require(torch.equal(k_logits.argmax(-1), served[:, t]),
                    f"step {t}: the kernels' greedy tokens differ from the "
                    f"served ones")
            errs_l2.append(rel_l2(k_logits, p_logits))
            agree.append(float((k_logits.argmax(-1) == p_logits.argmax(-1))
                               .float().mean()))
            if t + 1 < new:
                step = served[:, t:t + 1]
                k_logits, k_cache = encdec.decode_step(
                    cfg, params, k_cache, step, plen + t)
                p_logits, p_cache = encdec.decode_step(
                    cfg, params, p_cache, step, plen + t, plain=True)
        del k_cache, p_cache
        print(f"[serve] {cfg.name} kernels vs plain versions, teacher-forced: "
              f"logits rel L2 prefill {errs_l2[0]:.4g}, decode max "
              f"{max(errs_l2[1:]):.4g} (step {int(np.argmax(errs_l2[1:])) + 1}"
              f"), mean {float(np.mean(errs_l2[1:])):.4g}; greedy tokens agree "
              f"on {float(np.mean(agree)):.1%} (limit rel L2 {SERVE_RTOL})")
        require(max(errs_l2) <= SERVE_RTOL,
                f"{cfg.name}: logits differ from the plain path: {errs_l2}")

        # where its time goes: one prefill (the encoder included) and one
        # decode step, each timed unprofiled after a warm-up call
        _, cache = encdec.prefill(cfg, params, frames, tokens,
                                  max_len=WHISPER_MAX_LEN)
        prefill_fn = lambda: encdec.prefill(  # noqa: E731
            cfg, params, frames, tokens, max_len=WHISPER_MAX_LEN)
        decode_fn = lambda: encdec.decode_step(  # noqa: E731
            cfg, params, cache, served[:, :1], plen)
        prefill_s, decode_s = host_s(prefill_fn), host_s(decode_fn)
        print(f"[time] {cfg.name} on {smi}: prefill ({B} x {WHISPER_FRAMES} "
              f"frames, {B} x {plen} tokens) {prefill_s} s, one decode step "
              f"{decode_s * 1e3:.4f} ms ({B / decode_s:.1f} tok/s)")
        device_profile(f"{cfg.name} prefill", prefill_fn, prefill_s)
        device_profile(f"{cfg.name} decode step at pos {plen}", decode_fn,
                       decode_s)
        del cache
        return params, frames, tokens, served

    def leaves(tree):
        if isinstance(tree, dict):
            for k, v in tree.items():
                for path, t in leaves(v):
                    yield f"{k}/{path}", t
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                for path, t in leaves(v):
                    yield f"{i}/{path}", t
        else:
            yield "", tree

    wparams, wframes, wtokens, wserved = whisper(wcfg)

    # fp32 compute at full width, 4 encoder + 4 decoder layers: prefill of
    # 32 tokens + 16 decode steps == forward of 48, over 1,500 frames, and
    # forward through the kernels == through the plain versions
    wcfg32 = dataclasses.replace(wcfg, n_layers=4, encoder_layers=4,
                                 compute_dtype="float32")
    gen1 = torch.Generator(device=dev).manual_seed(1)
    wp32 = encdec.init(wcfg32, gen1, dev)
    fr32 = torch.randn((2, WHISPER_FRAMES, wcfg.d_model), generator=gen1,
                       device=dev)
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, wcfg.vocab_size, (2, 48))).to(dev)
    full = encdec.forward(wcfg32, wp32, fr32, tok)
    plain_full = encdec.forward(wcfg32, wp32, fr32, tok, plain=True)
    pre, cache = encdec.prefill(wcfg32, wp32, fr32, tok[:, :32], max_len=48)
    errs32 = [float((pre - full[:, 31]).abs().max())]
    for t in range(32, 48):
        step, cache = encdec.decode_step(wcfg32, wp32, cache,
                                         tok[:, t:t + 1], t)
        errs32.append(float((step - full[:, t]).abs().max()))
    scale = float(full.abs().max())
    print(f"[serve] fp32 {WHISPER_ARCH} at full width, 4 + 4 layers, "
          f"{WHISPER_FRAMES} frames: prefill + 16 decode steps vs forward: "
          f"max |err| {max(errs32):.4g} (limit {FP32_DECODE_TOL} x "
          f"max|logit| {scale:.4g} = {FP32_DECODE_TOL * scale:.4g}); forward "
          f"kernels vs plain rel L2 {rel_l2(full, plain_full):.3g}")
    require(max(errs32) <= FP32_DECODE_TOL * scale,
            f"fp32 {WHISPER_ARCH} decode differs from forward: {errs32}")
    require(rel_l2(full, plain_full) <= 1e-4,
            f"fp32 {WHISPER_ARCH} forward: kernels differ from the plain "
            f"versions")
    del wp32, fr32, full, plain_full, cache
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ MoE archs
    mark("MoE serving")
    for arch, cut in MOE_CUTS.items():
        full_cfg = get_config(arch)
        mcfg = dataclasses.replace(full_cfg, **cut)
        why = "cut: " + ", ".join(f"{k} {v} of {getattr(full_cfg, k)}"
                                  for k, v in cut.items())
        kinds = Counter((p.mixer, p.ffn) for p in mcfg.pattern)
        mserver, mtokens, _ = serve_model(
            mcfg, SERVE_RTOL,
            f"heads {mcfg.n_heads}/{mcfg.n_kv_heads}, {mcfg.n_experts} "
            f"experts top-{mcfg.top_k} of {mcfg.mlp_kind} d_ff {mcfg.d_ff}, "
            f"{mcfg.norm_kind}, layers "
            + ", ".join(f"{n} x {m}+{f}" for (m, f), n in kinds.items())
            + (f", {mcfg.ssm_heads} SSD heads of {mcfg.ssm_head_dim}"
               if mcfg.ssm_state else ""), cut=why)
        del mserver
        torch.cuda.empty_cache()
        if arch in MOE_FP32_LAYERS:
            n = MOE_FP32_LAYERS[arch]
            cfg32 = dataclasses.replace(
                mcfg, n_layers=n, pattern=mcfg.pattern[:n]
                if n < mcfg.pattern_len else mcfg.pattern,
                compute_dtype="float32")
            p32 = lm.init(cfg32, torch.Generator(device=dev).manual_seed(1),
                          dev)
            moe_fp32_check(cfg32, p32, mtokens, mtokens[:, :1],
                           f"{why}; fp32 check: the first {n} layers")
            del p32
        else:
            moe_layer_fp32_check(mcfg, why)
        del mtokens
        torch.cuda.empty_cache()

    # ------------------------------------------------------------- training
    mark("training")
    # (a) each backward kernel against autograd of its plain version
    def grad_close(what, got, want, dt, rel_tol=BF16_GRAD_RTOL) -> float:
        """fp32: max |err| within FP32_GRAD_TOL x max|ref|; bf16: relative
        L2 within ``rel_tol``.  Returns the max |err|."""
        err = max_err(got, want)
        if dt == torch.float32:
            scale = float(want.float().abs().max())
            require(err <= FP32_GRAD_TOL * scale,
                    f"{what}: max err {err} (limit {FP32_GRAD_TOL} x {scale})")
        else:
            rel = rel_l2(got, want)
            require(got.dtype == want.dtype and rel <= rel_tol,
                    f"{what}: rel L2 {rel} (limit {rel_tol}), {got.dtype}")
        return err

    def check_rmsnorm_bwd(R, N, dt, offset=0) -> float:
        """rmsnorm's forward (with rstd) and backward kernels through
        autograd, with and without gamma, against autograd of the plain
        version; a second backward gives the same bits."""
        x = offset_view(R, N, offset, dt, scale=2.0)
        dy = offset_view(R, N, offset, dt)
        g = 1.0 + offset_view(1, N, offset, scale=0.2)[0]
        worst = 0.0
        for gamma in (g, None):
            runs = []
            for fn in (ref.rmsnorm_rows, rmsnorm_rows, rmsnorm_rows):
                xr = x.detach().requires_grad_()
                gr = None if gamma is None else \
                    gamma.detach().requires_grad_()
                fn(xr, gr).backward(dy)
                runs.append((xr.grad, None if gr is None else gr.grad))
            torch.cuda.synchronize()
            (dxw, dgw), (dx, dg), (dx2, dg2) = runs
            what = (f"rmsnorm backward {R}x{N} {str(dt)[6:]} offset "
                    f"{offset}{' +gamma' if gamma is not None else ''}")
            require(torch.equal(dx, dx2) and (dg is None or torch.equal(dg, dg2)),
                    f"{what}: two backward runs differ")
            worst = max(worst, grad_close(f"{what} dx", dx, dxw, dt))
            if gamma is not None:
                worst = max(worst, grad_close(f"{what} dgamma", dg, dgw, dt,
                                              DGAMMA_RTOL))
        return worst

    def check_attention_bwd(B, Hq, Hkv, Sq, Skv, D, causal, dt) -> float:
        """The prefill kernel with its log-sum-exp, then the backward
        kernels (any shape: the decode-shaped ones too), against autograd of
        ``ref.mha_attention``; a second backward gives the same bits."""
        q = randn(B, Hq, Sq, D, dtype=dt)
        k, v = randn(B, Hkv, Skv, D, dtype=dt), randn(B, Hkv, Skv, D, dtype=dt)
        do = randn(B, Hq, Sq, D, dtype=dt)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        ref.mha_attention(*leaves, causal=causal).backward(do)
        out, lse = attention_lse(q, k, v, causal=causal)
        grads = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        again = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        torch.cuda.synchronize()
        what = (f"flash_attention backward {(B, Hq, Hkv, Sq, Skv, D)} "
                f"{'causal' if causal else 'full'} {str(dt)[6:]}")
        require(all(torch.equal(a, b) for a, b in zip(grads, again)),
                f"{what}: two backward runs differ")
        require(not causal or Sq <= Skv or not grads[0][:, :, :Sq - Skv].any(),
                f"{what}: a row that sees no key has a gradient")
        err = max(grad_close(f"{what} d{n}", g, leaf.grad, dt)
                  for n, g, leaf in zip("qkv", grads, leaves))
        return err, max(rel_l2(g, leaf.grad) for g, leaf in zip(grads, leaves))

    for R, N in SFU_SHAPES:
        errs["rmsnorm_bwd"] = max(errs["rmsnorm_bwd"], check_rmsnorm_bwd(
            R, N, torch.float32))
    for R, N, offset in RMS_BWD_ROWS:
        for dt in (torch.float32, torch.bfloat16):
            e = check_rmsnorm_bwd(R, N, dt, offset)
            errs["rmsnorm_bwd"] = max(errs["rmsnorm_bwd"], e)
            print(f"[train] rmsnorm backward {R}x{N} {str(dt)[6:]} offset "
                  f"{offset}, +-gamma, deterministic: max err {e:.3g}")
    print(f"[train] rmsnorm backward over the reference's SFU rows (fp32) "
          f"and the rows above: max err {errs['rmsnorm_bwd']:.3g} (fp32 "
          f"limit {FP32_GRAD_TOL} x max|ref|; bf16 dx rel L2 "
          f"{BF16_GRAD_RTOL}, dgamma {DGAMMA_RTOL})")
    attn_cases = [(s, c, dt) for s in ATTN_SHAPES for c in (True, False)
                  for dt in (torch.float32, torch.bfloat16)] + [
        (ATTN_EMPTY_ROWS, True, torch.float32)] + [
        (s, c, torch.bfloat16) for s in (ATTN_EMPTY_ROWS, ATTN_RAGGED_128)
        for c in (True, False)]
    for shape, causal, dt in attn_cases:
        e, rel = check_attention_bwd(*shape, causal, dt)
        errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], e)
        print(f"[train] flash_attention backward {shape} "
              f"{'causal' if causal else 'full'} {str(dt)[6:]}, "
              f"deterministic: max err {e:.3g}, worst rel L2 {rel:.3g}")
    train_cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                                    n_layers=TRAIN_LAYERS)
    train_shape = (TRAIN_BATCH, train_cfg.n_heads, train_cfg.n_kv_heads,
                   TRAIN_SEQ, TRAIN_SEQ, train_cfg.head_dim)
    long_shape = (LONG_TRAIN_BATCH[TRAIN_ARCH], *train_shape[1:3],
                  LONG_TRAIN_SEQ, LONG_TRAIN_SEQ, train_shape[5])
    for shape, note in ((train_shape, "training attention"),
                        (long_shape, "attention at train_4k, the long-"
                                     "context phase's")):
        e, rel = check_attention_bwd(*shape, True, torch.bfloat16)
        errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], e)
        print(f"[train] flash_attention backward {shape} causal bf16 "
              f"({TRAIN_ARCH}'s {note}), deterministic: max err {e:.3g}, "
              f"worst rel L2 {rel:.3g} (dq, dk, dv rel L2 limit "
              f"{BF16_GRAD_RTOL})")
    # the other dense archs' training attention (4 x 512, causal), fp32 and
    # bf16: qwen1.5-4b's 20 query heads over 20 kv heads (GQA 1), qwen2-vl-
    # 2b's 12 over 2 and internlm2-20b's 48 over 8 (dbrx-132b's shape)
    for arch in DENSE_TRAIN_ARCHS:
        acfg = get_config(arch)
        shape = (TRAIN_BATCH, acfg.n_heads, acfg.n_kv_heads, TRAIN_SEQ,
                 TRAIN_SEQ, acfg.head_dim)
        for dt in (torch.float32, torch.bfloat16):
            e, rel = check_attention_bwd(*shape, True, dt)
            errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], e)
            print(f"[train] flash_attention backward {shape} causal "
                  f"{str(dt)[6:]} ({arch}'s training attention, GQA "
                  f"{acfg.n_heads // acfg.n_kv_heads}), deterministic: max "
                  f"err {e:.3g}, worst rel L2 {rel:.3g}")
    # whisper-medium's training attention (D 64, 16 heads, 4 x 512 tokens
    # and 2 x 4,096 at train_4k: the encoder's full and the decoder's causal
    # self-attention, its cross-attention over as many frames), the served
    # cross shape (a 64-token prompt over 1,500 frames), and qwen2-vl-2b's
    # at train_4k (12 query heads over 2)
    wrows = LONG_TRAIN_BATCH[WHISPER_ARCH]
    vlcfg = get_config(MROPE_ARCH)
    for shape, causal, arch in (
            ((TRAIN_BATCH, wcfg.n_heads, wcfg.n_kv_heads, TRAIN_SEQ,
              TRAIN_SEQ, wcfg.head_dim), True, WHISPER_ARCH),
            ((TRAIN_BATCH, wcfg.n_heads, wcfg.n_kv_heads, TRAIN_SEQ,
              TRAIN_SEQ, wcfg.head_dim), False, WHISPER_ARCH),
            ((WB, wcfg.n_heads, wcfg.n_kv_heads, WP, WF, wcfg.head_dim),
             False, WHISPER_ARCH),
            ((wrows, wcfg.n_heads, wcfg.n_kv_heads, LONG_TRAIN_SEQ,
              LONG_TRAIN_SEQ, wcfg.head_dim), True, WHISPER_ARCH),
            ((wrows, wcfg.n_heads, wcfg.n_kv_heads, LONG_TRAIN_SEQ,
              LONG_TRAIN_SEQ, wcfg.head_dim), False, WHISPER_ARCH),
            ((LONG_TRAIN_BATCH[MROPE_ARCH], vlcfg.n_heads, vlcfg.n_kv_heads,
              LONG_TRAIN_SEQ, LONG_TRAIN_SEQ, vlcfg.head_dim), True,
             MROPE_ARCH)):
        e, rel = check_attention_bwd(*shape, causal, torch.bfloat16)
        errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], e)
        print(f"[train] flash_attention backward {shape} "
              f"{'causal' if causal else 'full'} bf16 ({arch}), "
              f"deterministic: max err {e:.3g}, worst rel L2 {rel:.3g}")

    def check_layernorm_bwd(R, N, dt, offset=0) -> tuple[float, float]:
        """layernorm's forward (with mean and rstd) and backward kernels
        through autograd, with and without gamma and beta, against
        autograd of the plain version: dx as the backward limits say,
        dgamma and dbeta within FP32_GRAD_TOL x max|ref| (fp32) or
        DGAMMA_RTOL (bf16); a second backward gives the same bits.
        Returns (max err, worst bf16 dx rel L2)."""
        x = offset_view(R, N, offset, dt, scale=2.0)
        dy = offset_view(R, N, offset, dt)
        g = 1.0 + offset_view(1, N, offset, scale=0.2)[0]
        bt = offset_view(1, N, offset, scale=0.2)[0]
        worst, worst_rel = 0.0, 0.0
        for gamma, beta in ((g, bt), (g, None), (None, bt), (None, None)):
            runs = []
            for fn in (ref.layernorm_rows, layernorm_rows, layernorm_rows):
                leaves = [None if t is None else t.detach().requires_grad_()
                          for t in (x, gamma, beta)]
                fn(*leaves).backward(dy)
                runs.append([None if t is None else t.grad for t in leaves])
            torch.cuda.synchronize()
            want, got, again = runs
            what = (f"layernorm backward {R}x{N} {str(dt)[6:]} offset "
                    f"{offset}{' +gamma' if gamma is not None else ''}"
                    f"{' +beta' if beta is not None else ''}")
            require(all(a is None or torch.equal(a, b)
                        for a, b in zip(got, again)),
                    f"{what}: two backward runs differ")
            worst = max(worst, grad_close(f"{what} dx", got[0], want[0], dt))
            if dt == torch.bfloat16:
                worst_rel = max(worst_rel, rel_l2(got[0], want[0]))
            for name, k, w in zip(("dgamma", "dbeta"), got[1:], want[1:]):
                if k is not None:
                    worst = max(worst, grad_close(f"{what} {name}", k, w, dt,
                                                  DGAMMA_RTOL))
        return worst, worst_rel

    for R, N in SFU_SHAPES:
        errs["layernorm_bwd"] = max(errs["layernorm_bwd"], check_layernorm_bwd(
            R, N, torch.float32)[0])
    for R, N, offset in LN_BWD_ROWS + LN_ODD:
        for dt in (torch.float32, torch.bfloat16):
            e, rel = check_layernorm_bwd(R, N, dt, offset)
            errs["layernorm_bwd"] = max(errs["layernorm_bwd"], e)
            print(f"[train] layernorm backward {R}x{N} {str(dt)[6:]} offset "
                  f"{offset}, +-gamma +-beta, deterministic: max err {e:.3g}"
                  + (f", dx rel L2 {rel:.3g}" if rel else ""))
    print(f"[train] layernorm backward over the reference's SFU rows (fp32) "
          f"and the rows above: max err {errs['layernorm_bwd']:.3g} (fp32 "
          f"limit {FP32_GRAD_TOL} x max|ref|; bf16 dx rel L2 "
          f"{BF16_GRAD_RTOL}, dgamma and dbeta {DGAMMA_RTOL})")

    def check_ssd_bwd(B, S, H, P, G, N, chunk, dt) -> tuple[float, float]:
        """``ssd`` under autograd on the card (the forward kernels keeping
        their scratch, then the backward kernels) against autograd of
        ``ref.ssd_plain``: from zero (y's gradient alone) and from an
        initial state with a gradient into the final state; dx, da, db, dc
        and the initial state's gradient fp32 within FP32_GRAD_TOL x
        max|ref|, bf16 by relative L2 within BF16_GRAD_RTOL; the backward
        kernels twice on the saved scratch give the same bits.  Returns
        (max err, worst relative L2)."""
        x, a, b, c = ssd_inputs(B, S, H, P, G, N, dt)
        dy = randn(B, S, H, P, dtype=dt)
        worst, worst_rel = 0.0, 0.0
        for init in (None, randn(B, H, P, N)):
            dfin = None if init is None else randn(B, H, P, N)
            grads = []
            for fn in (ref.ssd_plain, ssd):
                leaves = [None if t is None else t.detach().requires_grad_()
                          for t in (x, a, b, c, init)]
                y, fin = fn(*leaves[:4], chunk=chunk, initial_state=leaves[4])
                torch.autograd.backward(
                    [y] if init is None else [y, fin],
                    [dy] if init is None else [dy, dfin])
                grads.append([None if t is None else t.grad for t in leaves])
            _, _, states = ssd_states(x, a, b, c, chunk=chunk,
                                      initial_state=init)
            runs = [ssd_bwd(x, a, b, c, dy, chunk=chunk, initial_state=init,
                            dfinal=dfin, states=states) for _ in range(2)]
            torch.cuda.synchronize()
            what = (f"ssd backward {(B, S, H, P, G, N)} chunk {chunk} "
                    f"{str(dt)[6:]} init={init is not None}")
            require(all(u is None or torch.equal(u, v)
                        for u, v in zip(*runs)),
                    f"{what}: two backward runs differ")
            require(all(u is None or torch.equal(u, k) for u, k in
                        zip(runs[0], grads[1])),
                    f"{what}: autograd's gradients are not the kernels'")
            for name, k, w in zip(("dx", "da", "db", "dc", "dinit"),
                                  grads[1], grads[0]):
                if w is None:
                    continue
                worst = max(worst, grad_close(f"{what} {name}", k, w,
                                              k.dtype))
                worst_rel = max(worst_rel, rel_l2(k, w))
        return worst, worst_rel

    # the reference's SSD sweep (fp32 and bf16), its tail case and G > 1
    # with a tail; mamba2-2.7b's training shape, its train_4k shape (the
    # long-context phase's) and jamba's 256 heads (bf16)
    wide_ssd = [(*ssm_prefill, 128, torch.bfloat16),
                (*ssm_prefill, 128, torch.float32),
                (LONG_TRAIN_BATCH[SSM_ARCH], LONG_TRAIN_SEQ, *heads, 128,
                 torch.bfloat16),
                (*jamba_prefill, 128, torch.bfloat16)]
    for *shape, chunk, dt in ([(*sh, dt) for sh in SSD_SHAPES
                               for dt in (torch.float32, torch.bfloat16)]
                              + wide_ssd):
        e, rel = check_ssd_bwd(*shape, chunk, dt)
        errs["ssd_bwd"] = max(errs["ssd_bwd"], e)
        print(f"[train] ssd backward {tuple(shape)} chunk {chunk} "
              f"{str(dt)[6:]}, from zero and from an initial state with "
              f"dfinal, deterministic: max err {e:.3g}, worst rel L2 "
              f"{rel:.3g} (fp32 limit {FP32_GRAD_TOL} x max|ref|, bf16 rel "
              f"L2 {BF16_GRAD_RTOL})")

    # (b) model gradients, kernels against plain versions, same weights and
    # batch: fp32 over the first layers, bf16 over the training cut
    cut_note = (f"cut: {TRAIN_LAYERS} of {get_config(TRAIN_ARCH).n_layers} "
                f"layers, full width")
    train_batch = for_arch(train_cfg, TRAIN_SEQ, TRAIN_BATCH,
                           seed=0).device_batch(0, dev)

    def model_grads(mcfg, params, batch=None, pin=False):
        """(loss, [gradient of each leaf]) of the kernels and of the plain
        versions (``lm.loss_fn``, or ``encdec.loss_fn`` with the batch's
        frames), the plain versions run first; and the MoE layers' routes,
        the kernels' own against the plain versions' (``route_diffs``;
        None without MoE), and the plain run's routes.  With ``pin`` each
        MoE call of the kernels' run dispatches by the plain run's choices
        of its layer (``moe_calls(pin=)``), the routes compared being those
        its own router would have chosen."""
        batch = train_batch if batch is None else batch
        leaves = T.leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        out, calls = {}, {}
        for plain in (True, False):
            with moe_calls(None if plain or not pin else calls[True]
                           ) as calls[plain]:
                if mcfg.is_encdec:
                    loss = encdec.loss_fn(mcfg, params, batch["frames"],
                                          batch["tokens"], batch["labels"],
                                          plain=plain)
                else:
                    loss = lm.loss_fn(mcfg, params, batch["tokens"],
                                      batch["labels"], plain=plain)
                out[plain] = (float(loss.detach()),
                              torch.autograd.grad(loss, leaves))
        torch.cuda.synchronize()
        routes = route_diffs(calls[False], calls[True]) if calls[True] \
            else None
        return out[False], out[True], routes, calls[True]

    @contextlib.contextmanager
    def plain_ops(names):
        """The model's ``kernels.ops`` entries ``names`` on their plain
        versions while open, the other kernels as they are."""
        saved = {n: getattr(ops, n) for n in names}
        for n, fn in saved.items():
            setattr(ops, n, lambda *a, fn=fn, **k: fn(*a, **(k | {
                "plain": True})))
        try:
            yield
        finally:
            for n, fn in saved.items():
                setattr(ops, n, fn)

    def grad_rel(ga, gb) -> float:
        """The whole flattened gradient ``ga``'s relative L2 against
        ``gb`` (a leaf of ``gb`` may lie on the host)."""
        diff = norm = 0.0
        for a, b in zip(ga, gb):
            b = b.to(a.device).float()
            diff += float((a.float() - b).square().sum())
            norm += float(b.square().sum())
        return (diff / norm) ** 0.5

    def kernel_families(mcfg):
        """The ``kernels.ops`` families on ``mcfg``'s path."""
        return ([("attention",)] if any(p.mixer == "attn"
                                        for p in mcfg.pattern) else []) \
            + [("rmsnorm", "layernorm")] \
            + ([("ssd",)] if any(p.mixer == "ssm" for p in mcfg.pattern)
               else [])

    def fp32_grad_check(mcfg, params, label, batch=None):
        """Every leaf's max |kernels - plain| within MODEL_FP32_TOL x
        max|g| (fp32 compute); MoE routes free, each differing decision
        within FP32_ROUTE_MARGIN of a tie."""
        (lk, gk), (lp, gp), routes, _ = model_grads(mcfg, params, batch)
        worst = max(((max_err(a, b) / max(float(b.abs().max()), 1e-30),
                      path) for (path, _), a, b in zip(
                          T.leaves_with_paths(params), gk, gp)),
                    key=lambda t: t[0])
        print(f"[train] fp32 {label} gradients of loss_fn on {TRAIN_BATCH}x"
              f"{TRAIN_SEQ} tokens, kernels vs plain versions: loss "
              f"{lk:.6f} vs {lp:.6f}; worst leaf {worst[1]} max |err| "
              f"{worst[0]:.3g} x max|g| (limit {MODEL_FP32_TOL}) over "
              f"{len(gk)} leaves")
        hold_routes(f"fp32 {label} gradients, routes free", routes,
                    FP32_ROUTE_MARGIN)
        require(worst[0] <= MODEL_FP32_TOL,
                f"fp32 model gradients of {label}: {worst[1]} differs "
                f"{worst[0]} x max|g|")

    def bf16_grad_check(mcfg, params, label, batch=None, attribute=False):
        """The whole flattened gradient's relative L2, kernels against plain
        versions, within MODEL_BF16_RTOL (bf16 compute); every leaf's
        printed, a line a layer.  MoE calls pinned to the plain path's
        routes, the decisions the kernels' own router would have made held
        by ``hold_moe_routes``.  With ``attribute``, the gradient again
        with each kernel family on its plain version in turn (the rest on
        the kernels, the same routes), and both paths' against an fp32
        gradient of the same weights, batch and routes (printed)."""
        batch = train_batch if batch is None else batch
        tokens, labels = batch["tokens"], batch["labels"]
        leaves = T.leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        moe = any(p.ffn == "moe" for p in mcfg.pattern)
        vs32, pin, _ = routes_vs_fp32(mcfg, params, tokens, pinned=True) \
            if moe else (None, None, None)
        if attribute:   # on the host while the bf16 gradients are taken
            with moe_calls(pin):
                g32 = [g.cpu() for g in torch.autograd.grad(lm.loss_fn(
                    dataclasses.replace(mcfg, compute_dtype="float32"),
                    params, tokens, labels, plain=True), leaves)]
        (lk, gk), (lp, gp), routes, own = model_grads(mcfg, params, batch,
                                                      pin=True)
        if moe:
            require(all(torch.equal(a.idx, b.idx) and torch.equal(a.pos, b.pos)
                        for a, b in zip(own, pin)),
                    f"{label}: the plain path's routes differ between two "
                    f"passes")
        paths = [path for path, _ in T.leaves_with_paths(params)]
        total = grad_rel(gk, gp)
        per_layer = {}
        for path, a, b in zip(paths, gk, gp):
            parts = path.split("/")
            key = "/".join(parts[:2]) if parts[0] in ("layers", "encoder",
                                                      "decoder") else "ends"
            per_layer.setdefault(key, []).append(
                (path[len(key) + 1:] if key != "ends" else path,
                 rel_l2(a, b)))
        for key, items in per_layer.items():
            print(f"[train] bf16 {mcfg.name} gradient rel L2, {key}: "
                  + ", ".join(f"{n} {e:.3g}" for n, e in items))
        print(f"[train] bf16 {label} gradients of loss_fn, kernels vs "
              f"plain versions{', MoE routes pinned' if routes else ''}: "
              f"loss {lk:.6f} vs {lp:.6f}; the whole flattened gradient "
              f"rel L2 {total:.4g} (limit {MODEL_BF16_RTOL})")
        if attribute:
            near = {"the kernels": grad_rel(gk, g32),
                    "the plain versions": grad_rel(gp, g32)}
            del gk, g32
            one_plain = {}
            for fam in kernel_families(mcfg):
                with plain_ops(fam), moe_calls(own):
                    ga = torch.autograd.grad(lm.loss_fn(mcfg, params, tokens,
                                                        labels), leaves)
                one_plain["/".join(fam)] = grad_rel(ga, gp)
                del ga
            print(f"[train] bf16 {label} gradients, the same routes: the "
                  f"whole gradient's rel L2 against the plain versions' with "
                  f"one kernel family on its plain version (the rest on the "
                  f"kernels): " + ", ".join(f"{k} {v:.4g}" for k, v in
                                            one_plain.items())
                  + "; against an fp32 gradient (plain versions, the same "
                  "weights, batch and routes): " + ", ".join(
                      f"{k} {v:.4g}" for k, v in near.items()))
        if moe:
            hold_moe_routes(f"bf16 {label} gradients, the kernels' own "
                            f"routes", mcfg, routes, vs32)
        require(total <= MODEL_BF16_RTOL,
                f"bf16 model gradients of {label} differ by {total}")

    cfg32 = dataclasses.replace(train_cfg, n_layers=MODEL_FP32_LAYERS,
                                compute_dtype="float32")
    p32 = lm.init(cfg32, torch.Generator(device=dev).manual_seed(0), dev)
    fp32_grad_check(cfg32, p32, f"{TRAIN_ARCH} [{MODEL_FP32_LAYERS} layers, "
                    f"full width]")
    del p32
    p8 = lm.init(train_cfg, torch.Generator(device=dev).manual_seed(0), dev)
    bf16_grad_check(train_cfg, p8, f"{TRAIN_ARCH} [{cut_note}]")
    del p8
    torch.cuda.empty_cache()

    def depth_cut(arch, n):
        """``arch`` at full width cut to n layers (whisper: n encoder and n
        decoder layers), and the cut's note."""
        full = get_config(arch)
        cut = {"n_layers": n} | ({"encoder_layers": n} if full.is_encdec
                                 else {})
        depth = (f"{n} + {n} of {full.encoder_layers} + {full.n_layers}"
                 if full.is_encdec else f"{n} of {full.n_layers}")
        return dataclasses.replace(full, **cut), (f"cut: {depth} layers, "
                                                 f"full width")

    # whisper-medium (layernorm and attention backwards, frames from the
    # batch), mamba2-2.7b (ssd and rmsnorm backwards) and nemotron-4-15b
    # (layernorm at 6144), kernels against plain versions on the same
    # weights (seed 0) and SyntheticLM batch
    for arch, n32, n16 in MODEL_GRAD_CUTS:
        batch = for_arch(get_config(arch), TRAIN_SEQ, TRAIN_BATCH,
                         seed=0).device_batch(0, dev)
        model = encdec if get_config(arch).is_encdec else lm
        if n32:
            mcfg, note = depth_cut(arch, n32)
            mcfg = dataclasses.replace(mcfg, compute_dtype="float32")
            params = model.init(mcfg, torch.Generator(device=dev
                                                      ).manual_seed(0), dev)
            fp32_grad_check(mcfg, params, f"{arch} [{note}]", batch)
            del params
            torch.cuda.empty_cache()
        mcfg, note = depth_cut(arch, n16)
        params = model.init(mcfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
        bf16_grad_check(mcfg, params, f"{arch} [{note}]", batch)
        del params, batch
        torch.cuda.empty_cache()

    # (c) train with Trainer: the main path of this phase, counted from 0
    def chip_trainer(tcfg, peak_lr=TRAIN_PEAK_LR, steps=TRAIN_STEPS,
                     **options):
        """``Trainer`` on ``tcfg`` for ``steps`` steps of TRAIN_BATCH x
        TRAIN_SEQ tokens from SyntheticLM seed 0, AdamW at ``peak_lr``
        with the config's moments, no checkpoint unless ``options`` says."""
        return Trainer(
            tcfg, ShapeSpec("chip", TRAIN_SEQ, TRAIN_BATCH, "train"),
            opt=OptConfig(peak_lr=peak_lr, warmup_steps=TRAIN_WARMUP,
                          total_steps=steps),
            options=TrainOptions(**{"steps": steps, "ckpt_every": 0,
                                    "log_every": 1} | options),
            seed=0, device=dev)

    def train_run(tcfg, note, per_step, why, inspect=None,
                  peak_lr=TRAIN_PEAK_LR, steps=TRAIN_STEPS, profile=True):
        """``Trainer`` on ``tcfg`` for ``steps`` steps of TRAIN_BATCH x
        TRAIN_SEQ tokens from SyntheticLM seed 0 at ``peak_lr`` (fp32
        parameters, the config's moments, bf16 compute and remat), counted
        from zero: the
        launches must be ``per_step`` a step and the mean loss of the
        last 3 steps below the first's; prints the losses, the peak
        device memory against its prediction, ``inspect(params,
        trainer)`` on the trained state, then the step's host ms,
        tokens/s and, with ``profile``, one profiled step.  Returns (the
        losses, the peak)."""
        expected = dict.fromkeys(counters, 0) | {
            k: steps * n for k, n in per_step.items()}
        print(f"[train] {tcfg.name} [{note}] expected launches a step: "
              f"{why}; x {steps} steps; the other kernels 0")
        msize = torch.empty((), dtype=getattr(torch, tcfg.moment_dtype)
                            ).element_size()
        n_par = tcfg.param_count()
        state_gb = n_par * (8 + 2 * msize) / 1e9
        logits_gb = 2 * TRAIN_BATCH * TRAIN_SEQ * tcfg.vocab_size * 4 / 1e9
        leaf = max(tcfg.vocab_size * tcfg.d_model,
                   tcfg.n_experts * tcfg.d_model * tcfg.d_ff)
        layer = max(dataclasses.replace(tcfg, pattern=(p,), n_layers=1
                                        ).param_count()
                    - 2 * tcfg.vocab_size * tcfg.d_model - tcfg.d_model
                    for p in tcfg.pattern)
        temps_gb = (4 * leaf + 24 * min(leaf, adamw.SLICE)
                    + 4 * layer) / 1e9
        print(f"[train] {tcfg.name} [{note}] predicted peak: "
              f"{n_par / 1e9:.4f} B parameters x {8 + 2 * msize} bytes (fp32 "
              f"parameter and gradient, two {tcfg.moment_dtype} moments) = "
              f"{state_gb:.2f} GB, + {logits_gb:.2f} GB of fp32 logits and "
              f"their gradient, + up to {temps_gb:.2f} GB of temporaries "
              f"(the clip norm's square of the largest leaf, {leaf / 1e9:.3f}"
              f" B elements, AdamW's six on at most {adamw.SLICE:,} "
              f"elements, the largest layer's bf16 weight copies and their "
              f"gradients): {state_gb + logits_gb:.2f}-"
              f"{state_gb + logits_gb + temps_gb:.2f} GB")
        trainer = chip_trainer(tcfg, peak_lr, steps)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        params, opt_state = trainer.run(resume=False)
        torch.cuda.synchronize()
        ran = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        print(f"[train] {tcfg.name} launches over {steps} steps: {ran}")
        require(ran == expected, f"{tcfg.name} training launches {ran} "
                f"differ from {expected}")
        for k, n in ran.items():
            launches[k] += n
        losses = [m["loss"] for m in trainer.metrics_log]
        require(len(losses) == steps and all(np.isfinite(losses))
                and np.mean(losses[-3:]) < losses[0],
                f"{tcfg.name} training loss did not fall: {losses}")
        dts = sorted(m["dt"] for m in trainer.metrics_log[1:])
        step_ms = 1e3 * dts[len(dts) // 2]
        tok = TRAIN_BATCH * TRAIN_SEQ
        print(f"[train] {tcfg.name} [{note}; fp32 parameters, "
              f"{tcfg.moment_dtype} moments, {tcfg.compute_dtype} compute, "
              f"remat {tcfg.remat}] "
              f"{steps} steps of {TRAIN_BATCH}x{TRAIN_SEQ}, AdamW peak "
              f"lr {peak_lr} after {TRAIN_WARMUP} warm-up steps: "
              f"losses " + ", ".join(f"{x:.4f}" for x in losses)
              + f"; mean of the last 3 {np.mean(losses[-3:]):.4f} < first "
              f"{losses[0]:.4f}")
        print(f"[train] {tcfg.name} step host ms (host clock around the "
              f"step's loss read, steps 1-{steps - 1}): median "
              f"{step_ms:.2f}, least {1e3 * dts[0]:.2f}, most "
              f"{1e3 * dts[-1]:.2f}; {tok / (step_ms / 1e3):,.0f} tokens/s "
              f"at the median [{note}] on {smi}")
        print(f"[train] {tcfg.name} [{note}] device memory: "
              f"{base / 2**30:.2f} GiB before, peak {peak / 2**30:.2f} GiB "
              f"({peak / 1e9:.2f} GB; predicted {state_gb + logits_gb:.2f}-"
              f"{state_gb + logits_gb + temps_gb:.2f} GB) over the run, "
              f"max_memory_allocated, on {smi}")
        require(peak < CARD_TRAIN_GB * 1e9, f"{tcfg.name} training peak "
                f"{peak / 1e9:.2f} GB (limit {CARD_TRAIN_GB} GB)")
        if inspect is not None:
            inspect(params, trainer)
        if profile:
            nxt = trainer.data.device_batch(steps, dev)
            step_s = host_s(lambda: trainer.step_fn(params, opt_state, nxt))
            device_profile(f"{tcfg.name} [{note}] train step {TRAIN_BATCH}x"
                           f"{TRAIN_SEQ} on {smi}",
                           lambda: trainer.step_fn(params, opt_state, nxt),
                           step_s)
            del nxt
        del trainer, params, opt_state
        torch.cuda.empty_cache()
        return losses, peak

    train_run(train_cfg, cut_note, *train_launches(train_cfg))
    # the same run at AdamW's default peak lr, printed beside the checked
    # run and not checked: the reason for TRAIN_PEAK_LR
    slow = Trainer(
        train_cfg, ShapeSpec("chip", TRAIN_SEQ, TRAIN_BATCH, "train"),
        opt=OptConfig(warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS),
        options=TrainOptions(steps=TRAIN_STEPS, ckpt_every=0,
                             log_every=TRAIN_STEPS), seed=0, device=dev)
    slow.run(resume=False)
    slow_losses = [m["loss"] for m in slow.metrics_log]
    print(f"[train] the same run at AdamW's default peak lr "
          f"{OptConfig().peak_lr} (printed, not checked): losses "
          + ", ".join(f"{x:.4f}" for x in slow_losses)
          + f"; mean of the last 3 {np.mean(slow_losses[-3:]):.4f}, first "
          f"{slow_losses[0]:.4f}")
    del slow
    torch.cuda.empty_cache()
    # whisper-medium and mamba2-2.7b at full width and depth, one at a time
    for arch in FULL_TRAIN_ARCHS:
        tcfg = get_config(arch)
        depth = (f"{tcfg.encoder_layers} + {tcfg.n_layers}"
                 if tcfg.is_encdec else f"{tcfg.n_layers}")
        note = f"full width and depth, {depth} layers"
        train_run(tcfg, note, *train_launches(tcfg))
    # the other dense archs at full width (DENSE_TRAIN_CUTS), one at a time
    for arch in DENSE_TRAIN_ARCHS:
        full = get_config(arch)
        n = DENSE_TRAIN_CUTS.get(arch, full.n_layers)
        tcfg = dataclasses.replace(full, n_layers=n)
        note = (f"cut: {n} of {full.n_layers} layers, full width"
                if n < full.n_layers else
                f"full width and depth, {n} layers")
        train_run(tcfg, note, *train_launches(tcfg), profile=False)

    # (d) the MoE archs at full width (MOE_TRAIN_CUTS), one cut at a time,
    # each state drawn once and freed before the next: bf16 model
    # gradients with the routes pinned, fp32 ones with the routes free,
    # Trainer, C.6 on the trained and on the initial weights; dbrx again
    # with a fault
    def moe_train_cfg(arch):
        """``arch`` cut as MOE_TRAIN_CUTS says (a cut below one block keeps
        the first pattern positions), and the cut's note."""
        full = get_config(arch)
        cut = MOE_TRAIN_CUTS[arch]
        n = cut["n_layers"]
        cfg = dataclasses.replace(full, **cut, pattern=full.pattern[:n])
        kinds = "; ".join(f"{p.mixer}+{p.ffn}" for p in cfg.pattern)
        return cfg, ("cut: " + ", ".join(
            f"{k} {v} of {getattr(full, k)}" for k, v in cut.items())
            + f" (layers {kinds}), full width, top-{cfg.top_k}")

    def first_moe_fp32(mcfg):
        """fp32 compute over ``mcfg``'s layers up to its first MoE layer,
        its experts halved while the parameters and two gradients in fp32
        would pass MOE_FP32_GIB; and what was taken."""
        n = 1 + next(i for i, p in enumerate(mcfg.pattern) if p.ffn == "moe")
        cfg32 = dataclasses.replace(mcfg, n_layers=n,
                                    pattern=mcfg.pattern[:n],
                                    compute_dtype="float32")
        while 12 * cfg32.param_count() > MOE_FP32_GIB * 2**30:
            cfg32 = dataclasses.replace(cfg32,
                                        n_experts=cfg32.n_experts // 2)
        return cfg32, (f"fp32 check: the first {n} layers, "
                       f"{cfg32.n_experts} of {mcfg.n_experts} experts, "
                       f"parameters and two gradients "
                       f"{12 * cfg32.param_count() / 2**30:.2f} GiB (limit "
                       f"{MOE_FP32_GIB})")

    def c6_routes(tcfg, params, batch, label, attribute=False) -> float:
        """C.6: ``batch`` through ``lm.forward`` in bf16 on the kernels
        (their own routes) and on the plain versions: the decisions that
        differ by MoE layer, their margins and the logits' relative L2,
        held as the pinned gradients' routes are (``hold_moe_routes``,
        against an fp32 evaluation unpinned).  With ``attribute``, the MoE
        inputs' drift again with each kernel family on its plain version.
        Returns the kernels' loss on ``batch``."""
        tokens = batch["tokens"]
        vs32, _, _ = routes_vs_fp32(tcfg, params, tokens, pinned=False)
        logits, calls = {}, {}
        with torch.no_grad():
            for plain in (True, False):
                with moe_calls() as calls[plain]:
                    logits[plain], _ = lm.forward(tcfg, params, tokens,
                                                  plain=plain)
            rel = rel_l2(logits[False], logits[True])
            del logits
            drift = {}
            for fam in kernel_families(tcfg) if attribute else ():
                with plain_ops(fam), moe_calls() as part:
                    lm.forward(tcfg, params, tokens)
                drift["/".join(fam)] = [float(f"{x:.3g}") for x in
                                        route_diffs(part, calls[True])[
                                            "drift"]]
            loss = float(lm.loss_fn(tcfg, params, tokens, batch["labels"]))
        print(f"[C.6] {label}: logits of the kernels (their own routes) vs "
              f"the plain versions rel L2 {rel:.4g}"
              + (f"; MoE input rel L2 with one family on its plain version "
                 f"(the rest on the kernels): {drift}" if drift else ""))
        hold_moe_routes(f"C.6 {label}", tcfg,
                        route_diffs(calls[False], calls[True]), vs32)
        return loss

    def moe_fault_run(tcfg, note, clean, clean_peak):
        """``tcfg`` trained as ``train_run`` trains it with a fault injected
        at FAULT_AT and no checkpoint: the fault path draws the state
        anew and replays from step 0; every loss, before the fault and
        replayed, within FAULT_RTOL of the uninterrupted run's, and the
        peak within 1 GiB of that run's."""
        with tempfile.TemporaryDirectory() as tmp:
            trainer = chip_trainer(tcfg, ckpt_dir=tmp, fail_at_step=FAULT_AT,
                                   log_every=TRAIN_STEPS)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            trainer.run(resume=False)
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        log = [(m["step"], m["loss"]) for m in trainer.metrics_log]
        steps = [s for s, _ in log]
        worst = max(abs(x - clean[s]) / abs(clean[s]) for s, x in log)
        print(f"[train] {tcfg.name} [{note}] again with a fault at step "
              f"{FAULT_AT} and no checkpoint: {trainer.failures} failure, "
              f"steps {steps[:FAULT_AT]} then replayed {steps[FAULT_AT:]}; "
              f"worst loss rel diff to the uninterrupted run {worst:.3g} "
              f"(limit {FAULT_RTOL}); peak {peak / 2**30:.2f} GiB against "
              f"{clean_peak / 2**30:.2f} uninterrupted (limit + 1 GiB)")
        require(trainer.failures == 1 and steps == list(range(FAULT_AT))
                + list(range(TRAIN_STEPS)) and worst <= FAULT_RTOL
                and peak <= clean_peak + 2**30,
                f"{tcfg.name} fault replay: {log} vs {clean}, peak {peak}")
        del trainer
        torch.cuda.empty_cache()

    for arch in MOE_TRAIN_CUTS:
        mcfg, note = moe_train_cfg(arch)
        data = for_arch(mcfg, TRAIN_SEQ, TRAIN_BATCH, seed=0)
        batch = data.device_batch(0, dev)
        params = lm.init(mcfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
        bf16_grad_check(mcfg, params, f"{arch} [{note}]", batch,
                        attribute=True)
        del params
        torch.cuda.empty_cache()
        cfg32, taken = first_moe_fp32(mcfg)
        params = lm.init(cfg32, torch.Generator(device=dev).manual_seed(0),
                         dev)
        fp32_grad_check(cfg32, params, f"{arch} [{note}; {taken}]", batch)
        del params, batch
        torch.cuda.empty_cache()
        # the step-TRAIN_STEPS batch, which no step trains on: C.6's input
        # and the held-out loss, whose fall from the initial weights to
        # the trained ones no batch-to-batch spread blurs
        steps = MOE_TRAIN_STEPS.get(arch, TRAIN_STEPS)
        late, held = data.device_batch(steps, dev), {}
        lr = MOE_TRAIN_PEAK_LR.get(arch, TRAIN_PEAK_LR)
        losses, peak = train_run(
            mcfg, note, *train_launches(mcfg),
            inspect=lambda params, _: held.__setitem__("trained", c6_routes(
                mcfg, params, late, f"{arch} [{note}] after {steps} "
                f"steps at peak lr {lr}, on the step-{steps} batch")),
            peak_lr=lr, steps=steps)
        params = lm.init(mcfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
        held["initial"] = c6_routes(mcfg, params, late, f"{arch} [{note}] "
                                    f"the initial weights, on the "
                                    f"step-{steps} batch",
                                    attribute=True)
        del params
        torch.cuda.empty_cache()
        diffs = np.diff(losses)
        swing, spread = float(np.abs(diffs).max()), float(np.std(diffs))
        fall = held["initial"] - held["trained"]
        limit = HELD_OUT_SPREADS if arch in MOE_TRAIN_STEPS else 0.0
        print(f"[train] {arch} [{note}] loss on the held-out "
              f"step-{steps} batch (the kernels, bf16): initial weights "
              f"{held['initial']:.4f}, after {steps} steps at peak lr "
              f"{lr} {held['trained']:.4f}, a fall of {fall:.4f} (the "
              f"training steps' losses, each on its own batch, move by up "
              f"to {swing:.4f} from one step to the next, standard "
              f"deviation {spread:.4f}: the fall is {fall / spread:.2f} of "
              f"it, limit {limit})")
        require(fall > limit * spread,
                f"{arch}: the held-out loss did not fall by {limit} times "
                f"the step-to-step spread: {held}, spread {spread}")
        if lr != TRAIN_PEAK_LR:   # printed, not checked: the reason for lr
            side = chip_trainer(mcfg, log_every=TRAIN_STEPS)
            params = side.run(resume=False)[0]    # its moments freed here
            with torch.no_grad():
                after = float(lm.loss_fn(mcfg, params, late["tokens"],
                                         late["labels"]))
            print(f"[train] {arch} [{note}] the same run for {TRAIN_STEPS} "
                  f"steps at peak lr "
                  f"{TRAIN_PEAK_LR} (printed, not checked: the reason for "
                  f"MOE_TRAIN_PEAK_LR): losses " + ", ".join(
                      f"{m['loss']:.4f}" for m in side.metrics_log)
                  + f"; loss on the held-out step-{steps} batch "
                  f"{held['initial']:.4f} -> {after:.4f}")
            del side, params
        del late
        torch.cuda.empty_cache()
        if arch == MOE_FAULT_ARCH:
            moe_fault_run(mcfg, note, dict(enumerate(losses)), peak)

    # (e) the remat policies on qwen3-4b's training cut: one step's
    # gradients each, equal to "nothing"'s to the bit (the kernels and the
    # products are deterministic)
    want = None
    for policy in ("nothing", "dots", "dots_nb"):
        pcfg = dataclasses.replace(train_cfg, remat_policy=policy)
        params = lm.init(pcfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
        leaves = T.leaves(params)
        for t in leaves:
            t.requires_grad_(True)

        def step():
            return torch.autograd.grad(lm.loss_fn(
                pcfg, params, train_batch["tokens"], train_batch["labels"]),
                leaves)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        grads = step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        want = grads if want is None else want
        same = all(torch.equal(a, b) for a, b in zip(grads, want))
        del grads
        ms = 1e3 * host_s(step)
        print(f"[train] remat_policy {policy!r}, {TRAIN_ARCH} [{cut_note}], "
              f"one step's loss and gradients on {TRAIN_BATCH}x{TRAIN_SEQ} "
              f"tokens: host ms {ms:.2f} (the least of three after a "
              f"warm-up), peak {(peak - base) / 2**30:.2f} GiB above the "
              f"{base / 2**30:.2f} held before it (the parameters and, "
              f"after the first policy, \"nothing\"'s gradients); gradients "
              f"equal to \"nothing\"'s to the bit: {same}; on {smi}")
        require(same, f"remat_policy {policy!r}: gradients differ from "
                f"\"nothing\"'s")
        del params, leaves, step
    del want
    torch.cuda.empty_cache()

    # (f) fault and resume on the card: reduced qwen3-4b and dbrx-132b
    for farch in (TRAIN_ARCH, MOE_FAULT_ARCH):
        fcfg = get_config(farch, reduced=True)
        runs = []
        with tempfile.TemporaryDirectory() as tmp:
            for fail in (-1, FAULT_AT):
                ftr = Trainer(fcfg, ShapeSpec("fault", 64, 8, "train"),
                              device=dev, options=TrainOptions(
                                  steps=FAULT_STEPS, ckpt_every=5,
                                  ckpt_dir=f"{tmp}/run{fail}",
                                  fail_at_step=fail, log_every=1000))
                ftr.run()
                runs.append((ftr.failures,
                             {m["step"]: m["loss"] for m in ftr.metrics_log}))
        (f0, clean), (f1, resumed) = runs
        worst = max(abs(resumed[s] - clean[s]) / abs(clean[s])
                    for s in clean)
        print(f"[train] fault and resume, {fcfg.name} on the card: a fault "
              f"at step {FAULT_AT}, resumed from step 5's checkpoint; losses "
              f"of steps 0-{FAULT_STEPS - 1} vs an uninterrupted run: worst "
              f"rel diff {worst:.3g} (limit {FAULT_RTOL}); failures {f1}")
        require(f0 == 0 and f1 == 1 and clean.keys() == resumed.keys()
                == set(range(FAULT_STEPS)) and worst <= FAULT_RTOL,
                f"fault and resume of {fcfg.name}: failures {f0}/{f1}, "
                f"losses {clean} vs {resumed}")

    # ---------------------------------------------------------------- mesh
    mark("mesh")
    mesh_phase(counters, launches, zero_counts, smi)

    # ------------------------------------------------------------ examples
    mark("examples")
    examples_phase(counters, launches, zero_counts, smi)

    # -------------------------------------------------------- long context
    mark("long context")
    long_phase(counters, launches, zero_counts, smi)

    # -------------------------------------------------------------- timing
    mark("timing")
    bert = paper_models.get("BERT-L")
    t0 = time.perf_counter()
    res = DoraCompiler().compile(bert, CompileOptions(engine="list"))
    compile_s = time.perf_counter() - t0
    DoraCompiler().execute(res, inputs["BERT-L"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    DoraCompiler().execute(res, inputs["BERT-L"])
    torch.cuda.synchronize()
    execute_s = time.perf_counter() - t0
    print(f"[time] BERT-L on {kind} ({smi}): compile {compile_s} s "
          f"(host), execute {execute_s} s (host clock around "
          f"synchronize, after one warm-up run), "
          f"{bert.total_flops / execute_s / 1e12:.4f} TFLOP/s")
    # where BERT-L's execute time goes
    device_profile("BERT-L execute",
                   lambda: DoraCompiler().execute(res, inputs["BERT-L"]),
                   execute_s)
    # the multi-tenant runs: compile seconds, host time of an execute (the
    # least of three after a warm-up) and its device time
    for label, (mres, mcompile_s) in mt_runs.items():
        run = lambda: DoraCompiler().execute(  # noqa: E731
            mres, mt_inputs[label])
        mhost_s = host_s(run)
        print(f"[time] {label} ({tenants(label, mres)}) on {smi}: compile "
              f"{mcompile_s:.4f} s"
              f"{' (the whole mesh)' if '/pe' in label else ''}"
              f"{' (interleave_stream of the joint binary)' if label.endswith(('/rr', '/priority')) else ''}, "
              f"execute {mhost_s * 1e3:.4f} ms (host), "
              f"{len(mres.codegen.program)} instructions, "
              f"{mres.graph.total_flops / 1e9:.4f} GFLOP")
        device_profile(f"{label} execute", run, mhost_s)

    # flex_gemm at the BERT-L tile shape that carries the most FLOPs
    tile_flops = {}
    for i in res.codegen.program.instructions:
        b = i.body
        if i.op_type == OpType.MMU_GEMM and b.ping_op == 1:
            key = (b.bound_i, b.bound_k, b.bound_j, b.accumulate)
            tile_flops[key] = tile_flops.get(key, 0) \
                + 2 * b.bound_i * b.bound_k * b.bound_j
    M, K, N, acc = max(tile_flops, key=tile_flops.get)
    a, b, c = randn(M, K), randn(K, N), randn(M, N)
    cin = c if acc else None
    x_sm, x_ln, x_act = randn(512, 512, scale=3.0), randn(512, 768), \
        randn(3072, 4096)
    # the serving kernels at qwen3-4b's shapes (bf16)
    x_rms = randn(2 * 1024, cfg.d_model, dtype=torch.bfloat16)
    g_rms = randn(cfg.d_model)
    g_lib = g_rms.to(torch.bfloat16)
    qp = randn(B, cfg.n_heads, plen, cfg.head_dim, dtype=torch.bfloat16)
    kp, vp = (randn(B, cfg.n_kv_heads, plen, cfg.head_dim,
                    dtype=torch.bfloat16) for _ in range(2))
    # the backward kernels at qwen3-4b's training shapes (bf16): those rows
    # and that attention with an upstream gradient; each library backward
    # reuses its forward's saved tensors (autograd.grad, retain_graph)
    dy_rms = randn(*x_rms.shape, dtype=torch.bfloat16)
    rstd_rms = ref.rmsnorm_rstd(x_rms)
    x_lib, g_lib_req = (t.detach().requires_grad_() for t in (x_rms, g_lib))
    y_lib = F.rms_norm(x_lib, (cfg.d_model,), g_lib_req, 1e-6)
    do_p = randn(*qp.shape, dtype=torch.bfloat16)
    o_p, lse_p = attention_lse(qp, kp, vp, causal=True)
    qkv_lib = [t.detach().requires_grad_() for t in (qp, kp, vp)]
    o_lib = F.scaled_dot_product_attention(*qkv_lib, is_causal=True,
                                           enable_gqa=True)
    # ssd at mamba2-2.7b's prefill (bf16, chunk 128)
    ssd_in = ssd_inputs(*ssm_prefill, torch.bfloat16)

    def ln_bwd_case(R, N):
        """bf16 rows with fp32 gamma and beta, dy, the forward's mean and
        rstd, and ``F.layer_norm``'s graph on the same rows for its
        backward alone."""
        x, dy = (randn(R, N, dtype=torch.bfloat16) for _ in range(2))
        g, bt = randn(N), randn(N)
        leaves = [x.detach().requires_grad_()] + [
            t.detach().requires_grad_() for t in ln_affine(x, g, bt)]
        y = F.layer_norm(leaves[0], (N,), leaves[1], leaves[2], 1e-5)
        return (x, g, bt, *ref.layernorm_stats(x), dy), (y, leaves)

    # the new backward kernels at their training shapes: layernorm's at
    # whisper-medium's rows (4 x 512 tokens of 1024, bf16), ssd's at
    # mamba2-2.7b's (the prefill's shape, with dy and the saved states)
    ln_args, (y_ln, ln_leaves) = ln_bwd_case(TRAIN_BATCH * TRAIN_SEQ,
                                            wcfg.d_model)
    dy_ssd = randn(*ssd_in[0].shape, dtype=torch.bfloat16)
    _, _, st_ssd = ssd_states(*ssd_in, chunk=128)
    # name: (shape, kernel, plain version, one library call or None, FLOPs,
    #        bytes moved: each input read once, each output written once,
    #        the peak FLOP/s of the operations' type)
    rows = {
        "flex_gemm": (
            f"{M}x{K}x{N}{' +c' if acc else ''} fp32",
            lambda: flex_gemm(a, b, c=cin), lambda: ref.gemm(a, b, c=cin),
            (lambda: torch.addmm(c, a, b)) if acc
            else (lambda: torch.matmul(a, b)),
            2 * M * K * N, 4 * (M * K + K * N + M * N * (2 if acc else 1))),
        "sfu_softmax": (
            "512x512 fp32", lambda: softmax_rows(x_sm),
            lambda: ref.softmax_rows(x_sm), lambda: torch.softmax(x_sm, -1),
            5 * x_sm.numel(), 8 * x_sm.numel()),
        "sfu_layernorm": (
            "512x768 fp32", lambda: layernorm_rows(x_ln),
            lambda: ref.layernorm_rows(x_ln),
            lambda: F.layer_norm(x_ln, (768,), eps=1e-5),
            7 * x_ln.numel(), 8 * x_ln.numel()),
        "sfu_act": (
            "3072x4096 relu fp32 (MLP-L)", lambda: act_rows(x_act, "relu"),
            lambda: ref.relu_rows(x_act), lambda: torch.relu(x_act),
            x_act.numel(), 8 * x_act.numel()),
        "rmsnorm": (
            f"{x_rms.shape[0]}x{x_rms.shape[1]} bf16 +gamma (prefill norm1)",
            lambda: rmsnorm_rows(x_rms, g_rms),
            lambda: ref.rmsnorm_rows(x_rms, g_rms),
            lambda: F.rms_norm(x_rms, (cfg.d_model,), g_lib, 1e-6),
            4 * x_rms.numel(), 4 * x_rms.numel() + 4 * cfg.d_model),
        "flash_attention": (
            f"{tuple(qp.shape)} over {tuple(kp.shape)} causal bf16 (prefill)",
            lambda: flash_attention(qp, kp, vp, causal=True),
            lambda: ref.mha_attention(qp, kp, vp, causal=True),
            lambda: F.scaled_dot_product_attention(qp, kp, vp, is_causal=True,
                                                   enable_gqa=True),
            4 * cfg.head_dim * B * cfg.n_heads * causal_pairs(plen, plen),
            2 * (2 * qp.numel() + 2 * kp.numel())),
        # the backward kernels (no Pallas counterpart): rmsnorm's dx and
        # dgamma, about 9 operations an element; attention's five causal
        # products (s, dp, dv, dk, dq) at the bf16 tensor cores' peak
        "rmsnorm_bwd": (
            f"{x_rms.shape[0]}x{x_rms.shape[1]} bf16 +gamma (norm1's "
            f"backward, {TRAIN_ARCH} training)",
            lambda: sfu_k.rmsnorm_bwd(x_rms, g_rms, rstd_rms, dy_rms),
            lambda: ref.rmsnorm_bwd(x_rms, g_rms, rstd_rms, dy_rms),
            lambda: torch.autograd.grad(y_lib, (x_lib, g_lib_req), dy_rms,
                                        retain_graph=True),
            9 * x_rms.numel(),
            6 * x_rms.numel() + 4 * x_rms.shape[0] + 8 * cfg.d_model),
        "flash_attention_bwd": (
            f"{tuple(qp.shape)} over {tuple(kp.shape)} causal bf16 "
            f"({TRAIN_ARCH} training)",
            lambda: flash_attention_bwd(qp, kp, vp, o_p, lse_p, do_p,
                                        causal=True),
            lambda: ref.mha_attention_bwd(qp, kp, vp, o_p, lse_p, do_p,
                                          causal=True),
            lambda: torch.autograd.grad(o_lib, qkv_lib, do_p,
                                        retain_graph=True),
            10 * cfg.head_dim * B * cfg.n_heads * causal_pairs(plen, plen),
            2 * (4 * qp.numel() + 4 * kp.numel()) + 4 * lse_p.numel()),
        # layernorm's dx, dgamma and dbeta, about 12 operations an element
        "layernorm_bwd": (
            f"{ln_args[0].shape[0]}x{ln_args[0].shape[1]} bf16 +gamma +beta "
            f"({WHISPER_ARCH} training)",
            lambda: sfu_k.layernorm_bwd(*ln_args),
            lambda: ref.layernorm_bwd(*ln_args),
            lambda: torch.autograd.grad(y_ln, ln_leaves, ln_args[-1],
                                        retain_graph=True),
            12 * ln_args[0].numel(),
            6 * ln_args[0].numel() + 8 * ln_args[0].shape[0]
            + 12 * ln_args[0].shape[1]),
        # no single PyTorch call computes the SSD scan or its backward:
        # library_ms is null
        "ssd_bwd": (
            f"{ssm_prefill} chunk 128 bf16 (mamba2-2.7b training)",
            lambda: ssd_bwd(*ssd_in, dy_ssd, chunk=128, states=st_ssd),
            lambda: ref.ssd_bwd(*ssd_in, dy_ssd, chunk=128), None,
            *ssd_bwd_work(*ssm_prefill, 128, 2)),
        "ssd": (
            f"{ssm_prefill} chunk 128 bf16 (mamba2-2.7b prefill)",
            lambda: ssd(*ssd_in, chunk=128),
            lambda: ref.ssd_chunked(*ssd_in, chunk=128), None,
            *ssd_work(*ssm_prefill, 128, 2)),
    }
    # the bf16 tensor cores' peak where the kernel computes on them
    ops_peak = {"flash_attention": bf16_peak, "ssd": bf16_peak,
                "flash_attention_bwd": bf16_peak, "ssd_bwd": bf16_peak}

    report = functools.partial(time_row, smi, bw_peak)

    # the serving kernels' other shapes, printed only
    for R, N in RMS_SERVING[1:] + RMS_SSM + RMS_WIDE + RMS_VL + RMS_MOE:
        x, g = randn(R, N, dtype=torch.bfloat16), randn(N)
        gl = g.to(torch.bfloat16)
        report("rmsnorm", f"{R}x{N} bf16 +gamma", lambda: rmsnorm_rows(x, g),
               lambda: ref.rmsnorm_rows(x, g),
               lambda: F.rms_norm(x, (N,), gl, 1e-6),
               4 * x.numel(), 4 * x.numel() + 4 * N, fp32_peak)
    # rmsnorm's backward at the q-norm's and k-norm's training rows (bf16,
    # head_dim 128: the warp kernel)
    for R in (TRAIN_BATCH * TRAIN_SEQ * cfg.n_heads,
              TRAIN_BATCH * TRAIN_SEQ * cfg.n_kv_heads):
        N = cfg.head_dim
        x, dy, g = randn(R, N, dtype=torch.bfloat16), \
            randn(R, N, dtype=torch.bfloat16), randn(N)
        rs = ref.rmsnorm_rstd(x)
        xl, gl = x.detach().requires_grad_(), \
            g.to(torch.bfloat16).requires_grad_()
        yl = F.rms_norm(xl, (N,), gl, 1e-6)
        report("rmsnorm_bwd", f"{R}x{N} bf16 +gamma", lambda: sfu_k.rmsnorm_bwd(
            x, g, rs, dy), lambda: ref.rmsnorm_bwd(x, g, rs, dy),
            lambda: torch.autograd.grad(yl, (xl, gl), dy, retain_graph=True),
            9 * x.numel(), 6 * x.numel() + 4 * R + 8 * N, fp32_peak,
            MS_BEFORE_REDESIGN["rmsnorm_bwd", (R, N)])
    # layernorm's backward at nemotron-4-15b's rows (6144, bf16)
    for R, N in RMS_WIDE[:1]:
        args, (yl, ll) = ln_bwd_case(R, N)
        report("layernorm_bwd", f"{R}x{N} bf16 +gamma +beta (nemotron-4-15b)",
               lambda: sfu_k.layernorm_bwd(*args),
               lambda: ref.layernorm_bwd(*args),
               lambda: torch.autograd.grad(yl, ll, args[-1],
                                           retain_graph=True),
               12 * args[0].numel(),
               6 * args[0].numel() + 8 * R + 12 * N, fp32_peak,
               MS_BEFORE_REDESIGN["layernorm_bwd", (R, N)])
        del args, yl, ll
    # the norms' backward plans beside an alternative, timed in turns (plan,
    # alternative, alternative, plan) through the wrappers, with
    # sfu.norm_bwd_plan giving the alternative in its turns: rmsnorm's
    # q-norm rows (65,536 x 128 bf16) on the warp kernel (the plan) and on
    # the vector kernel (16 vectors a row on one warp, 20 rows a block);
    # whisper-medium's layernorm rows on the vector kernel (the plan) and on
    # the warp kernel (6 rows a block, two blocks an SM: the plan before the
    # redesign); nemotron-4-15b's on one 384-thread block an SM (the plan)
    # and two
    @contextlib.contextmanager
    def norm_bwd_plan_as(plan):
        """The norms' backward wrappers laid out by ``plan`` (threads,
        rows, blocks) in place of ``norm_bwd_plan``'s."""
        was = sfu_k.norm_bwd_plan
        sfu_k.norm_bwd_plan = lambda *_: plan
        try:
            yield
        finally:
            sfu_k.norm_bwd_plan = was

    sms = _build.sm_count(dev)
    for label, R, N, layer, alt in (
            ("rmsnorm_bwd q-norm", TRAIN_BATCH * TRAIN_SEQ * cfg.n_heads,
             cfg.head_dim, False, (32, 20, sms)),
            ("layernorm_bwd whisper-medium", TRAIN_BATCH * TRAIN_SEQ,
             wcfg.d_model, True, (0, 6, 2 * sms)),
            ("layernorm_bwd nemotron-4-15b", *RMS_WIDE[0], True,
             (384, 1, 2 * sms))):
        x, dy = (randn(R, N, dtype=torch.bfloat16) for _ in range(2))
        g = randn(N)
        stats = ref.layernorm_stats(x) if layer else (ref.rmsnorm_rstd(x),)
        plan = sfu_k.norm_bwd_plan(R, N, 2, True, sms, 2 if layer else 1)
        want = (ref.layernorm_bwd(x, g, g, *stats, dy) if layer
                else ref.rmsnorm_bwd(x, g, *stats, dy))

        def call():
            return (sfu_k.layernorm_bwd(x, g, g, *stats, dy) if layer
                    else sfu_k.rmsnorm_bwd(x, g, *stats, dy))
        ms = {}
        for p in (plan, alt, alt, plan):
            with norm_bwd_plan_as(p):
                got = call()
                torch.cuda.synchronize()
                require(rel_l2(got[0], want[0]) <= BF16_GRAD_RTOL and all(
                    rel_l2(u, v) <= DGAMMA_RTOL for u, v in zip(got[1:],
                                                                want[1:])),
                        f"{label} with plan {p} disagrees with the plain "
                        f"version")
                ms.setdefault(p, []).append(cuda_ms(torch, call)[0])
        print(f"[tune] {label} {R}x{N} bf16: device ms, plan {plan} "
              f"{np.mean(ms[plan]):.4f} ({', '.join(f'{t:.4f}' for t in ms[plan])}), "
              f"alternative {alt} {np.mean(ms[alt]):.4f} "
              f"({', '.join(f'{t:.4f}' for t in ms[alt])}); on {smi}")
        del x, dy, want, got
    # flash attention's backward at whisper-medium's training attention
    # (16 heads of 64, 4 x 512 tokens), causal (decoder) and full (encoder)
    for causal in (True, False):
        qw, kw, vw, dow = (randn(TRAIN_BATCH, wcfg.n_heads, TRAIN_SEQ,
                                 wcfg.head_dim, dtype=torch.bfloat16)
                           for _ in range(4))
        ow, lsew = attention_lse(qw, kw, vw, causal=causal)
        wl = [t.detach().requires_grad_() for t in (qw, kw, vw)]
        owl = F.scaled_dot_product_attention(*wl, is_causal=causal)
        pairs = causal_pairs(TRAIN_SEQ, TRAIN_SEQ) if causal \
            else TRAIN_SEQ * TRAIN_SEQ
        report("flash_attention_bwd",
               f"{tuple(qw.shape)} {'causal' if causal else 'full'} bf16 "
               f"({WHISPER_ARCH} training)",
               lambda: flash_attention_bwd(qw, kw, vw, ow, lsew, dow,
                                           causal=causal),
               lambda: ref.mha_attention_bwd(qw, kw, vw, ow, lsew, dow,
                                             causal=causal),
               lambda: torch.autograd.grad(owl, wl, dow, retain_graph=True),
               10 * wcfg.head_dim * TRAIN_BATCH * wcfg.n_heads * pairs,
               2 * 8 * qw.numel() + 4 * lsew.numel(), bf16_peak)
    # the backward kernels at the other training shapes (bf16, 4 x 512
    # tokens): rmsnorm's rows of qwen2-vl-2b (1536), internlm2-20b (6144),
    # llama4 (5120), jamba (8192) and jamba's gated norm (16,384: the block
    # kernel); attention's, causal, at qwen1.5-4b's 20 query heads over 20
    # kv heads, qwen2-vl-2b's 12 over 2, and over 8 kv heads at dbrx's 48
    # (internlm2-20b's too), llama4's 40 and jamba's 64 query heads (dbrx's
    # layernorm rows are nemotron-4-15b's, timed above)
    for who, N in (("qwen2-vl-2b", 1536), ("internlm2-20b", 6144),
                   ("MoE", 5120), ("MoE", 8192), ("MoE", 16384)):
        R = TRAIN_BATCH * TRAIN_SEQ
        x, dy, g = randn(R, N, dtype=torch.bfloat16), \
            randn(R, N, dtype=torch.bfloat16), randn(N)
        rs = ref.rmsnorm_rstd(x)
        xl, gl = x.detach().requires_grad_(), \
            g.to(torch.bfloat16).requires_grad_()
        yl = F.rms_norm(xl, (N,), gl, 1e-6)
        report("rmsnorm_bwd", f"{R}x{N} bf16 +gamma ({who} training rows)",
               lambda: sfu_k.rmsnorm_bwd(x, g, rs, dy),
               lambda: ref.rmsnorm_bwd(x, g, rs, dy),
               lambda: torch.autograd.grad(yl, (xl, gl), dy,
                                           retain_graph=True),
               9 * x.numel(), 6 * x.numel() + 4 * R + 8 * N, fp32_peak)
        del x, dy, xl, yl
    for arch in (*DENSE_TRAIN_ARCHS[:2], *MOE_TRAIN_CUTS):
        acfg = get_config(arch)
        qm = randn(TRAIN_BATCH, acfg.n_heads, TRAIN_SEQ, acfg.head_dim,
                   dtype=torch.bfloat16)
        km, vm = (randn(TRAIN_BATCH, acfg.n_kv_heads, TRAIN_SEQ,
                        acfg.head_dim, dtype=torch.bfloat16)
                  for _ in range(2))
        dom = randn(*qm.shape, dtype=torch.bfloat16)
        om, lsem = attention_lse(qm, km, vm, causal=True)
        ml = [t.detach().requires_grad_() for t in (qm, km, vm)]
        oml = F.scaled_dot_product_attention(*ml, is_causal=True,
                                             enable_gqa=True)
        report("flash_attention_bwd",
               f"{tuple(qm.shape)} over {tuple(km.shape)} causal bf16 "
               f"({arch} training, GQA {acfg.n_heads // acfg.n_kv_heads})",
               lambda: flash_attention_bwd(qm, km, vm, om, lsem, dom,
                                           causal=True),
               lambda: ref.mha_attention_bwd(qm, km, vm, om, lsem, dom,
                                             causal=True),
               lambda: torch.autograd.grad(oml, ml, dom, retain_graph=True),
               10 * acfg.head_dim * TRAIN_BATCH * acfg.n_heads
               * causal_pairs(TRAIN_SEQ, TRAIN_SEQ),
               2 * (4 * qm.numel() + 4 * km.numel()) + 4 * lsem.numel(),
               bf16_peak)
        del qm, km, vm, dom, om, lsem, ml, oml
    qd = randn(B, cfg.n_heads, 1, cfg.head_dim, dtype=torch.bfloat16)
    kd, vd = (randn(B, cfg.n_kv_heads, SERVE_MAX_LEN, cfg.head_dim,
                    dtype=torch.bfloat16) for _ in range(2))
    # decode over a short, the served (plen + 28) and a full cache
    for skv in (65, plen + 28, SERVE_MAX_LEN):
        report("flash_attention",
               f"decode {tuple(qd.shape)} over {skv} rows of "
               f"{tuple(kd.shape)} bf16",
               lambda: flash_attention(qd, kd, vd, causal=False, kv_len=skv),
               lambda: ref.mha_attention(qd, kd, vd, causal=False,
                                         kv_len=skv),
               lambda: F.scaled_dot_product_attention(
                   qd, kd[:, :, :skv], vd[:, :, :skv], enable_gqa=True),
               4 * cfg.head_dim * B * cfg.n_heads * skv,
               2 * (2 * qd.numel()
                    + 2 * B * cfg.n_kv_heads * skv * cfg.head_dim),
               bf16_peak)
    # ssd over one 2,048-token prompt at mamba2-2.7b's widths (bf16): 16
    # chunks in series over 320 state blocks
    long = (1, 2048, *ssm_prefill[2:])
    xl = ssd_inputs(*long, torch.bfloat16)
    report("ssd", f"{long} chunk 128 bf16 (one long prompt)",
           lambda: ssd(*xl, chunk=128),
           lambda: ref.ssd_chunked(*xl, chunk=128), None,
           *ssd_work(*long, 128, 2), bf16_peak)
    # ssd at the 4-layer fp32 check's prefill and forward (S = 32, 48)
    for S in (32, 48):
        shape = (2, S, *ssm_prefill[2:])
        xs = ssd_inputs(*shape, torch.float32)
        report("ssd", f"{shape} chunk {S} fp32",
               lambda: ssd(*xs, chunk=S), lambda: ref.ssd_plain(*xs, chunk=S),
               None, *ssd_work(*shape, S, 4), fp32_peak)
    # jamba's prefill (256 SSD heads of 64, bf16, chunk 128)
    xj = ssd_inputs(*jamba_prefill, torch.bfloat16)
    report("ssd", f"{jamba_prefill} chunk 128 bf16 (jamba-1.5-large prefill)",
           lambda: ssd(*xj, chunk=128),
           lambda: ref.ssd_chunked(*xj, chunk=128), None,
           *ssd_work(*jamba_prefill, 128, 2), bf16_peak)
    # and its backward (the bf16 kernels' 256-head shape)
    dyj = randn(*xj[0].shape, dtype=torch.bfloat16)
    _, _, stj = ssd_states(*xj, chunk=128)
    report("ssd_bwd", f"{jamba_prefill} chunk 128 bf16 (jamba-1.5-large "
           f"shape)", lambda: ssd_bwd(*xj, dyj, chunk=128, states=stj),
           lambda: ref.ssd_bwd(*xj, dyj, chunk=128), None,
           *ssd_bwd_work(*jamba_prefill, 128, 2), bf16_peak)
    del xj, dyj, stj
    # whisper-medium's attention (bf16, 16 heads of 64, over 1,500 frames,
    # non-causal), qwen2-vl-2b's prefill (causal, 12 query heads over 2),
    # and the MoE archs' prefill and decode over the served cache (head
    # 128; dbrx 48 over 8, llama4 40 over 8, jamba 64 over 8)
    moe_attn = [(f"{m.name} {label}", (B, m.n_heads, m.n_kv_heads, sq, skv,
                                       m.head_dim, sq > 1))
                for m in moe_cfgs
                for label, sq, skv in (("prefill", plen, plen),
                                       ("decode", 1, plen + SERVE_NEW - 1))]
    for label, (Bq, Hq, Hkv, Sq, Skv, D, causal) in (
            ("whisper-medium encoder", (WB, 16, 16, WF, WF, 64, False)),
            ("whisper-medium cross prefill", (WB, 16, 16, WP, WF, 64, False)),
            ("whisper-medium cross decode", (WB, 16, 16, 1, WF, 64, False)),
            (f"{MROPE_ARCH} prefill", (B, vcfg.n_heads, vcfg.n_kv_heads, plen,
                                       plen, vcfg.head_dim, True)),
            *moe_attn):
        qa = randn(Bq, Hq, Sq, D, dtype=torch.bfloat16)
        ka, va = (randn(Bq, Hkv, Skv, D, dtype=torch.bfloat16)
                  for _ in range(2))
        pairs = causal_pairs(Sq, Skv) if causal else Sq * Skv
        report("flash_attention",
               f"{label} {tuple(qa.shape)} over {tuple(ka.shape)} "
               f"{'causal' if causal else 'non-causal'} bf16",
               lambda: flash_attention(qa, ka, va, causal=causal),
               lambda: ref.mha_attention(qa, ka, va, causal=causal),
               lambda: F.scaled_dot_product_attention(
                   qa, ka, va, is_causal=causal, enable_gqa=Hq != Hkv),
               4 * D * Bq * Hq * pairs,
               2 * (2 * qa.numel() + 2 * ka.numel()), bf16_peak)
    # whisper-medium's layernorm rows (bf16 rows, fp32 gamma and beta): the
    # encoder's 4 x 1,500 frames and a decode step's 4 tokens
    for R in (WB * WF, WB):
        N = wcfg.d_model
        xb, g, bt = randn(R, N, dtype=torch.bfloat16), randn(N), randn(N)
        lib_gb = ln_affine(xb, g, bt)
        report("sfu_layernorm", f"{R}x{N} bf16 +gamma +beta (whisper-medium)",
               lambda: layernorm_rows(xb, g, bt),
               lambda: ref.layernorm_rows(xb, g, bt),
               lambda: F.layer_norm(xb, (N,), *lib_gb, 1e-5),
               7 * xb.numel(), 4 * xb.numel() + 8 * N, fp32_peak)
    xg = randn(512, 3072)
    report("sfu_act", "512x3072 gelu fp32", lambda: act_rows(xg, "gelu"),
           lambda: ref.gelu_rows(xg),
           lambda: F.gelu(xg, approximate="tanh"),
           GELU_FLOPS * xg.numel(), 8 * xg.numel(), fp32_peak)
    # nemotron-4-15b's norms as served: bf16 rows, fp32 gamma and beta,
    # beside the path before (a cast to fp32, the fp32 kernel from before
    # the redesign, a cast back); then fp32 rows (its 4-layer check)
    for R, N in RMS_WIDE:
        xb, g, bt = randn(R, N, dtype=torch.bfloat16), randn(N), randn(N)
        lib_gb = ln_affine(xb, g, bt)
        print(f"[time] F.layer_norm on bf16 rows takes "
              f"{'fp32' if lib_gb[0] is g else 'bf16'} gamma and beta"
              f"{'' if lib_gb[0] is g else ' (it refuses fp32 ones there)'}")
        report("sfu_layernorm",
               f"{R}x{N} bf16 +gamma +beta (nemotron-4-15b as served)",
               lambda: layernorm_rows(xb, g, bt),
               lambda: ref.layernorm_rows(xb, g, bt),
               lambda: F.layer_norm(xb, (N,), *lib_gb, 1e-5),
               7 * xb.numel(), 4 * xb.numel() + 8 * N, fp32_peak)

        def old_path():
            xf = xb.float()
            out = torch.empty_like(xf)
            sfu_k._launch_layernorm(xf, g, bt, 1e-5, out, 0, 0, False)
            return out.to(torch.bfloat16)
        ms, ms_b2b = cuda_ms(torch, old_path)
        print(f"[time] sfu_layernorm {R}x{N} bf16 +gamma +beta, the path "
              f"before (.float(), the fp32 block kernel, .to(bf16): 3 "
              f"launches): device ms {ms:.4f}, back-to-back {ms_b2b:.4f} "
              f"on {smi}")
        x = xb.float()
        report("sfu_layernorm", f"{R}x{N} fp32 +gamma +beta (nemotron-4-15b "
               f"4-layer fp32 check)",
               lambda: layernorm_rows(x, g, bt),
               lambda: ref.layernorm_rows(x, g, bt),
               lambda: F.layer_norm(x, (N,), g, bt, 1e-5),
               7 * x.numel(), 8 * x.numel() + 8 * N, fp32_peak)
    # the redesigned kernels beside their scalar kernels (the kernels
    # before the redesign, for unaligned operands now), printed only
    for R, N in ((2048, 2560), (2048, 5120), (2048, 6144), (4, 6144)):
        x, g = randn(R, N, dtype=torch.bfloat16), randn(N)
        out = torch.empty_like(x)
        for threads in (0, sfu_k.norm_plan(N, 2, True)):
            ms, _ = cuda_ms(torch, lambda: sfu_k._launch_rmsnorm(
                x, g, 1e-6, out, threads))
            path = (f"one-pass kernel, {threads} threads of "
                    f"{sfu_k.ROW_VPT} vectors" if threads else "scalar kernel")
            print(f"[time] rmsnorm {R}x{N} bf16 +gamma, {path}: device ms "
                  f"{ms:.4f} on {smi}")
    for R, N, act in ((512, 3072, "gelu"), (3072, 4096, "relu")):
        x = randn(R, N)
        out = torch.empty_like(x)
        for vector in (False, True):
            ms, _ = cuda_ms(torch, lambda: sfu_k._launch_act(x, out, act,
                                                             vector))
            print(f"[time] sfu_act {R}x{N} {act} fp32, "
                  f"{'float4 kernel' if vector else 'scalar kernel'}: device "
                  f"ms {ms:.4f} on {smi}")
    for kernel, R, N, dtype in REDESIGNED_ROWS:
        dt = getattr(torch, dtype)
        x = randn(R, N, dtype=dt, scale=3.0)
        out = torch.empty_like(x)
        g, bt = randn(N), randn(N)
        esize = x.element_size()
        slots, vector = sfu_k.warp_plan(N, esize, True)
        if kernel == "sfu_softmax":
            plans = {"block kernel (before the redesign)": (0, False),
                     f"warp kernel, {slots} {'float4' if vector else 'scalar'}"
                     f" slots a lane": (slots, vector)}
            launch = lambda p: sfu_k._launch_softmax(x, out, *p)  # noqa: E731
        else:
            threads = sfu_k.norm_plan(N, esize, True)
            new = (f"one-pass kernel, {threads} threads of "
                   f"{sfu_k.ROW_VPT} vectors" if threads else
                   f"warp kernel, {slots} {'16-byte' if vector else 'scalar'}"
                   f" slots a lane")
            plans = {"block kernel (before the redesign)": (0, 0, False),
                     new: (threads, slots, vector)}
            launch = lambda p: sfu_k._launch_layernorm(  # noqa: E731
                x, g, bt, 1e-5, out, *p)
        for path, plan in plans.items():
            ms, _ = cuda_ms(torch, lambda: launch(plan))
            print(f"[time] {kernel} {R}x{N} {dtype}"
                  f"{' +gamma +beta' if kernel == 'sfu_layernorm' else ''}, "
                  f"{path}: device ms {ms:.4f} on {smi}")
    # flex_gemm at every distinct tile (shape, accumulator, epilogue) of
    # each main-path binary beside torch.addmm / torch.matmul (which leave
    # the epilogue out), weighted by the tile's launches in one run
    for model in MAIN_MODELS:
        tiles = Counter((i.body.bound_i, i.body.bound_k, i.body.bound_j,
                         bool(i.body.accumulate),
                         EPILOGUE_NAME[Epilogue(i.body.epilogue)])
                        for i in programs[model].codegen.program.instructions
                        if i.op_type == OpType.MMU_GEMM
                        and i.body.ping_op == 1)
        weighted = [0.0, 0.0, 0.0]       # kernel, library, bound ms
        for (tm, tk, tn, tacc, tepi), n in sorted(tiles.items()):
            ta, tb, tc = randn(tm, tk), randn(tk, tn), randn(tm, tn)
            tcin = tc if tacc else None
            plan = gemm_plan(tm, tk, tn, _build.sm_count(dev))
            ms, _, lib_ms, bound_ms, _ = report(
                "flex_gemm",
                f"{model} tile {tm}x{tk}x{tn}{' +c' if tacc else ''} {tepi} "
                f"fp32 ({n} launches a run; {plan.blocks} blocks x "
                f"{plan.splits} K slabs)",
                lambda: flex_gemm(ta, tb, epilogue=tepi, c=tcin),
                lambda: ref.gemm(ta, tb, None, tepi, tcin),
                (lambda: torch.addmm(tc, ta, tb)) if tacc
                else (lambda: torch.matmul(ta, tb)),
                2 * tm * tk * tn,
                4 * (tm * tk + tk * tn + tm * tn * (2 if tacc else 1)),
                fp32_peak)
            for i, t in enumerate((ms, lib_ms, bound_ms)):
                weighted[i] += n * t
        print(f"[time] flex_gemm over {model}'s {sum(tiles.values())} tiles "
              f"({len(tiles)} distinct), launch-weighted device ms: kernel "
              f"{weighted[0]:.4f}, library {weighted[1]:.4f}, bound "
              f"{weighted[2]:.4f}; on {smi}")

    kernels = []
    shapes = {"rmsnorm_bwd": tuple(x_rms.shape),
              "flash_attention_bwd": tuple(qp.shape),
              "layernorm_bwd": tuple(ln_args[0].shape), "ssd_bwd": ssm_prefill}
    for name, row in rows.items():
        ms, plain_ms, lib_ms, bound_ms, bound_by = report(
            name, *row, ops_peak.get(name, fp32_peak),
            MS_BEFORE_REDESIGN.get((name, shapes.get(name))))
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})

    zero_counts()
    print(f"[main] launches over the whole script, checks and timing "
          f"included: {whole}; the script's phases took "
          f"{time.perf_counter() - t_script:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    cli()
