#!/usr/bin/env python3
"""Drives DORA's PyTorch/CUDA port on one NVIDIA GPU and checks it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; no phase is caught):

1. device: a CUDA device must be present; prints the card's name and
   power limit as ``nvidia-smi`` reports them.
2. build: compiles every kernel source of ``src/repro_torch/kernels/csrc``
   (one ``nvcc`` each, in parallel) and prints the seconds.
3. kernels: holds each kernel against its plain PyTorch version on the
   card: ``flex_gemm`` over the reference's GEMM shapes, every epilogue,
   with and without the accumulator, fp32 and bf16, plus every MMU tile
   shape of BERT-L; the SFU row kernels over the reference's SFU shapes
   and the main path's row shapes.
4. main path: compiles paper workloads with ``DoraCompiler`` and runs
   each compiled binary through ``DoraCompiler.execute`` on the card from
   ``random_inputs(0)``: BERT-L and DeiT-L at full width, MLP-L (the one
   paper workload whose binary carries an element-wise SFU op) and every
   -S model.  The kernels' launch counts, zeroed just before, must equal
   the binaries' lead ``MMU_GEMM`` and ``SFU_*`` instruction counts.
   Every layer is held against ``reference_execute`` of that layer on
   the inputs the binary gave it (rtol 5e-4, atol 5e-4 scaled up only
   past |ref| = 100); the chained outputs against ``reference_execute``
   of the whole graph by relative L2 error (see ``CHAIN_RTOL``).
5. timing: BERT-L's compile and execute seconds, its device time by
   kernel (profiler), and each kernel's device time at the main path's
   shapes (CUDA events, see ``cuda_ms``) beside its plain version, one
   PyTorch library call and the card's bound.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
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
# Peak rates from NVIDIA's data sheets: fp32 FLOP/s outside the tensor
# cores (every timed kernel computes in fp32), device-memory bytes/s.
PEAKS = (("H100 PCIe", 51e12, 2.0e12),
         ("H100 NVL", 60e12, 3.9e12),
         ("H200", 67e12, 4.8e12),
         ("H100", 67e12, 3.35e12))
REPLACES = {
    "flex_gemm": "src/repro/kernels/flex_gemm.py:58",
    "sfu_softmax": "src/repro/kernels/sfu.py:32",
    "sfu_layernorm": "src/repro/kernels/sfu.py:41",
    "sfu_act": "src/repro/kernels/sfu.py:67",
}
SOURCES = {
    "flex_gemm": "src/repro_torch/kernels/csrc/flex_gemm.cu",
    "sfu_softmax": "src/repro_torch/kernels/csrc/sfu.cu",
    "sfu_layernorm": "src/repro_torch/kernels/csrc/sfu.cu",
    "sfu_act": "src/repro_torch/kernels/csrc/sfu.cu",
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def peaks(name: str) -> tuple[float, float]:
    for key, fp32, bw in PEAKS:
        if key in name:
            return fp32, bw
    print(f"note: no data-sheet peaks for {name!r}; using the H100 SXM's")
    return PEAKS[-1][1:]


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


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0


def close(got, want, rtol: float, atol: float) -> bool:
    return bool(((got.float() - want.float()).abs()
                 <= atol + rtol * want.float().abs()).all())


def main() -> None:
    import torch
    require(torch.cuda.is_available(), "no CUDA device")
    import numpy as np
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import paper_models
    from repro_torch.core import (CompileOptions, DoraCompiler, Epilogue,
                              OpType, UnitKind)
    from repro_torch.core.graph import LayerKind, WorkloadGraph
    from repro_torch.core.runtime import EPILOGUE_NAME, SFU_ACT
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flex_gemm import flex_gemm
    from repro_torch.kernels.ref import EPILOGUES
    from repro_torch.kernels.sfu import act_rows, layernorm_rows, softmax_rows

    # fp32 products in full fp32 for the plain versions and yardsticks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[device] {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    fp32_peak, bw_peak = peaks(kind)

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    _build.build()
    print(f"[build] {len(_build.SOURCES)} libraries in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    # ------------------------------------------------------- kernel checks
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

    # every shape the main path gives each kernel, as its binaries give it
    # (fp32, the instruction's epilogue and accumulate flag); these errors
    # go into the kernels' JSON record
    programs = {name: DoraCompiler().compile(paper_models.get(name),
                                             CompileOptions(engine="list"))
                for name in MAIN_MODELS}
    instrs = [i for res in programs.values()
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

    # ----------------------------------------------------------- main path
    counters = {"flex_gemm": flex_gemm, "sfu_softmax": softmax_rows,
                "sfu_layernorm": layernorm_rows, "sfu_act": act_rows}
    sfu_ops = {"sfu_softmax": {OpType.SFU_SOFTMAX},
               "sfu_layernorm": {OpType.SFU_LAYERNORM},
               "sfu_act": set(SFU_ACT)}
    inputs, outputs = {}, {}
    for fn in counters.values():
        fn.launches = 0
    for name in MAIN_MODELS:
        res = programs[name]
        prog = res.codegen.program.instructions
        expected = {k: sum(1 for i in prog if i.op_type in ops)
                    for k, ops in sfu_ops.items()}
        expected["flex_gemm"] = sum(1 for i in prog
                                    if i.op_type == OpType.MMU_GEMM
                                    and i.body.ping_op == 1)
        before = {k: fn.launches for k, fn in counters.items()}
        inputs[name] = res.graph.random_inputs(0)
        outputs[name] = DoraCompiler().execute(res, inputs[name])
        torch.cuda.synchronize()
        ran = {k: fn.launches - before[k] for k, fn in counters.items()}
        print(f"[main] {name}: launches {ran}")
        require(ran == expected, f"{name}: launches {ran} differ from the "
                f"binary's instruction counts {expected}")
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"[main] launches over the main path: {launches}")
    require(all(n > 0 for n in launches.values()),
            "a kernel of the main path was never launched")

    for name in MAIN_MODELS:
        g = programs[name].graph
        out = {k: v.cpu().numpy() for k, v in outputs[name].items()}
        env = {**inputs[name], **out}
        chained = g.reference_execute(inputs[name])
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
              f"{len(programs[name].codegen.program)} instructions; per-layer "
              f"max abs err {worst_layer[0]:.3g} ({worst_layer[1]}); chained "
              f"rel L2 err {worst_chain[0]:.3g} ({worst_chain[1]})")
    del outputs

    # -------------------------------------------------------------- timing
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
    # where the execute time goes: device time by kernel (CUPTI trace)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        DoraCompiler().execute(res, inputs["BERT-L"])
        torch.cuda.synchronize()
    by_kernel = sorted(((e.self_device_time_total, e.count, e.key)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and e.self_device_time_total > 0), reverse=True)
    busy_ms = sum(t for t, _, _ in by_kernel) / 1e3
    if by_kernel:
        print(f"[profile] BERT-L execute: device busy {busy_ms:.4f} ms of "
              f"{execute_s * 1e3:.4f} ms unprofiled host time "
              f"({busy_ms / (execute_s * 1e3):.1%})")
        for t, n, key in by_kernel[:8]:
            print(f"[profile]   {t / 1e3:.4f} ms in {n} launches: {key[:90]}")
    else:
        print("[profile] device time not measured: the profiler recorded "
              "no CUDA kernel")

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
    # name: (shape, kernel, plain version, one library call, FLOPs,
    #        bytes moved: each input read once, each output written once)
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
    }
    xg = randn(512, 3072)
    gelu, gelu_lib = (cuda_ms(torch, lambda: act_rows(xg, "gelu")),
                      cuda_ms(torch, lambda: F.gelu(xg, approximate="tanh")))
    print(f"[time] act_rows gelu 512x3072 fp32: device {gelu[0]:.4f} ms "
          f"(back-to-back {gelu[1]:.4f}), F.gelu(tanh) {gelu_lib[0]:.4f} ms "
          f"(back-to-back {gelu_lib[1]:.4f})")

    kernels = []
    for name, (shape, kernel, plain, library, flops, nbytes) in rows.items():
        (ms, ms_b2b), (plain_ms, plain_b2b), (lib_ms, lib_b2b) = (
            cuda_ms(torch, fn) for fn in (kernel, plain, library))
        t_ops, t_bytes = flops / fp32_peak, nbytes / bw_peak
        bound_ms = 1e3 * max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        print(f"[time] {name} {shape}: device ms: kernel {ms:.4f}, plain "
              f"{plain_ms:.4f}, library {lib_ms:.4f}, bound {bound_ms:.4f} "
              f"({bound_by}); back-to-back ms: kernel {ms_b2b:.4f}, plain "
              f"{plain_b2b:.4f}, library {lib_b2b:.4f}; on {smi}")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})

    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
