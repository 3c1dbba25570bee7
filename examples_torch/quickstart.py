"""Quickstart: compile a DNN workload with the DORA two-stage DSE,
inspect the generated instruction stream, simulate its timing, and
execute it on the card's kernels (``flex_gemm`` and the SFU row kernels)
— validating against the numpy oracle.  Port of
``examples/quickstart.py``.

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import paper_models
from repro_torch.core import (CompileOptions, DoraCompiler, DoraPlatform,
                              Policy, UnitKind, disassemble, simulate)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def run(args: argparse.Namespace | None = None, device=None) -> dict:
    """Compiles BERT-S, simulates and executes it on ``device`` (``args``
    holds nothing else); returns the printed numbers, the
    ``CompileResult`` and every layer's output (numpy) beside
    ``reference_execute``'s."""
    # the paper's BERT-32 tiny model — the worst case for fixed-dataflow
    # accelerators (Fig. 1 point e)
    graph = paper_models.bert_s()
    platform = DoraPlatform.vck190()     # 6 MMUs, 14 LMUs, 3 SFUs
    compiler = DoraCompiler(platform, Policy.dora())
    result = compiler.compile(graph, CompileOptions(
        engine="milp", time_budget_s=5.0))
    report = simulate(result.codegen, platform)
    inputs = graph.random_inputs(0)
    outputs = {k: v.cpu().numpy()
               for k, v in compiler.execute(result, inputs,
                                            device=device).items()}
    reference = graph.reference_execute(inputs)
    last = graph.layers[-1].name
    got, want = outputs[last], reference[last]
    return {
        "graph": graph, "result": result, "outputs": outputs,
        "reference": reference,
        "head": disassemble(result.codegen.program).splitlines()[:12],
        "sim_makespan_s": report.makespan_s,
        "mmu0_utilization": report.utilization((UnitKind.MMU, 0)),
        "max_abs_err": float(np.max(np.abs(got - want))),
        "rel_l2": float(np.linalg.norm(got - want)
                        / max(np.linalg.norm(want), 1e-30)),
    }


def main(argv=None) -> None:
    args = parse_args(argv)
    r = run(args, device=args.device)
    graph, result = r["graph"], r["result"]
    print(f"workload: {graph.name} — {len(graph.layers)} layers, "
          f"{graph.total_flops / 1e9:.2f} GFLOP")
    print(f"stage-1 DSE: {result.stage1_s * 1e3:.1f} ms, "
          f"stage-2 ({'MILP' if result.optimal is not None else 'GA'}): "
          f"{result.stage2_s * 1e3:.1f} ms, optimal={result.optimal}")
    print(f"schedule makespan: {result.makespan_s * 1e3:.3f} ms "
          f"-> {result.throughput_gflops:.1f} GFLOPS")
    print(f"binary: {len(result.codegen.program)} instructions, "
          f"{result.program_bytes} bytes")
    print("\nfirst 12 instructions:")
    print("  " + "\n  ".join(r["head"]))
    print(f"\nevent-driven simulation: makespan "
          f"{r['sim_makespan_s'] * 1e3:.3f} ms; MMU0 utilization "
          f"{r['mmu0_utilization'] * 100:.0f}%")
    print(f"functional runtime vs oracle (last layer): max abs err "
          f"{r['max_abs_err']:.2e}, relative L2 {r['rel_l2']:.2e}")


if __name__ == "__main__":
    main()
