"""DSE engines side by side (paper §4.4 / Fig. 12): exact MILP,
genetic algorithm, and DAG-partitioned MILP on the DeiT workload.  Port
of ``examples/dora_scheduling.py`` through the port's numpy ``core``
copies: no device and no kernel.

Run:  PYTHONPATH=src python examples_torch/dora_scheduling.py
"""

from __future__ import annotations

import argparse

from repro_torch.configs import paper_models
from repro_torch.core import (DoraPlatform, GAConfig, GAScheduler,
                              MilpScheduler, Policy, build_candidate_table,
                              partitioned_solve)


def parse_args(argv=None) -> argparse.Namespace:
    return argparse.ArgumentParser().parse_args(argv)


def run(args: argparse.Namespace | None = None) -> dict:
    """The three engines on DeiT-S (``args`` holds nothing); returns the
    printed numbers and each engine's result."""
    plat = DoraPlatform.vck190()
    g = paper_models.deit_s()
    table = build_candidate_table(g, plat, Policy.dora())
    milp = MilpScheduler(plat, time_budget_s=10.0).solve(g, table)
    ga = GAScheduler(plat, GAConfig(population=48, generations=40,
                                    seed=0)).solve(g, table)
    part = partitioned_solve(
        g, table, plat, 4,
        lambda: MilpScheduler(plat, time_budget_s=2.0))
    return {"graph": g, "n_modes": sum(len(v) for v in table.values()),
            "milp": milp, "ga": ga, "partitioned": part}


def main(argv=None) -> None:
    r = run(parse_args(argv))
    g, milp, ga, part = r["graph"], r["milp"], r["ga"], r["partitioned"]
    n_modes = r["n_modes"]
    print(f"{g.name}: {len(g.layers)} layers, candidate table has "
          f"{n_modes} modes (design space ~ "
          f"{n_modes / len(g.layers):.1f}^{len(g.layers)})")
    print(f"\nMILP  : makespan {milp.schedule.makespan * 1e3:.3f} ms  "
          f"(optimal={milp.optimal}, {milp.nodes_explored} nodes, "
          f"{milp.elapsed_s:.2f}s)")
    print(f"GA    : makespan {ga.best_makespan * 1e3:.3f} ms  "
          f"(optimality {milp.schedule.makespan / ga.best_makespan:.1%}, "
          f"{ga.generations_run} gens, {ga.elapsed_s:.2f}s)")
    print(f"4-seg : makespan {part.makespan * 1e3:.3f} ms  "
          f"(parallel wall {part.wall_s:.2f}s vs cpu {part.total_cpu_s:.2f}s)")


if __name__ == "__main__":
    main()
