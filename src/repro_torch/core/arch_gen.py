"""Template-based DORA architecture generation (paper §3.7, §6 intro).

Users specify unit counts (and optional HLS-style custom SFU functions);
``generate_platform`` instantiates the DoraPlatform; ``search_template``
reproduces the paper's hyperparameter search that settled on
6 MMUs / 14 LMUs / 3 SFUs for the evaluated model set.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Sequence

import numpy as np

from .graph import WorkloadGraph
from .perf_model import DoraPlatform, Policy, build_candidate_table
from .schedule import list_schedule


@dataclass(frozen=True)
class ArchTemplate:
    n_mmu: int = 6
    n_lmu: int = 14
    n_sfu: int = 3
    pe_grid: tuple[int, int, int] = (4, 4, 4)
    # user-defined non-linear functions (HLS C/C++ in the paper; here any
    # row-wise numpy callable registered under a name)
    custom_sfu: dict[str, Callable[[np.ndarray], np.ndarray]] = field(
        default_factory=dict, hash=False, compare=False)

    def resource_cost(self) -> float:
        """Abstract PL+AIE area proxy (for budget-constrained search)."""
        return (self.n_mmu * 64          # AIE tiles
                + self.n_lmu * 8         # URAM-heavy
                + self.n_sfu * 12)       # DSP/LUT-heavy


def generate_platform(template: ArchTemplate,
                      base: DoraPlatform | None = None) -> DoraPlatform:
    base = base or DoraPlatform.vck190()
    return replace(base, n_mmu=template.n_mmu, n_lmu=template.n_lmu,
                   n_sfu=template.n_sfu, pe_grid=template.pe_grid)


def evaluate_template(template: ArchTemplate,
                      graphs: Sequence[WorkloadGraph],
                      policy: Policy | None = None,
                      bandwidth_share: float = 1.0,
                      latency_model: str = "analytic") -> float:
    """Mean makespan over a model set under a fast list schedule — the
    fitness used by the architecture search.

    ``bandwidth_share`` prices every candidate table at that fraction of
    the DRAM bandwidth (share-aware stage 1): searching a template for a
    multi-tenant deployment should size it for the bandwidth each
    resident workload is actually guaranteed, not the full-bandwidth
    solo assumption.

    ``latency_model`` ("analytic" | "pipeline") selects the stage-1
    pricing model: pipeline pricing scores templates by the fill/drain
    and MIU-serialization costs the emitted stream actually pays, so
    a search stops over-crediting configurations that only look good
    under the perfect-overlap assumption.

    Repeated evaluations hit the process-level stage-1 memo
    (``perf_model.build_candidate_table``): the memo key includes the
    generated platform, so each template prices each distinct layer
    shape once and a search over K templates with repeated shapes pays
    enumeration only for the unique (shape, platform) pairs."""
    policy = policy or Policy.dora()
    platform = generate_platform(template)
    total = 0.0
    for g in graphs:
        cands = build_candidate_table(g, platform, policy,
                                      bandwidth_share=bandwidth_share,
                                      latency_model=latency_model)
        total += list_schedule(g, cands, platform).makespan
    return total / max(len(graphs), 1)


def search_mesh_templates(graph_groups: Sequence[Sequence[WorkloadGraph]],
                          area_budget: float | None = 600.0,
                          mmu_options: Sequence[int] = (2, 4, 6, 8),
                          lmu_options: Sequence[int] = (8, 14, 20),
                          sfu_options: Sequence[int] = (1, 3),
                          latency_model: str = "analytic",
                          ) -> list[ArchTemplate]:
    """One specialized ``ArchTemplate`` per PE of a heterogeneous mesh
    (Herald-style): ``graph_groups[k]`` is the model set PE *k* is being
    sized for, and the per-PE search prices candidate tables at
    ``1 / n_pes`` of the DRAM bandwidth — the share an equal-weight
    ``DoraMesh`` grants when every PE is occupied — so templates are
    chosen for the bandwidth they will actually see behind the shared
    DRAM, not the full solo port.  ``area_budget`` bounds *each* PE
    (pass the single-PE budget divided by N for an area-neutral
    comparison against one big PE)."""
    if not graph_groups:
        raise ValueError("search_mesh_templates: no PE graph groups")
    share = 1.0 / len(graph_groups)
    return [search_template(group, mmu_options=mmu_options,
                            lmu_options=lmu_options,
                            sfu_options=sfu_options,
                            area_budget=area_budget,
                            bandwidth_share=share,
                            latency_model=latency_model)[0]
            for group in graph_groups]


def search_template(graphs: Sequence[WorkloadGraph],
                    mmu_options: Sequence[int] = (2, 4, 6, 8),
                    lmu_options: Sequence[int] = (8, 14, 20),
                    sfu_options: Sequence[int] = (1, 3),
                    area_budget: float | None = 600.0,
                    bandwidth_share: float = 1.0,
                    latency_model: str = "analytic",
                    ) -> tuple[ArchTemplate, float]:
    best: tuple[ArchTemplate, float] | None = None
    for nm in mmu_options:
        for nl in lmu_options:
            for ns in sfu_options:
                t = ArchTemplate(nm, nl, ns)
                if area_budget is not None and t.resource_cost() > area_budget:
                    continue
                score = evaluate_template(t, graphs,
                                          bandwidth_share=bandwidth_share,
                                          latency_model=latency_model)
                if best is None or score < best[1]:
                    best = (t, score)
    if best is None:
        floor = ArchTemplate(min(mmu_options), min(lmu_options),
                             min(sfu_options)).resource_cost()
        raise ValueError(f"no template fits area_budget={area_budget} "
                         f"(cheapest candidate costs {floor})")
    return best
