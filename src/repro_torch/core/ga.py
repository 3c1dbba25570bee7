"""Stage-2 heuristic engine: genetic algorithm (paper §4.4).

Chromosome = 2N genes for an N-layer DAG:
  Encode[N]    : floats in [0,1] — scheduling priorities
  Candidate[N] : ints — selected execution mode per layer

A dependency-aware decoder (the serial SGS in schedule.py) turns any
chromosome into a *feasible* schedule, so crossover/mutation never
produce invalid individuals. Fitness = makespan. The solver records a
(elapsed_seconds, best_makespan) trace for the Fig. 12 comparisons.

The engine consumes the stage-1 candidate table as-is: under
share-aware stage 1 (``CompileOptions.share_aware_stage1``) every
``CandidateMode.latency_s`` it prices fitness with is already scaled to
the layer's tenant bandwidth share, so the evolved mode genes select
tiles sized for the bandwidth each tenant is actually guaranteed — no
GA-side change is needed.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from .graph import WorkloadGraph
from .perf_model import CandidateMode, DoraPlatform
from .schedule import Schedule, list_schedule


@dataclass
class GAConfig:
    population: int = 48
    generations: int = 60
    tournament: int = 3
    crossover_rate: float = 0.9
    mutation_rate: float = 0.15
    elite: int = 2
    seed: int = 0
    time_budget_s: float = 30.0


@dataclass
class GAResult:
    schedule: Schedule
    best_makespan: float
    generations_run: int
    elapsed_s: float
    trace: list[tuple[float, float]] = field(default_factory=list)


class GAScheduler:
    def __init__(self, platform: DoraPlatform, config: GAConfig | None = None):
        self.platform = platform
        self.config = config or GAConfig()

    def _decode(self, graph: WorkloadGraph,
                candidates: dict[int, list[CandidateMode]],
                priorities: np.ndarray, modes: np.ndarray,
                release: dict[int, float] | None = None) -> Schedule:
        n = len(graph.layers)
        prio = {i: float(priorities[i]) for i in range(n)}
        choice = {i: int(modes[i]) for i in range(n)}
        return list_schedule(graph, candidates, self.platform, prio, choice,
                             release=release)

    def solve(self, graph: WorkloadGraph,
              candidates: dict[int, list[CandidateMode]],
              release: dict[int, float] | None = None,
              seed_priorities: dict[int, float] | None = None) -> GAResult:
        """``seed_priorities`` (multi-tenant): one individual starts
        from the caller's priority bias instead of topological order;
        evolution is free to move away from it."""
        cfg = self.config
        rng = np.random.default_rng(cfg.seed)
        t0 = time.perf_counter()
        n = len(graph.layers)
        n_modes = np.array([len(candidates[i]) for i in range(n)])

        # population: [pop, 2N] — first N priorities, last N mode genes
        prio = rng.random((cfg.population, n))
        modes = rng.integers(0, n_modes, size=(cfg.population, n))
        # seed one individual with topological priorities + fastest modes
        prio[0] = np.linspace(0.0, 1.0, n)
        modes[0] = [int(np.argmin([c.latency_s for c in candidates[i]]))
                    for i in range(n)]
        if seed_priorities and n > 1:
            raw = np.array([seed_priorities.get(i, float(i))
                            for i in range(n)])
            span = raw.max() - raw.min()
            prio[1] = (raw - raw.min()) / span if span > 0 else 0.5
            modes[1] = modes[0]

        def fitness(p, m) -> tuple[float, Schedule]:
            s = self._decode(graph, candidates, p, m, release)
            return s.makespan, s

        fits: list[float] = []
        scheds: list[Schedule] = []
        for i in range(cfg.population):
            f, s = fitness(prio[i], modes[i])
            fits.append(f)
            scheds.append(s)
        best_i = int(np.argmin(fits))
        best_f, best_s = fits[best_i], scheds[best_i]
        trace = [(time.perf_counter() - t0, best_f)]

        gens = 0
        for gen in range(cfg.generations):
            if time.perf_counter() - t0 > cfg.time_budget_s:
                break
            gens = gen + 1
            new_prio = np.empty_like(prio)
            new_modes = np.empty_like(modes)
            # elitism
            order = np.argsort(fits)
            for e in range(cfg.elite):
                new_prio[e] = prio[order[e]]
                new_modes[e] = modes[order[e]]
            for i in range(cfg.elite, cfg.population):
                # tournament selection
                def pick() -> int:
                    idx = rng.integers(0, cfg.population, size=cfg.tournament)
                    return int(idx[np.argmin([fits[j] for j in idx])])
                a, b = pick(), pick()
                if rng.random() < cfg.crossover_rate:
                    mask = rng.random(n) < 0.5
                    new_prio[i] = np.where(mask, prio[a], prio[b])
                    mmask = rng.random(n) < 0.5
                    new_modes[i] = np.where(mmask, modes[a], modes[b])
                else:
                    new_prio[i] = prio[a]
                    new_modes[i] = modes[a]
                # mutation
                mut = rng.random(n) < cfg.mutation_rate
                new_prio[i] = np.where(
                    mut, np.clip(new_prio[i] + rng.normal(0, 0.25, n), 0, 1),
                    new_prio[i])
                mmut = rng.random(n) < cfg.mutation_rate
                rand_modes = rng.integers(0, n_modes)
                new_modes[i] = np.where(mmut, rand_modes, new_modes[i])
            prio, modes = new_prio, new_modes
            fits, scheds = [], []
            for i in range(cfg.population):
                f, s = fitness(prio[i], modes[i])
                fits.append(f)
                scheds.append(s)
            gi = int(np.argmin(fits))
            if fits[gi] < best_f:
                best_f, best_s = fits[gi], scheds[gi]
                trace.append((time.perf_counter() - t0, best_f))

        best_s.validate(graph, self.platform, release=release)
        return GAResult(best_s, best_f, gens,
                        time.perf_counter() - t0, trace)
