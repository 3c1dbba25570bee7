"""DORA core on PyTorch: ISA, two-stage DSE compiler, schedulers, codegen,
simulator, architecture search, multi-PE mesh, serving simulator and
tuning (numpy copies of ``repro.core``) and the functional runtime, which
runs the binary on the card's kernels."""

from .arch_gen import (ArchTemplate, generate_platform,
                       search_mesh_templates, search_template)
from .codegen import CodegenResult, MemoryMap, generate
from .compiler import CompileOptions, CompileResult, DoraCompiler
from .ga import GAConfig, GAResult, GAScheduler
from .graph import Layer, LayerKind, NonLinear, WorkloadGraph, mlp_graph, random_dag
from .interleave import (apply_permutation, interleave_stream,
                         plan_interleave, validate_stream)
from .isa import (Epilogue, Instruction, LMUBody, LmuRole, MIUBody, MMUBody,
                  OpType, Program, SFUBody, UnitKind, disassemble, mk)
from .mesh import (EXHAUSTIVE_LIMIT, DoraMesh, DoraMeshCompiler,
                   MeshCompileResult, MeshSimReport, PESpec, Placement,
                   solve_placement)
from .milp import MilpScheduler, SolveResult
from .multi_tenant import (PLACEMENT_STRATEGIES, QOS_POLICIES,
                           MergedWorkload, MultiTenantWorkload, TenantSpec)
from .partition import PartitionedResult, partitioned_solve, split_segments
from .perf_model import (LATENCY_MODELS, VC_ARBITRATIONS, CandidateMode,
                         DoraPlatform, Policy, TilePlan, TpuGemmTiles,
                         build_candidate_table, candidate_memo_stats,
                         clear_candidate_memo, enumerate_layer_candidates,
                         enumerate_layer_candidates_scalar,
                         layer_dram_bytes, layer_latency, mode_dram_demand,
                         mode_latency_at_share, pipeline_layer_latency,
                         plan_buffer_depth, plan_tpu_gemm_tiles,
                         share_scaled_platform, single_pe_efficiency)
from .runtime import DoraRuntime
from .schedule import (InterleaveBound, OversubscriptionBound, Schedule,
                       ScheduleEntry, dispatch_overlap_s,
                       interleave_aware_bound, list_schedule,
                       makespan_lower_bound, oversubscription_aware_bound,
                       sequential_schedule)
from .serving import (ADMISSION_POLICIES, DISPATCH_MODES, DispatchEvent,
                      DispatchRound, DynamicDispatcher, Request,
                      RequestRecord, RequestStream, ServingConfig,
                      ServingResult, ServingSimulator, ServingStats,
                      TenantStream, serve)
from .simulator import (IncrementalSimulator, SimReport, TenantSimStats,
                        TenantTelemetry, nearest_rank, simulate,
                        simulate_mesh)
from .tuning import (TUNE_OBJECTIVES, AdaptiveSharePolicy, KnobConfig,
                     KnobSpace, ShareDecision, TuneResult, TuneTrial,
                     autotune, step_trace)

__all__ = [n for n in dir() if not n.startswith("_")]
