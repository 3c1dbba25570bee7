"""DORA's multi-tenant path in the port against the JAX package's.

Joint, interleaved and mesh binaries compiled by the port's copied
compiler equal the reference's byte for byte, and the port's torch
runtime (``device="cpu"``: the kernels' plain versions) runs them to the
numbers of ``reference_execute`` and of the reference's numpy
``DoraRuntime`` on the same bytes.  The tolerance is the reference
multi-tenant tests' rtol = atol = 2e-3 (``tests/test_multi_tenant.py``,
``tests/test_interleave.py``).  The copied architecture search, serving
simulator, autotuner and ``from_arch`` give the reference's results on
the same seeds.
"""

import dataclasses
import enum

import numpy as np
import pytest

import repro.core as R
from repro.configs import paper_models as ref_models
from repro.core.runtime import DoraRuntime as RefRuntime
import repro_torch.core as P
from repro_torch.configs import paper_models
from repro_torch.core.codegen import _GROUP_MOD
from repro_torch.core.runtime import DoraRuntime

TOL = dict(rtol=2e-3, atol=2e-3)


def _plain(obj):
    """Comparable form of results from either package: dataclasses as
    (type name, fields), enums as (type name, value)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                tuple((f.name, _plain(getattr(obj, f.name)))
                      for f in dataclasses.fields(obj)))
    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.value)
    if isinstance(obj, dict):
        return tuple(sorted((_plain(k), _plain(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_plain(v) for v in obj)
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _pair(pkg, interleave="none"):
    """tests/test_multi_tenant.py's pair: two MLPs, GELU and ReLU."""
    mt = pkg.MultiTenantWorkload("pair", interleave=interleave)
    mt.add_tenant("ta", pkg.mlp_graph("a", 128, [96, 128, 64],
                                      pkg.NonLinear.GELU), priority=2.0)
    mt.add_tenant("tb", pkg.mlp_graph("b", 64, [64, 96, 32],
                                      pkg.NonLinear.RELU))
    return mt


def _scenario(pkg, models, names):
    """A workload of paper models, as benchmarks/bench_multi_tenant.py
    builds its scenarios."""
    mt = pkg.MultiTenantWorkload("+".join(names))
    for name in names:
        mt.add_tenant(name, models.get(name))
    return mt


def _compile(pkg, workload, **opts):
    return pkg.DoraCompiler(pkg.DoraPlatform.vck190(), pkg.Policy.dora()
                            ).compile(workload,
                                      pkg.CompileOptions(engine="list", **opts))


def _run_both(graph, codegen, seed=0):
    """The port's runtime and the reference's on the same binary bytes,
    both held to ``reference_execute`` of every layer."""
    raw = codegen.program.encode()
    inputs = graph.random_inputs(seed)
    want = graph.reference_execute(inputs)
    rt = DoraRuntime(codegen.memmap, device="cpu")
    rt.load_inputs(inputs)
    out = {k: v.numpy() for k, v in rt.execute(raw).items()}
    ref_rt = RefRuntime(codegen.memmap)
    ref_rt.load_inputs(inputs)
    ref_out = ref_rt.execute(raw)
    for layer in graph.layers:
        np.testing.assert_allclose(out[layer.name], want[layer.name], **TOL,
                                   err_msg=layer.name)
        np.testing.assert_allclose(out[layer.name], ref_out[layer.name],
                                   **TOL, err_msg=layer.name)
    return out


@pytest.mark.parametrize("interleave", ["none", "rr", "priority"])
def test_joint_binary_is_the_references_and_runs_every_layer(interleave):
    """tests/test_multi_tenant.py:152-168 (joint) and
    tests/test_interleave.py:188-199 (rr) on the port: the tenant tags,
    the bytes, and every layer of both tenants."""
    port = _compile(P, _pair(P, interleave))
    ref = _compile(R, _pair(R, interleave))
    assert port.codegen.program.encode() == ref.codegen.program.encode()
    merged = _pair(P).merge()
    assert port.codegen.tenant_of == merged.tenant_of
    for m in port.codegen.meta:
        if m.layer_id >= 0:
            assert m.tenant == merged.tenant_of[m.layer_id]
    P.validate_stream(port.codegen)
    out = P.DoraCompiler().execute(port, port.graph.random_inputs(0),
                                   device="cpu")
    want = port.graph.reference_execute(port.graph.random_inputs(0))
    for layer in port.graph.layers:
        np.testing.assert_allclose(out[layer.name].numpy(), want[layer.name],
                                   **TOL, err_msg=layer.name)
    _run_both(port.graph, port.codegen)


@pytest.mark.parametrize("policy", ["rr", "priority"])
def test_interleave_stream_of_a_paper_pair_runs_every_layer(policy):
    """BERT-S + NCF-S (the benchmark's small_pair) compiled jointly, then
    reordered by ``interleave_stream``: the same permutation as the
    reference's, and the reordered binary computes every layer."""
    port = _compile(P, _scenario(P, paper_models, ("BERT-S", "NCF-S")))
    ref = _compile(R, _scenario(R, ref_models, ("BERT-S", "NCF-S")))
    assert port.codegen.program.encode() == ref.codegen.program.encode()
    prio = {0: 1.0, 1: 8.0}
    cg = P.interleave_stream(port.codegen, policy=policy, priorities=prio)
    rcg = R.interleave_stream(ref.codegen, policy=policy, priorities=prio)
    assert cg.program.encode() == rcg.program.encode()
    assert cg.program.encode() != port.codegen.program.encode()
    P.validate_stream(cg)
    _run_both(port.graph, cg)


def test_group_collision_guard_keeps_colliding_layers_apart():
    """tests/test_interleave.py:214-250 on the port: logical-group ids
    wrap every _GROUP_MOD / 4 layers; the interleaver keeps two colliding
    layers apart, and the torch runtime, whose LMU groups are keyed by
    those ids, computes the whole wide stream."""
    n_tenants = _GROUP_MOD // 4 + 2

    def wide(pkg):
        mt = pkg.MultiTenantWorkload("wide")
        for t in range(n_tenants):
            mt.add_tenant(f"t{t}", pkg.mlp_graph(f"g{t}", 16, [16, 16]))
        return mt

    port = _compile(P, wide(P), interleave="rr")
    ref = _compile(R, wide(R), interleave="rr")
    cg = port.codegen
    assert cg.program.encode() == ref.codegen.program.encode()
    P.validate_stream(cg)
    pos_of_layer: dict[int, list[int]] = {}
    for i, m in enumerate(cg.meta):
        pos_of_layer.setdefault(m.layer_id, []).append(i)
    wrap = _GROUP_MOD // 4
    assert len(pos_of_layer) == n_tenants
    checked = 0
    for lid in sorted(pos_of_layer):
        other = lid + wrap
        if other in pos_of_layer:
            assert max(pos_of_layer[lid]) < min(pos_of_layer[other])
            checked += 1
    assert checked == 2
    _run_both(port.graph, cg)


def test_two_pe_mesh_runs_each_pe_program():
    """small_trio (BERT-S, NCF-S, MLP-S) placed on a homogeneous two-PE
    mesh: the port's placement, each PE's binary and the mesh replay equal
    the reference's, and each PE's program runs on the torch runtime."""
    names = ("BERT-S", "NCF-S", "MLP-S")
    plat = P.DoraPlatform.vck190()
    port = P.DoraMeshCompiler(P.DoraMesh.homogeneous(2, plat),
                              P.Policy.dora()).compile(
        _scenario(P, paper_models, names), P.CompileOptions(engine="list"))
    rmc = R.DoraMeshCompiler(R.DoraMesh.homogeneous(2, R.DoraPlatform.vck190()),
                             R.Policy.dora())
    ref = rmc.compile(_scenario(R, ref_models, names),
                      R.CompileOptions(engine="list"))
    assert port.placement.assignment == ref.placement.assignment
    assert sorted(port.pe_results) == sorted(ref.pe_results) == [0, 1]
    assert port.dram_shares == ref.dram_shares
    for pe, res in port.pe_results.items():
        assert res.codegen.program.encode() == \
            ref.pe_results[pe].codegen.program.encode()
        _run_both(res.graph, res.codegen)
    sim = P.DoraMeshCompiler(port.mesh).simulate(port)
    assert sim.makespan_s == rmc.simulate(ref).makespan_s
    assert set(sim.pe_of_tenant) == set(names)


def test_architecture_template_search():
    """tests/test_system.py:102-112 on the port's arch_gen, and the same
    template and score as the reference's."""
    from repro.core.arch_gen import ArchTemplate as RefTemplate
    from repro.core.arch_gen import evaluate_template as ref_evaluate
    from repro_torch.core.arch_gen import ArchTemplate, evaluate_template
    graphs = [paper_models.bert_s(), paper_models.ncf_s()]
    kw = dict(mmu_options=(2, 6), lmu_options=(8, 14), sfu_options=(1, 3),
              area_budget=600.0)
    best, score = P.search_template(graphs, **kw)
    assert best.n_mmu in (2, 6) and score > 0
    small = evaluate_template(ArchTemplate(2, 8, 1), graphs)
    big = evaluate_template(ArchTemplate(6, 14, 3), graphs)
    assert big <= small * 1.001
    ref_graphs = [ref_models.bert_s(), ref_models.ncf_s()]
    ref_best, ref_score = R.search_template(ref_graphs, **kw)
    assert _plain(best) == _plain(ref_best) and score == ref_score
    assert small == ref_evaluate(RefTemplate(2, 8, 1), ref_graphs)


def _streams(pkg):
    a = pkg.mlp_graph("tiny_a", 16, [64, 64, 64])
    b = pkg.mlp_graph("tiny_b", 32, [128, 64])
    return [pkg.TenantStream("a", a, rps=2000.0),
            pkg.TenantStream("b", b, rps=2000.0)]


@pytest.mark.parametrize("dispatch", ["rounds", "preemptive"])
def test_serving_simulator_gives_the_references_run(dispatch):
    """One ``ServingSimulator`` run on the copies, seed 11, and the
    reference's: the same arrivals, dispatch and latencies."""
    def run(pkg):
        cfg = pkg.ServingConfig(horizon_s=0.004, seed=11, queue_capacity=4,
                                dispatch=dispatch)
        return pkg.ServingSimulator(pkg.DoraPlatform.vck190(),
                                    pkg.Policy.dora()).serve(_streams(pkg),
                                                             cfg)
    got, want = run(P), run(R)
    assert got.total_served > 0
    assert _plain(got.arrivals) == _plain(want.arrivals)
    assert _plain(got.requests) == _plain(want.requests)
    assert _plain(got.rounds) == _plain(want.rounds)
    assert _plain(got.stats) == _plain(want.stats)
    assert got.end_s == want.end_s


@pytest.mark.parametrize("target", ["workload", "streams"])
def test_autotune_gives_the_references_trials(target):
    """One ``autotune`` run on the copies and the reference's, on the
    static (makespan) and the serving (p99) objective."""
    def run(pkg):
        space = pkg.KnobSpace(vc_count=(1, 2), vc_arbitration=("fifo", "wfq"),
                              interleave=("none", "rr"),
                              share_aware_stage1=(False,),
                              latency_model=("analytic",))
        if target == "workload":
            mt = pkg.MultiTenantWorkload("tune_pair")
            for s in _streams(pkg):
                mt.add_tenant(s.name, s.graph)
            return pkg.autotune(mt, budget=4, space=space, seed=3)
        return pkg.autotune(_streams(pkg), budget=3, space=space, seed=1,
                            base_config=pkg.ServingConfig(horizon_s=0.004,
                                                          seed=9))
    got, want = run(P), run(R)
    assert got.objective == want.objective
    assert _plain(got.best) == _plain(want.best)
    assert got.best_objective_s == want.best_objective_s
    assert _plain(got.trials) == _plain(want.trials)


@pytest.mark.parametrize("arch, seq, blocks", [("qwen3-4b", 128, 3),
                                               ("whisper-medium", 192, 3),
                                               ("qwen2-vl-2b", 64, None)])
def test_from_arch_gives_the_references_graph(arch, seq, blocks):
    got = paper_models.from_arch(arch, seq=seq, blocks=blocks)
    want = ref_models.from_arch(arch, seq=seq, blocks=blocks)
    assert got.name == want.name
    assert got.inputs == want.inputs
    assert _plain(got.layers) == _plain(want.layers)
    assert got.total_flops == want.total_flops


def test_from_arch_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="attention\\+FFN"):
        paper_models.from_arch("mamba2-2.7b")
    with pytest.raises(ValueError, match="attention\\+FFN"):
        ref_models.from_arch("mamba2-2.7b")
