"""The port's compiler against the JAX package's: the same workload gives
the same candidate tables, the same schedule and the same binary, byte
for byte; the search engines reach the same makespans."""

import ast
import dataclasses
import enum
import pathlib

import numpy as np
import pytest

from repro.configs import paper_models as ref_models
from repro.core import (CompileOptions as RefOptions, DoraCompiler as RefCompiler,
                        GAConfig as RefGAConfig, Program as RefProgram,
                        mlp_graph as ref_mlp_graph, random_dag as ref_random_dag,
                        simulate as ref_simulate)
from repro_torch.configs import paper_models
from repro_torch.core import (CompileOptions, DoraCompiler, GAConfig, Program,
                              mlp_graph, random_dag, simulate)

MODELS = sorted(paper_models.ALL)
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _plain(obj):
    """Comparable form of compiler output from either package: dataclasses
    as (type name, fields), enums as (type name, value)."""
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


def _both(engine, graph, ref_graph, **kw):
    port = DoraCompiler().compile(graph, CompileOptions(engine=engine, **kw))
    ref = RefCompiler().compile(ref_graph, RefOptions(engine=engine, **kw))
    return port, ref


def _assert_same_compile(port, ref):
    assert _plain(port.candidates) == _plain(ref.candidates)
    assert _plain(port.schedule.entries) == _plain(ref.schedule.entries)
    assert port.schedule.makespan == ref.schedule.makespan
    assert port.codegen.memmap.by_name == ref.codegen.memmap.by_name
    assert port.codegen.program.encode() == ref.codegen.program.encode()


@pytest.mark.parametrize("engine", ["list", "sequential"])
@pytest.mark.parametrize("model", MODELS)
def test_paper_models_compile_to_identical_binaries(model, engine):
    port, ref = _both(engine, paper_models.get(model), ref_models.get(model))
    _assert_same_compile(port, ref)


@pytest.mark.parametrize("engine", ["list", "sequential"])
@pytest.mark.parametrize("seed", [0, 7, 123, 4242])
def test_random_dags_compile_to_identical_binaries(seed, engine):
    n = 2 + seed % 5
    port, ref = _both(engine, random_dag(n, seed=seed, max_dim=256),
                      ref_random_dag(n, seed=seed, max_dim=256))
    _assert_same_compile(port, ref)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_milp_reaches_the_same_optimal_makespan(seed):
    port, ref = _both("milp", random_dag(4, seed=seed, max_dim=128),
                      ref_random_dag(4, seed=seed, max_dim=128),
                      time_budget_s=20.0)
    assert port.optimal and ref.optimal
    assert port.makespan_s == pytest.approx(ref.makespan_s, rel=1e-12)


def test_ga_reaches_the_same_makespan():
    """Seeded GA with a generation cap and no binding time budget is
    deterministic, so both packages evolve the same population."""
    ga = GAConfig(population=16, generations=8, time_budget_s=600.0)
    ref_ga = RefGAConfig(population=16, generations=8, time_budget_s=600.0)
    g, rg = random_dag(5, seed=11, max_dim=128), ref_random_dag(5, seed=11,
                                                                max_dim=128)
    port = DoraCompiler().compile(g, CompileOptions(engine="ga", ga=ga))
    ref = RefCompiler().compile(rg, RefOptions(engine="ga", ga=ref_ga))
    assert port.makespan_s == ref.makespan_s
    assert port.codegen.program.encode() == ref.codegen.program.encode()


def test_isa_decodes_the_reference_binary_byte_exactly():
    raw = RefCompiler().compile(ref_models.get("BERT-S"),
                                RefOptions(engine="list")
                                ).codegen.program.encode()
    assert Program.decode(raw).encode() == raw
    assert RefProgram.decode(raw).encode() == raw


def test_simulator_gives_the_same_timing():
    port, ref = _both("list", mlp_graph("m", 128, [128, 256, 64]),
                      ref_mlp_graph("m", 128, [128, 256, 64]))
    p, r = simulate(port.codegen, port.platform), ref_simulate(ref.codegen,
                                                               ref.platform)
    assert p.makespan_s == r.makespan_s
    assert p.instr_start == r.instr_start and p.instr_end == r.instr_end


COPIES = ("graph", "isa", "perf_model", "schedule", "partition", "milp",
          "ga", "codegen", "interleave", "multi_tenant", "simulator",
          "arch_gen", "mesh", "serving", "tuning")


def _code(path):
    """The module's syntax tree without docstrings (comments are not in
    it): what the copy must keep equal to the reference."""
    return _code_tree(ast.parse(path.read_text()))


@pytest.mark.parametrize("module", COPIES)
def test_numpy_core_modules_are_code_identical_copies(module):
    """The port carries these modules with the reference's code (they
    import no JAX; their imports are relative); a drift here would break
    the byte-identical binaries above."""
    assert _code(SRC / "repro_torch" / "core" / f"{module}.py") == \
        _code(SRC / "repro" / "core" / f"{module}.py")


CONFIG_COPIES = ["models/config"] + [
    f"configs/{m}" for m in ("dbrx_132b", "internlm2_20b", "jamba_1_5_large",
                             "llama4_maverick", "mamba2_2_7b", "nemotron_4_15b",
                             "qwen1_5_4b", "qwen2_vl_2b", "qwen3_4b", "whisper_medium")]


def _code_without_imports(path):
    """``_code`` with the module's import statements left out: the copies
    import ``ArchConfig`` from the port's package."""
    tree = ast.parse(path.read_text())
    tree.body = [n for n in tree.body
                 if not isinstance(n, (ast.Import, ast.ImportFrom))]
    return _code_tree(tree)


def _code_tree(tree):
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    return ast.dump(tree)


@pytest.mark.parametrize("module", CONFIG_COPIES)
def test_config_modules_are_code_identical_copies(module):
    """``ArchConfig`` and the ten arch files carry the reference's code;
    only their imports differ."""
    port = _code_without_imports(SRC / "repro_torch" / f"{module}.py")
    assert port == _code_without_imports(SRC / "repro" / f"{module}.py")
    assert "ArchConfig" in (SRC / "repro_torch" / f"{module}.py").read_text()


def test_paper_models_are_code_identical_copies():
    """``configs/paper_models.py``, ``from_arch`` included, carries the
    reference's code; only its imports differ, at module level and inside
    ``_vit`` and ``from_arch`` (the port's ``core`` and config registry)."""
    def code(path):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            body = getattr(node, "body", None)
            if isinstance(body, list):
                node.body = [n for n in body if not isinstance(
                    n, (ast.Import, ast.ImportFrom))]
        return _code_tree(tree)

    module = "configs/paper_models.py"
    assert code(SRC / "repro_torch" / module) == code(SRC / "repro" / module)
    text = (SRC / "repro_torch" / module).read_text()
    assert "def from_arch(" in text and "from repro_torch.configs import" \
        in text
