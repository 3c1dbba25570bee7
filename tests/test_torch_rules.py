"""The port's package rules: it, its examples and its experiments import
neither JAX nor the JAX package, its entry points run on the CUDA card
unless the caller names another device (and raise where there is none),
its C entry points match the wrappers' ctypes signatures, and
``chip_smoke.py`` fails without a card or without the rest of the
repository."""

import ast
import importlib
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, paper_models
from repro_torch.convert import inputs_to_torch, params_from_jax, resolve_device
from repro_torch.core import CompileOptions, DoraCompiler, DoraRuntime
from repro_torch.kernels import _build
from repro_torch.launch.serve import BatchServer
from repro_torch.models import lm

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    return (sorted(PORT.rglob("*.py")) + sorted(
        (ROOT / "examples_torch").glob("*.py")) + sorted(
        (ROOT / "experiments_torch").glob("*.py")) + [ROOT / "chip_smoke.py"])


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.partition(".")[0] not in FORBIDDEN, (path, name)


def test_port_imports_with_jax_and_repro_blocked():
    code = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in ("jax", "jaxlib", "repro"):
            raise ModuleNotFoundError(name)
sys.meta_path.insert(0, Block())
import repro_torch, repro_torch.convert, repro_torch.kernels
from repro_torch.configs import paper_models
from repro_torch.core import CompileOptions, DoraCompiler
g = paper_models.get("BERT-S")
res = DoraCompiler().compile(g, CompileOptions(engine="list"))
out = DoraCompiler().execute(res, g.random_inputs(0), device="cpu")
assert set(l.name for l in g.layers) <= set(out)
import numpy as np
from repro_torch.configs import get_config
from repro_torch.launch.serve import BatchServer, Request
for arch in ("qwen3-4b", "mamba2-2.7b"):
    stats = BatchServer(get_config(arch, reduced=True), max_len=16,
                        device="cpu").serve(
        [Request(0, np.arange(5, dtype=np.int32), 3)])
    assert len(stats["outputs"][0]) == 3
print("ok")
"""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = paper_models.get("MLP-S")
    res = DoraCompiler().compile(g, CompileOptions(engine="list"))
    with pytest.raises(RuntimeError, match="CUDA"):
        DoraCompiler().execute(res, g.random_inputs(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        DoraRuntime(res.codegen.memmap)
    with pytest.raises(RuntimeError, match="CUDA"):
        inputs_to_torch(g.random_inputs(0), res.codegen.memmap)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    cfg = get_config("qwen3-4b", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchServer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchServer(get_config("mamba2-2.7b", reduced=True))
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax(cfg, {})
    assert resolve_device("cpu") == torch.device("cpu")


def test_inputs_cross_as_exact_fp32_copies():
    g = paper_models.get("NCF-S")
    res = DoraCompiler().compile(g, CompileOptions(engine="list"))
    inputs = g.random_inputs(5)
    moved = inputs_to_torch(inputs, res.codegen.memmap, "cpu")
    for name, arr in inputs.items():
        assert moved[name].dtype == torch.float32
        assert moved[name].is_contiguous()
        np.testing.assert_array_equal(moved[name].numpy(), arr)
        assert moved[name].data_ptr() != arr.ctypes.data   # a copy


def _c_entry_points(source: str) -> dict[str, int]:
    """extern "C" entry point -> parameter count, from a .cu source."""
    found = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', source):
        found[m.group(1)] = len(m.group(2).split(","))
    return found


@pytest.mark.parametrize("name", _build.SOURCES)
def test_ctypes_signatures_match_the_c_entry_points(name):
    signatures = importlib.import_module(
        f"repro_torch.kernels.{name}")._SIGNATURES
    entries = _c_entry_points((_build.CSRC / f"{name}.cu").read_text())
    assert entries == {fn: len(args) for fn, args in signatures.items()}


def test_build_targets_hopper_and_keys_on_the_sources():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
    gitignore = (ROOT / ".gitignore").read_text().split()
    assert str(_build.BUILD_DIR.relative_to(ROOT)) + "/" in gitignore


def test_ptxas_usage_reads_registers_and_spills_of_each_kernel():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123flash_bwd_kv_mma_kernelILi128EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123flash_bwd_kv_mma_kernelILi128EEEvPK13__nv_bfloat16
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 212 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z17column_sum_kernelILi4EEvPKfPfii' for 'sm_90a'
ptxas info    : Function properties for _Z17column_sum_kernelILi4EEvPKfPfii
    24 bytes stack frame, 16 bytes spill stores, 28 bytes spill loads
ptxas info    : Used 30 registers, used 1 barriers, 16384 bytes smem
"""
    assert _build.ptxas_usage(log) == {
        "_ZN12_GLOBAL__N_123flash_bwd_kv_mma_kernelILi128EEEvPK13__nv_bfloat16":
            (212, 0, 0),
        "_Z17column_sum_kernelILi4EEvPKfPfii": (30, 16, 28)}
    assert "-v" in _build.NVCC_FLAGS and _build.ptxas_usage("") == {}


def test_build_keeps_each_log_beside_its_library(tmp_path, monkeypatch):
    # a stand-in for nvcc that writes the library and prints a ptxas line
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys\n"
                    "open(sys.argv[sys.argv.index('-o') + 1], 'w').close()\n"
                    "print(\"ptxas info    : Compiling entry function "
                    "'_Z1kv' for 'sm_90a'\")\n"
                    "print('ptxas info    : Used 40 registers')\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.build_log("sfu") == ""
    (lib,) = _build.build(("sfu",))
    assert lib.exists() and _build.ptxas_usage(
        _build.build_log("sfu")) == {"_Z1kv": (40, 0, 0)}
    # a built library is not rebuilt, and its log is still read
    fake.unlink()
    assert _build.build(("sfu",)) == [lib]
    assert _build.ptxas_usage(
        _build.build_log("sfu")) == {"_Z1kv": (40, 0, 0)}
    assert sorted(p.name for p in lib.parent.iterdir()) == sorted(
        [lib.name, lib.with_suffix(".log").name])


def _smoke(cwd, extra_env=None):
    env = {**os.environ, **(extra_env or {})}
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_card():
    proc = _smoke(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_without_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
