"""Builds the port's CUDA sources and loads them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into ``build/lib<name>-<digest>.so`` beside this file, at first use.  The
sources expose a plain C interface and include no PyTorch header, so a
build takes seconds; the wrappers pass pointers and the stream as
``c_void_p`` and raise when an entry point returns a CUDA error.  The
digest covers the sources and the flags, so an edited source is rebuilt
and a stale library is never loaded.  ``build`` starts one ``nvcc`` per
source, all at once, and keeps each log beside its library: ``ptxas -v``
prints every kernel's registers and spills there (``ptxas_usage`` reads
them from ``build_log``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
SOURCES = ("flex_gemm", "sfu", "flash_attention", "ssd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# activation codes of csrc/act.cuh
ACT_CODE = {"none": 0, "gelu": 1, "relu": 2, "relu2": 3, "silu": 4}

_LOADED: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the "
                       "CUDA toolkit to build")


def library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def nvcc_command(name: str, out: Path) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names: tuple[str, ...] = SOURCES) -> list[Path]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` each, in parallel; returns the library paths."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs = [library_path(n) for n in names]
    procs = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((name, out, tmp, subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            tmp.with_suffix(".log").write_text(log)
            # atomic: readers never see half a file, nor a library without
            # its log
            os.replace(tmp.with_suffix(".log"), out.with_suffix(".log"))
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return outs


def build_log(name: str) -> str:
    """nvcc's output for the built library of ``csrc/<name>.cu`` ("" where
    it is not built)."""
    path = library_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def ptxas_usage(log: str) -> dict[str, tuple[int, int, int]]:
    """``{mangled kernel name: (registers, spill store bytes, spill load
    bytes)}`` from the ``ptxas -v`` lines of an nvcc log."""
    usage, name, spills = {}, None, (0, 0)
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            name, spills = m.group(1), (0, 0)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            usage[name] = (int(m.group(1)), *spills)
            name = None
    return usage


def load(name: str, signatures: dict[str, tuple]) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, built on first use, with
    ``argtypes`` set from ``signatures`` (entry point -> ctypes types) and
    every entry point returning a C int (the CUDA error code)."""
    lib = _LOADED.get(name)
    if lib is None:
        (path,) = build((name,))
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _LOADED[name] = lib
    return lib


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device, which the kernels'
    launch plans fill."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def needs_grad(*tensors) -> bool:
    """Whether autograd records a call on ``tensors``: grad mode is on and
    one of them (None skipped) requires grad."""
    import torch
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_dtensor(what: str, *tensors) -> None:
    """Raise where a DTensor reaches a kernel wrapper: the kernels read
    ``data_ptr()`` and cannot see one, and the plain version is no
    fallback for it.  ``kernels.ops`` hands each rank's tensors over
    (``local_map``)."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{what} takes this rank's tensors, not a DTensor: "
                        f"call it through repro_torch.kernels.ops")


def refuse_grad(what: str, *tensors) -> None:
    """Raise where autograd would record a call to a kernel that has no
    backward yet: its output would carry no gradient to its inputs.  The
    kernels that raise: ``softmax_rows``, ``act_rows``, ``flex_gemm`` and
    flash attention's decode path (rmsnorm, layernorm, flash attention's
    prefill and ``ssd`` have backward kernels)."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{what}: its CUDA kernel has no backward yet (ROADMAP A.5b: "
            f"softmax_rows, act_rows, flex_gemm and flash attention's "
            f"decode path have none; no training path reaches them), so "
            f"autograd would get no gradient through it; call it under "
            f"torch.no_grad() or on tensors that do not require grad")


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error "
                           f"{err}")
