"""The port's multi-pod dry run (``repro_torch.launch.dryrun``) on small
fake meshes.

Every ``SHAPES`` cell of reduced qwen3-4b, mamba2-2.7b and
whisper-medium (the input shapes at their full size, on ``meta``) runs
over a fake process group on a (2, 2) and a (2, 2, 2) mesh with the
reference's axis names.  A cell is "ok", or "skipped" with the
reference's reason (long_500k on a pure-attention arch); its
``memory.argument_bytes`` equals the local shard bytes of the step's
abstract arguments under their shardings, counted here from the shapes;
a train cell traces at least the useful FLOPs of its step a chip (6 N
tokens / chips), and every cell traces some FLOPs and bytes.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import applicable as ref_applicable
from repro.configs import get_config as ref_get_config
from repro_torch import tree as T
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.steps import make_step
from repro_torch.parallel.sharding import NamedSharding

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ["qwen3-4b", "mamba2-2.7b", "whisper-medium"]
MESHES = {"2x2": (2, 2), "2x2x2": (2, 2, 2)}


def test_cli_has_the_reference_flags():
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--help"], capture_output=True, text=True,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                        "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    for flag in ("--arch", "--shape", "--mesh", "--out"):
        assert flag in out.stdout


def _shard_bytes(tree, shardings) -> int:
    """Local bytes of ``tree``'s tensors under ``shardings``, from the
    shapes alone."""
    total = 0
    sh_leaves = (T.leaves(shardings) if shardings is not None
                 else [None] * len(T.leaves(tree)))
    for t, sh in zip(T.leaves(tree), sh_leaves):
        if not isinstance(t, torch.Tensor):
            continue
        n = t.numel() * t.element_size()
        if isinstance(sh, NamedSharding):
            for md, p in enumerate(sh.placements):
                if p.is_shard():
                    n //= sh.mesh.size(md)
        total += n
    return total


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_cell(arch, shape, mesh):
    cfg = get_config(arch, reduced=True)
    dims = MESHES[mesh]
    rec = dryrun.run_cell(arch, shape, len(dims) == 3, None, verbose=False,
                          cfg=cfg, mesh_shape=dims)
    ok, reason = ref_applicable(ref_get_config(arch, reduced=True),
                                REF_SHAPES[shape])
    if not ok:
        assert rec["status"] == "skipped" and rec["reason"] == reason
        return
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_chips"] == (8 if len(dims) == 3 else 4)
    dryrun.start_fake_world(rec["n_chips"])
    try:
        from torch.distributed.device_mesh import init_device_mesh
        m = init_device_mesh("cpu", dims,
                             mesh_dim_names=dryrun.MESHES[len(dims) == 3][1])
        bundle = make_step(cfg, m, SHAPES[shape], plain=True, device="meta")
        want = sum(_shard_bytes(a, sh) for a, sh in
                   zip(bundle.abstract_args, bundle.in_shardings))
    finally:
        torch.distributed.destroy_process_group()
    assert rec["memory"]["argument_bytes"] == want
    roof = rec["roofline"]
    assert roof["flops_per_chip"] > 0 and roof["hbm_bytes_per_chip"] > 0
    if SHAPES[shape].kind == "train":
        assert roof["flops_per_chip"] >= rec["model_flops_per_chip"]
        assert rec["collectives"]["link_bytes_per_chip"] > 0
