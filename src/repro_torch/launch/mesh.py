"""Device meshes: port of ``repro.launch.mesh`` on
``torch.distributed.device_mesh.DeviceMesh``, with the reference's axis
names (``mesh_dim_names``).

Functions, not module constants: importing this module starts no process
group.  The reference's production target is TPU v5e pods, 16x16 = 256
chips a pod (data x model), two pods = 512 chips with a leading "pod"
axis; the port keeps those shapes for the dry run
(``launch.dryrun``, over a fake process group of 256 or 512 ranks).

``make_local_mesh`` takes whatever world exists, or starts a world of one
where none does: NCCL over a ``HashStore`` on the card, gloo with
``device="cpu"``.  Under ``torchrun`` (``WORLD_SIZE`` > 1 in the
environment) it starts the launcher's world.  NCCL takes one rank a
card, so on one H100 the mesh is (1, 1); ``join_world`` joins processes
started together on one host (rank r on card r) through a ``FileStore``,
as ``chip_smoke.py --cards 4`` starts its four ranks.  ``cli_mesh`` is
the CLIs' ``--model-axis``.
"""

from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..convert import resolve_device


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: start one (a fake world for "
                           "the dry run, torch.distributed.init_process_"
                           "group otherwise) before building the mesh")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> DeviceMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model") with ``multi_pod``, over the world that exists, whose size
    must be 256 or 512: the mesh is never shrunk to fit.  On the card
    unless ``device_type`` names another; raises without one."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = _world()
    need = 512 if multi_pod else 256
    if n != need:
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{need}, got {n}")
    return init_device_mesh(resolve_device(device_type).type, shape,
                            mesh_dim_names=axes)


def start_world(device: str | torch.device | None = None,
                timeout_s: float = 600.0) -> torch.device:
    """Start the process group where none is: the launcher's world under
    ``torchrun``, else a world of one (NCCL on the card, gloo on the
    CPU).  Returns the device the mesh lives on."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return dev
    backend = "nccl" if dev.type == "cuda" else "gloo"
    timeout = timedelta(seconds=timeout_s)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend, timeout=timeout)
        return dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1, timeout=timeout)
    return dev


def join_world(rank: int, world: int, store: str,
               device: str | torch.device | None = None,
               timeout_s: float = 600.0) -> torch.device:
    """Join a world of ``world`` processes started together on one host,
    as rank ``rank``, through a ``FileStore`` at ``store`` (no port):
    NCCL on the cards, rank r on card r, which becomes this process's
    card before anything is allocated on it; gloo with ``device="cpu"``.
    Returns the rank's device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    return dev


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of ``mesh``: its card (the process's current
    one, which ``start_world`` / ``join_world`` set) or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_local_mesh(model_axis: int = 1,
                    device: str | torch.device | None = None) -> DeviceMesh:
    """Whatever ranks exist, as (data, model) = (world / model_axis,
    model_axis), on the card (``device=None``; raises without one) or on
    the CPU (``device="cpu"``): used by the trainer's and the server's
    mesh, the tests and single-host training."""
    dev = start_world(device)
    n = dist.get_world_size()
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"model_axis={model_axis} does not divide the "
                         f"world of {n}")
    return init_device_mesh(dev.type, (n // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))


def make_pe_mesh(n_pes: int, device_type: str | None = None) -> DeviceMesh:
    """Whatever ranks exist, as (pe, data): one ``pe`` slot a DORA PE,
    the twin of ``core.mesh.DoraMesh``.  ``n_pes`` must divide the
    world.  On the card unless ``device_type`` names another; raises
    without one."""
    if n_pes < 1:
        raise ValueError(f"n_pes must be >= 1, got {n_pes}")
    n = _world()
    if n % n_pes:
        raise ValueError(f"n_pes={n_pes} does not divide the "
                         f"{n} available devices")
    return init_device_mesh(resolve_device(device_type).type,
                            (n_pes, n // n_pes),
                            mesh_dim_names=("pe", "data"))


def cli_mesh(model_axis: int, device: str | torch.device | None = None
             ) -> DeviceMesh | None:
    """The CLIs' ``--model-axis``: ``make_local_mesh(model_axis, device)``,
    or None for 0 in a world of one.  A launcher's world of more ranks
    (``WORLD_SIZE`` > 1) without a mesh raises: each rank would run its
    own meshless copy, as the reference never does."""
    if model_axis:
        return make_local_mesh(model_axis, device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise ValueError(f"a world of {world} ranks without a mesh: pass "
                         f"--model-axis m (m dividing {world}) to lay the "
                         f"model over the ranks")
    return None
