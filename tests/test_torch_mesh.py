"""The port's serving path on real gloo meshes of CPU processes: the
sharded port against the meshless port on the same parameters (the
meshless port is held against the JAX package by the other test files).

Each test starts one world of 4 ranks (``run_world`` below, which the
other multi-rank test files import), a (2, 2), (1, 4) or (4, 1) (data,
model) mesh, and checks there, on reduced
configs (fp32 compute) with the plain versions, that the prefill and
decode bundles (``launch.steps``) give the meshless logits within
max |err| <= 1e-5 · max |logit|, and that ``BatchServer`` on the mesh
serves the meshless server's greedy tokens.  qwen2-vl-2b is cut to one
KV head, so that its KV heads do not split over the model axis (they are
replicated, and the decode cache takes the sequence-parallel layout);
dbrx-132b's experts split over the model axis.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent


def run_world(test_file: str, case: str, world: int, tmp_path,
              timeout: float = 240.0, **kwargs) -> None:
    """Run ``case(**kwargs)`` of ``test_file`` in a world of ``world`` CPU
    processes joined by gloo over a ``FileStore`` in ``tmp_path`` (no TCP
    port, so parallel test workers never collide).  Every rank asserts
    for itself; the call fails with the output of the first rank that
    failed, and stops the others."""
    store = Path(tmp_path) / f"store_{case}_{time.monotonic_ns()}"
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests"),
                    os.environ.get("PYTHONPATH", "")]))
    logs = [Path(tmp_path) / f"{case}_rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, test_file, case, str(r),
                 str(world), str(store), json.dumps(kwargs)],
                env=env, stdout=out, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.poll() not in (None, 0)]
            if bad:
                failed = bad[0]
                break
            if time.monotonic() > deadline:
                failed = -1
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed is None:
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        failed = bad[0] if bad else None
    if failed == -1:
        raise AssertionError(f"{case}: the world of {world} ran past "
                             f"{timeout} s")
    if failed is not None:
        raise AssertionError(f"{case}: rank {failed} failed:\n"
                             + logs[failed].read_text()[-6000:])


def _worker() -> None:
    from datetime import timedelta

    import torch.distributed as dist

    test_file, case, rank, world, store, kwargs = sys.argv[1:]
    rank, world = int(rank), int(world)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=90))
    try:
        spec = importlib.util.spec_from_file_location("_case_module",
                                                      test_file)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        getattr(mod, case)(**json.loads(kwargs))
    finally:
        dist.destroy_process_group()


TOL = 1e-5
# arch -> (fields replaced in its reduced config, mesh)
SERVE = {
    "qwen3-4b": ({}, (2, 2)),
    "qwen2-vl-2b": ({"n_kv_heads": 1}, (2, 2)),
    "mamba2-2.7b": ({}, (2, 2)),
    "dbrx-132b": ({}, (2, 2)),
    "whisper-medium": ({}, (2, 2)),
    "qwen2-vl-2b-1x4": ({"n_kv_heads": 2}, (1, 4)),
    "qwen3-4b-4x1": ({}, (4, 1)),
}


def _close(got, want, what):
    got = got.full_tensor() if hasattr(got, "full_tensor") else got
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= TOL * scale, (what, err, scale)


def _case_serve(arch: str) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.serve import BatchServer, Request
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import encdec, lm
    from repro_torch.parallel import sharding as SH

    fields, shape = SERVE[arch]
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(
        get_config(arch.split("-1x4")[0].split("-4x1")[0], reduced=True),
        **fields)
    model = encdec if cfg.is_encdec else lm
    params = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    B, S, L = 4, 8, 12
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    batch = {"tokens": tok}
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((B, S, cfg.d_model)).astype(np.float32))

    def prefill(p, b, max_len):
        if cfg.is_encdec:
            return encdec.prefill(cfg, p, b["frames"], b["tokens"], max_len,
                                  plain=True)
        return lm.prefill(cfg, p, b["tokens"], max_len, plain=True)

    # the prefill bundle: the cache holds the prompt alone
    bundle = make_prefill_step(cfg, mesh, ShapeSpec("p", S, B, "prefill"),
                               plain=True)
    want, want_cache = prefill(params, batch, S)
    got, got_cache = bundle(*bundle.place(params, batch))
    _close(got, want, "prefill bundle")
    for name, t in SH.full(got_cache).items() if cfg.is_encdec else []:
        _close(t, want_cache[name], name)

    # the decode bundle on a cache laid out by the same rules
    dec = make_decode_step(cfg, mesh, ShapeSpec("d", L, B, "decode"),
                           plain=True)
    p_mesh, = dec.place(params)
    want, cache = prefill(params, batch, L)
    rows = {k: SH.place(v, dec.rules.sharding_for(
        ("batch",) + (None,) * (v.dim() - 1), tuple(v.shape)))
        for k, v in batch.items()}
    with SH.use_rules(dec.rules):
        got, got_cache = prefill(p_mesh, rows, L)
    _close(got, want, "prefill on the decode layout")
    step = want.argmax(-1)[:, None]
    for pos in range(S, L):
        want, cache = model.decode_step(cfg, params, cache, step, pos,
                                        plain=True)
        tok_sh = dec.in_shardings[2]
        got, got_cache = dec(p_mesh, got_cache, SH.place(step, tok_sh), pos)
        _close(got, want, f"decode at {pos}")
        step = want.argmax(-1)[:, None]

    if not cfg.is_encdec:
        reqs = [Request(i, tok[i, :S - i].numpy(), 4) for i in range(B)]
        again = [Request(i, tok[i, :S - i].numpy(), 4) for i in range(B)]
        meshless = BatchServer(cfg, max_len=16, device="cpu", params=params)
        served = BatchServer(cfg, max_len=16, device="cpu", params=params,
                             mesh=mesh)
        assert served.serve(reqs)["outputs"] == \
            meshless.serve(again)["outputs"]


@pytest.mark.parametrize("arch", list(SERVE))
def test_sharded_serving_matches_the_meshless_port(arch, tmp_path):
    run_world(__file__, "_case_serve", 4, tmp_path, arch=arch)


if __name__ == "__main__":
    _worker()
