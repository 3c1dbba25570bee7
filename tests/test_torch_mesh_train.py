"""The port's training path on real gloo meshes of CPU processes: the
sharded ``Trainer`` against the meshless one on the same seed, and its
checkpoints across meshes.

Each test starts worlds of 4 ranks (``test_torch_mesh.run_world``).  On a
(2, 2) (data, model) mesh (qwen3-4b also on (4, 1)), with reduced configs (fp32 compute), one step
of ``Trainer(..., mesh=)`` gives the meshless loss within 1e-6 relative,
every first moment (0.1 of the gradient) within 1e-5 · max |m| (plus one
bf16 ulp of the element for dbrx's bf16 moments) and every
parameter within 1e-5 · max |p| of its leaf (at lr 1e-4: AdamW's first
step moves an element by about lr · sign(g), so a gradient element near
0, summed in another order, can move it by up to 2 lr); the step-1
checkpoint it saves holds its parameters and moments bit for bit,
restores onto no mesh bit for bit, and restores onto a (4, 1) mesh of a
second world bit for bit.  dbrx-132b runs with FSDP (its config's
``fsdp``; the reduced config turns it off) and its experts on the model
axis; the moments are ZeRO-1's ("embed" over data).
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from test_torch_mesh import run_world

# arch -> (fields replaced in its reduced config, the training mesh); on
# (4, 1) the vocab is whole on every rank and each rank looks its tokens up
ARCHS = {"qwen3-4b": ({}, (2, 2)), "dbrx-132b": ({"fsdp": True}, (2, 2)),
         "whisper-medium": ({}, (2, 2)), "mamba2-2.7b": ({}, (2, 2)),
         "qwen3-4b-4x1": ({}, (4, 1))}


def _setup(arch: str, ckpt_dir: str, shape):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.train import Trainer, TrainOptions
    from repro_torch.optim.adamw import OptConfig

    cfg = dataclasses.replace(
        get_config(arch.removesuffix("-4x1"), reduced=True), **ARCHS[arch][0])
    opt = OptConfig(peak_lr=1e-4, warmup_steps=1, total_steps=10)
    spec = ShapeSpec("t", 8, 4, "train")

    def trainer(mesh_shape, ckpt_every):
        mesh = None if mesh_shape is None else init_device_mesh(
            "cpu", mesh_shape, mesh_dim_names=("data", "model"))
        return Trainer(cfg, spec, opt, TrainOptions(
            steps=1, ckpt_every=ckpt_every, ckpt_dir=ckpt_dir,
            log_every=100), device="cpu", mesh=mesh)

    return trainer(shape, 1), trainer(None, 0)


def _equal(a, b):
    from repro_torch import tree as T
    for (k, x), y in zip(T.leaves_with_paths(a), T.leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def _case_train(arch: str, ckpt_dir: str) -> None:
    from torch.distributed.tensor import Shard

    from repro_torch import checkpoint as ckpt
    from repro_torch import tree as T
    from repro_torch.parallel.sharding import full

    sharded, meshless = _setup(arch, ckpt_dir, ARCHS[arch][1])
    pm, om = sharded.run(resume=False)
    pr, orf = meshless.run(resume=False)
    for a, b in zip(sharded.metrics_log, meshless.metrics_log):
        assert abs(a["loss"] - b["loss"]) <= 1e-6 * abs(b["loss"]), (a, b)
    got = full({"params": pm, "opt": om})
    for part, want in (("params", pr), ("opt", orf["m"])):
        have = got[part] if part == "params" else got["opt"]["m"]
        for (k, x), y in zip(T.leaves_with_paths(have), T.leaves(want)):
            x, y = x.detach().float(), y.detach().float()
            tol = 1e-5 * float(y.abs().max())
            if want is not pr and orf["m"]["embed"].dtype == torch.bfloat16:
                tol = tol + y.abs() * 2.0 ** -7    # one bf16 ulp
            assert bool(((x - y).abs() <= tol).all()), (part, k)
    # ZeRO-1: a moment of a replicated matrix splits its "embed" over data
    assert isinstance(om["m"]["lm_head"].placements[0], Shard)
    if not ARCHS[arch][0].get("fsdp"):      # FSDP shards the parameter too
        assert not isinstance(pm["lm_head"].placements[0], Shard)
    restored, extra = ckpt.restore(ckpt_dir, 1, {"params": pr, "opt": orf})
    assert extra["next_step"] == 1
    _equal(restored, got)


def _case_restore(arch: str, ckpt_dir: str) -> None:
    from repro_torch import checkpoint as ckpt
    from repro_torch.parallel.sharding import full

    sharded, meshless = _setup(arch, ckpt_dir, (4, 1))
    params, opt_state, step = sharded.init_state()
    params, opt_state, step = sharded.try_resume(params, opt_state, step)
    assert step == 1
    assert params["embed"].device_mesh.shape == (4, 1)
    p0, o0, _ = meshless.init_state()
    want, _ = ckpt.restore(ckpt_dir, 1, {"params": p0, "opt": o0})
    _equal(full({"params": params, "opt": opt_state}), want)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_sharded_training_and_checkpoints_across_meshes(arch, tmp_path):
    ckpt_dir = str(tmp_path / "ckpt")
    run_world(__file__, "_case_train", 4, tmp_path, arch=arch,
              ckpt_dir=ckpt_dir)
    run_world(__file__, "_case_restore", 4, tmp_path, arch=arch,
              ckpt_dir=ckpt_dir)


def _case_global_norm() -> None:
    """``clip_by_global_norm`` over shards: one all-reduce of the squares
    each rank owns, a replicated leaf counted once, and each shard scaled
    by the meshless factor."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.optim import adamw
    from repro_torch.parallel.sharding import make_rules, place, full

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rules = make_rules(None, mesh)
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(8, 6, generator=gen),
            "b": torch.randn(5, generator=gen) * 3,
            "c": torch.randn(4, 8, generator=gen)}
    specs = {"a": ("batch", None), "b": (None,), "c": ("mlp", "vocab")}
    sharded = {k: place(t, rules.sharding_for(specs[k], tuple(t.shape)))
               for k, t in tree.items()}
    assert [len({str(p) for p in sharded[k].placements}) for k in "abc"] \
        == [2, 1, 2]
    want, want_norm = adamw.clip_by_global_norm(tree, 1.0)
    got, got_norm = adamw.clip_by_global_norm(sharded, 1.0)
    assert float(got_norm) == pytest.approx(float(want_norm), rel=1e-6)
    for k, t in full(got).items():
        assert torch.allclose(t, want[k], rtol=1e-6, atol=0), k


def test_global_norm_counts_each_shard_once(tmp_path):
    run_world(__file__, "_case_global_norm", 4, tmp_path)


def _case_save_leaf_by_leaf(ckpt_dir: str) -> None:
    """``save`` and ``AsyncSaver.save`` of a sharded tree gather one leaf
    at a time: no two gathered leaves are alive at once, rank 0 alone
    keeps the host copies, and both checkpoints restore bit for bit."""
    import weakref

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch import checkpoint as ckpt
    from repro_torch import tree as T
    from repro_torch.checkpoint import ckpt as ckpt_module
    from repro_torch.parallel.sharding import distribute, make_rules

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    rules = make_rules(None, mesh)
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(8, 6, generator=gen),
            "b": {"c": torch.randn(4, 8, generator=gen),
                  "d": torch.randn(6, generator=gen)}}
    specs = {"a": ("batch", None), "b": {"c": ("mlp", "vocab"),
                                         "d": ("batch",)}}
    sharded = distribute(tree, specs, rules)
    live, peak, shapes = [0], [0], []
    gather = DTensor.full_tensor

    def counted(self, **kwargs):
        out = gather(self, **kwargs)
        live[0] += 1
        peak[0] = max(peak[0], live[0])
        shapes.append(tuple(out.shape))
        weakref.finalize(out, lambda: live.__setitem__(0, live[0] - 1))
        return out

    DTensor.full_tensor = counted
    try:
        host = ckpt_module._to_host(sharded)
        ckpt.save(ckpt_dir, 1, sharded)
        saver = ckpt.AsyncSaver()
        saver.save(ckpt_dir, 2, sharded)
        saver.wait()
    finally:
        DTensor.full_tensor = gather
    assert peak[0] == 1 and live[0] == 0, (peak, live)
    assert shapes == [tuple(t.shape) for t in T.leaves(tree)] * 3
    if dist.get_rank() == 0:
        _equal(host, tree)
    else:
        assert host is None and saver._thread is None
    for step in (1, 2):
        restored, _ = ckpt.restore(ckpt_dir, step, tree)
        _equal(restored, tree)


def test_checkpoint_gathers_one_leaf_at_a_time(tmp_path):
    run_world(__file__, "_case_save_leaf_by_leaf", 4, tmp_path,
              ckpt_dir=str(tmp_path / "ckpt"))
