"""Drawing the parameters straight onto a mesh (``lm.init`` /
``lm.init_cast`` / ``encdec.init`` / ``encdec.init_cast`` with
``rules=``), as the reference draws into its shardings
(``jax.jit(..., out_shardings=)``), on gloo worlds of 4 CPU ranks
(``test_torch_mesh.run_world``), reduced configs at fp32.

On (2, 2), (1, 4) and (4, 1) (data, model) meshes, for qwen3-4b,
dbrx-132b (its config's FSDP, experts over the model axis),
nemotron-4-15b (FSDP), mamba2-2.7b and whisper-medium:

* every leaf is a DTensor laid out by its spec, whose local block holds
  the spec's share of the elements;
* gathered, each leaf equals the meshless draw from the same seed bit
  for bit (dtype included);
* at most one fp32 item is alive at a time: when an item (the
  embedding, the head, a layer, or in a MoE layer its mixer, its router
  or one expert matrix) is drawn, every fp32 draw of an earlier item is
  gone, or is itself a rank's block of the result (a replicated fp32
  leaf is its own block), watched through weak references to every
  ``torch.randn`` output, as
  ``test_torch_models.py::test_init_cast_holds_one_fp32_layer_at_a_time``
  watches ``_init_layer``'s.

``Trainer.init_state`` on a mesh draws the same way and makes its moments
in their ZeRO-1 layout (the step bundle's ``in_shardings[1]``), equal to
the meshless ones when gathered; ``BatchServer`` on a mesh draws its cast
parameters the same way.
"""

from __future__ import annotations

import dataclasses

import pytest

from test_torch_mesh import run_world

ARCHS = ("qwen3-4b", "dbrx-132b", "nemotron-4-15b", "mamba2-2.7b",
         "whisper-medium")
MESHES = ((2, 2), (1, 4), (4, 1))
# fields replaced in the reduced configs: the full configs' FSDP (the
# reduced ones turn it off)
FIELDS = {"dbrx-132b": {"fsdp": True}, "nemotron-4-15b": {"fsdp": True}}


def _cfg(arch: str):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch, reduced=True),
                               **FIELDS.get(arch, {}))


class _Watch:
    """Every ``torch.randn`` output, by item: a call of one of the
    ``layer_fns`` (a module attribute name) is one item, and so is each
    draw outside them or inside ``layers.init_moe`` (its router, then
    each expert matrix).  At the start of each item the fp32 draws of
    earlier items still alive are kept (as weak references);
    ``check(params)`` requires each to be a rank's block of ``params``."""

    def __init__(self, monkeypatch, layer_fns):
        import weakref

        import torch

        from repro_torch.models import layers
        self.draws, self.live, self.items = [], [], 0
        depth, in_moe = [0], [False]
        randn, init_moe = torch.randn, layers.init_moe

        def start():
            self.items += 1
            self.live += [r for r, item in self.draws
                          if item < self.items and r() is not None]

        def watched_randn(*args, **kwargs):
            if depth[0] == 0 or in_moe[0]:
                start()
            t = randn(*args, **kwargs)
            self.draws.append((weakref.ref(t), self.items))
            return t

        def item_fn(fn):
            def run(*args, **kwargs):
                start()
                depth[0] += 1
                try:
                    return fn(*args, **kwargs)
                finally:
                    depth[0] -= 1
            return run

        def watched_moe(*args, **kwargs):
            in_moe[0] = True
            try:
                return init_moe(*args, **kwargs)
            finally:
                in_moe[0] = False

        monkeypatch.setattr(torch, "randn", watched_randn)
        monkeypatch.setattr(layers, "init_moe", watched_moe)
        for mod, name in layer_fns:
            monkeypatch.setattr(mod, name, item_fn(getattr(mod, name)))

    def check(self, params) -> None:
        from repro_torch import tree as T
        blocks = {t.to_local().data_ptr() for t in T.leaves(params)}
        assert self.items > 3 and self.draws
        for r in self.live:
            t = r()
            assert t is not None and t.data_ptr() in blocks, \
                "an fp32 draw outlived its item and is no block of the result"


def _layer_fns(cfg):
    from repro_torch.models import encdec, lm
    if cfg.is_encdec:
        return [(encdec, "_init_enc_layer"), (encdec, "_init_dec_layer")]
    return [(lm, "_init_layer")]


def _check_placed(placed, want, specs, rules) -> None:
    """``placed`` laid out by ``specs`` under ``rules``, each block its
    spec's share of the elements, and gathered equal to ``want`` bit for
    bit."""
    import math

    import torch
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch import tree as T

    want = dict(T.leaves_with_paths(want))
    for key, t, spec in _with_specs(placed, specs):
        w = want.pop(key)
        assert isinstance(t, DTensor), key
        sh = rules.sharding_for(spec, tuple(t.shape))
        assert tuple(t.placements) == tuple(sh.placements), key
        share = math.prod(t.device_mesh.size(md)
                          for md, p in enumerate(t.placements)
                          if isinstance(p, Shard))
        assert t.to_local().numel() * share == t.numel(), key
        full = t.full_tensor()
        assert full.dtype == w.dtype and torch.equal(full, w), key
    assert not want


def _with_specs(tree, specs, path=""):
    """(path, leaf, its spec) over ``tree``, paths as ``tree``'s."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _with_specs(v, specs[k], f"{path}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _with_specs(v, specs[i], f"{path}{i}/")
    else:
        yield path[:-1], tree, specs


def _case_draw(arch: str, mesh_shape) -> None:
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import encdec, lm
    from repro_torch.parallel.sharding import make_rules

    cfg = _cfg(arch)
    model = encdec if cfg.is_encdec else lm
    mesh = init_device_mesh("cpu", tuple(mesh_shape),
                            mesh_dim_names=("data", "model"))
    rules = make_rules(cfg, mesh)
    # init_cast at bf16 compute, so that it casts
    for fn, cfg in ((model.init, cfg), (model.init_cast, dataclasses.replace(
            cfg, compute_dtype="bfloat16"))):
        want = fn(cfg, torch.Generator().manual_seed(0), "cpu")
        mp = pytest.MonkeyPatch()
        try:
            watch = _Watch(mp, _layer_fns(cfg))
            placed = fn(cfg, torch.Generator().manual_seed(0), "cpu",
                        rules=rules)
        finally:
            mp.undo()
        watch.check(placed)
        _check_placed(placed, want, model.param_specs(cfg), rules)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_placed_draw_equals_the_meshless_draw(arch, mesh_shape, tmp_path):
    run_world(__file__, "_case_draw", 4, tmp_path, arch=arch,
              mesh_shape=mesh_shape)


def _case_trainer_state(arch: str, mesh_shape) -> None:
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import tree as T
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch.train import Trainer
    from repro_torch.models import encdec, lm

    cfg = _cfg(arch)
    model = encdec if cfg.is_encdec else lm
    mesh = init_device_mesh("cpu", tuple(mesh_shape),
                            mesh_dim_names=("data", "model"))
    spec = ShapeSpec("t", 8, 4, "train")
    sharded = Trainer(cfg, spec, device="cpu", mesh=mesh)
    meshless = Trainer(cfg, spec, device="cpu")
    mp = pytest.MonkeyPatch()
    try:
        watch = _Watch(mp, _layer_fns(cfg))
        params, opt, step = sharded.init_state()
    finally:
        mp.undo()
    watch.check(params)
    want_p, want_o, _ = meshless.init_state()
    rules = sharded.step_fn.rules
    _check_placed(params, want_p, model.param_specs(cfg), rules)
    o_sh = sharded.step_fn.in_shardings[1]
    for part in ("m", "v"):
        for (key, t), sh, w in zip(T.leaves_with_paths(opt[part]),
                                   T.leaves(o_sh[part]),
                                   T.leaves(want_o[part])):
            assert tuple(t.placements) == tuple(sh.placements), key
            full = t.full_tensor()
            assert full.dtype == w.dtype and torch.equal(full, w), key
    assert step == 0 and int(opt["step"]) == 0


@pytest.mark.parametrize("arch,mesh_shape", [
    ("qwen3-4b", (2, 2)), ("dbrx-132b", (2, 2)), ("whisper-medium", (1, 4)),
    ("mamba2-2.7b", (4, 1)), ("nemotron-4-15b", (1, 4))])
def test_trainer_state_is_drawn_onto_the_mesh_with_zero1_moments(
        arch, mesh_shape, tmp_path):
    run_world(__file__, "_case_trainer_state", 4, tmp_path, arch=arch,
              mesh_shape=mesh_shape)


def _case_server(arch: str, mesh_shape) -> None:
    import numpy as np
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.serve import BatchServer, Request
    from repro_torch.models import lm

    cfg = _cfg(arch)
    mesh = init_device_mesh("cpu", tuple(mesh_shape),
                            mesh_dim_names=("data", "model"))
    mp = pytest.MonkeyPatch()
    try:
        watch = _Watch(mp, _layer_fns(cfg))
        served = BatchServer(cfg, max_len=16, device="cpu", mesh=mesh)
    finally:
        mp.undo()
    watch.check(served.params)
    meshless = BatchServer(cfg, max_len=16, device="cpu")
    _check_placed(served.params, meshless.params, lm.param_specs(cfg),
                  served.rules)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (7, 3, 5, 1)]
    got, want = (srv.serve([Request(i, p, 4) for i, p in enumerate(prompts)])
                 ["outputs"] for srv in (served, meshless))
    assert got == want and all(len(t) == 4 for t in got.values())


@pytest.mark.parametrize("arch,mesh_shape", [
    ("qwen3-4b", (1, 4)), ("dbrx-132b", (1, 4)), ("mamba2-2.7b", (2, 2))])
def test_server_draws_its_cast_parameters_onto_the_mesh(arch, mesh_shape,
                                                        tmp_path):
    run_world(__file__, "_case_server", 4, tmp_path, arch=arch,
              mesh_shape=mesh_shape)

