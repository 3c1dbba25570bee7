"""The port's multi-device layer against the JAX package's: sharding specs,
collective accounting and gradient compression.

Specs: every arch of ``ARCH_IDS`` at full size on both production meshes.
The reference's rules run on a ``jax.sharding.AbstractMesh``; the port's
on a ``DeviceMesh`` of a fake process group of 256 or 512 ranks
(``launch.dryrun.start_fake_world``).  The port's spec of every
parameter leaf, every ZeRO-1 moment leaf, every batch input of each
``SHAPES`` cell and every cache leaf of ``_cache_shardings`` (decode_32k,
long_500k) equals the reference's; a per-layer leaf of the port equals
its stacked leaf there without the leading "layers" entry.  The
fallbacks equal the reference's as sets: the port records one a layer
where the reference records one a stacked leaf.

Compression: ``compress`` / ``ef_quantize`` / ``ef_tree_quantize`` on
seeded inputs give the reference's int8 payloads bit for bit and its
scales within one fp32 ulp (both are max|g| / 127 + 1e-12 in fp32; XLA
may fold the division differently), and ``compressed_psum`` over a
4-rank gloo group gives the mean of the ranks' dequantized gradients
(within the rounding of a sum in another order) through one fp32
all-reduce, whose link bytes ``collective_stats`` counts.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from test_torch_mesh import run_world
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import steps as ref_steps
from repro.models import encdec as ref_encdec
from repro.models import lm as ref_lm
from repro.optim import compression as ref_comp
from repro.optim.adamw import OptConfig as RefOptConfig
from repro.parallel import hlo_analysis as ref_hlo
from repro.parallel.sharding import make_rules as ref_make_rules
from repro_torch import tree as T
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import encdec, lm
from repro_torch.optim import OptConfig, compression
from repro_torch.parallel import hlo_analysis
from repro_torch.parallel.sharding import make_rules

MESHES = {"single": (False, (16, 16), ("data", "model")),
          "multi": (True, (2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture
def fake_mesh():
    meshes = []

    def make(multi: bool):
        dryrun.start_fake_world(512 if multi else 256)
        meshes.append(make_production_mesh(multi_pod=multi,
                                           device_type="cpu"))
        return meshes[-1]

    yield make
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _ref_path(cfg, path: str) -> tuple[str, bool]:
    """The reference's path of a port leaf, and whether it is stacked."""
    parts = path.split("/")
    if parts[0] == "layers":
        i = int(parts[1])
        return "/".join(["blocks", f"pos{i % cfg.pattern_len}", *parts[2:]]), \
            True
    if parts[0] in ("encoder", "decoder"):
        return "/".join([parts[0], *parts[2:]]), True
    return path, False


def _get(tree, path: str):
    for key in path.split("/"):
        tree = tree[int(key)] if isinstance(tree, list) else tree[key]
    return tree


def _spec(p) -> tuple:
    return tuple(p)


def _port_specs(tree):
    """{path: spec} of a tree of the port's NamedSharding."""
    return {k: sh.spec for k, sh in T.leaves_with_paths(tree)}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCH_IDS))
def test_specs_match_the_reference(arch, mesh_name, fake_mesh):
    multi, dims, axes = MESHES[mesh_name]
    mesh = fake_mesh(multi)
    amesh = AbstractMesh(dims, axes)
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    model, rmodel = (encdec, ref_encdec) if cfg.is_encdec else (lm, ref_lm)

    # parameters
    rules, rrules = make_rules(cfg, mesh), ref_make_rules(rcfg, amesh)
    aparams, specs = model.abstract_init(cfg)
    rshapes, rspecs = rmodel.abstract_init(rcfg)
    n = 0
    for path, leaf in T.leaves_with_paths(aparams):
        rpath, stacked = _ref_path(cfg, path)
        rshape = _get(rshapes, rpath).shape
        want = _spec(rrules.spec_for(_get(rspecs, rpath), rshape))
        got = rules.spec_for(_get(specs, path), tuple(leaf.shape))
        assert got == (want[1:] if stacked else want), path
        n += 1
    assert n == len(T.leaves(aparams))
    assert set(rules.fallbacks) == set(rrules.fallbacks)

    # ZeRO-1 moments
    st = steps.abstract_state(cfg, mesh, OptConfig())
    rst = ref_steps.abstract_state(rcfg, amesh,
                                   RefOptConfig(moment_dtype="float32"))
    for path, spec in _port_specs(st["opt_shardings"]["m"]).items():
        rpath, stacked = _ref_path(cfg, path)
        want = _spec(_get(rst["opt_shardings"]["m"], rpath).spec)
        assert spec == (want[1:] if stacked else want), path

    # batch inputs and caches of every cell
    for name, shape in SHAPES.items():
        rshape = REF_SHAPES[name]
        rules, rrules = make_rules(cfg, mesh), ref_make_rules(rcfg, amesh)
        got = steps._batch_shardings(cfg, shape, rules)
        want = ref_steps._batch_shardings(rcfg, rshape, rrules)
        assert {k: v.spec for k, v in got.items()} == \
            {k: _spec(v.spec) for k, v in want.items()}
        if shape.kind != "decode":
            continue
        B, S = shape.global_batch, shape.seq_len
        got, _ = steps._cache_shardings(cfg, rules, B, S, enc_len=S)
        want, _ = ref_steps._cache_shardings(rcfg, rrules, B, S, enc_len=S)
        for path, spec in _port_specs(got).items():
            assert spec == _spec(_get(want, path).spec), (name, path)
        assert set(rules.fallbacks) == set(rrules.fallbacks), name
        assert rules.rules.get("kv_seq") == rrules.rules.get("kv_seq")


# ------------------------------------------------------------ collectives

def test_collective_stats_matches_the_reference_on_its_hlo():
    hlo = """
  %ar = f32[1024,256] all-reduce(f32[1024,256] %x), replica_groups={{0,1,2,3}}
  %ag = bf16[512,512] all-gather(bf16[128,512] %y), replica_groups=[2,8]<=[16]
  %cp = f32[64] collective-permute(f32[64] %z)
"""
    want = ref_hlo.collective_stats(hlo)
    got = hlo_analysis.collective_stats([
        ("all-reduce", 1024 * 256 * 4, 4),
        ("all-gather", 512 * 512 * 2, 8),
        ("collective-permute", 64 * 4, 2)])
    assert got.per_op_count == want.per_op_count
    assert got.per_op_bytes == pytest.approx(want.per_op_bytes)
    assert got.link_bytes == pytest.approx(want.link_bytes)
    assert got.dominant() == want.dominant()
    roof = hlo_analysis.roofline(989e12, 3.35e12, 450e9, 4)
    assert (roof.compute_s, roof.memory_s, roof.collective_s) == \
        pytest.approx((1.0, 1.0, 1.0))


def test_trace_counter_counts_local_flops_and_collectives(fake_mesh):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dryrun.start_fake_world(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    x = DTensor.from_local(torch.empty(4, 64, device="meta"), mesh,
                           [Shard(0), Replicate()])
    w = DTensor.from_local(torch.empty(64, 32, device="meta"), mesh,
                           [Replicate(), Shard(1)])
    w2 = DTensor.from_local(torch.empty(32, 64, device="meta"), mesh,
                            [Replicate(), Shard(0)])
    with hlo_analysis.TraceCounter() as tc:
        y = (x @ w) @ w2                      # a partial sum over model
        y.redistribute(mesh, [Shard(0), Replicate()])
    assert tc.flops == 2 * (2 * 4 * 64 * 32)  # this rank's two products
    assert tc.records == [("all-reduce", 4 * 64 * 4, 2)]


# ------------------------------------------------------------ compression

def _ulps(a: float, b: float) -> int:
    ia = np.array([a], np.float32).view(np.int32)[0]
    ib = np.array([b], np.float32).view(np.int32)[0]
    return abs(int(ia) - int(ib))


@pytest.mark.parametrize("seed", range(4))
def test_compression_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((257,)).astype(np.float32) * (1 + seed)
    e = rng.standard_normal((257,)).astype(np.float32) * 0.01
    q, s = compression.compress(torch.from_numpy(g))
    rq, rs = ref_comp.compress(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert _ulps(float(s), float(rs)) <= 1
    q, s, ne = compression.ef_quantize(torch.from_numpy(g),
                                       torch.from_numpy(e))
    rq, rs, rne = ref_comp.ef_quantize(jnp.asarray(g), jnp.asarray(e))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(ne.numpy(), np.asarray(rne), rtol=0,
                               atol=2 * float(np.spacing(np.float32(rs))))
    tree = {"a": g, "b": {"c": g[:64] * 3}}
    got, gerr = compression.ef_tree_quantize(
        T.tree_map(torch.from_numpy, tree),
        compression.ef_tree_init(T.tree_map(torch.from_numpy, tree)))
    want, werr = ref_comp.ef_tree_quantize(
        jax.tree.map(jnp.asarray, tree),
        ref_comp.ef_tree_init(jax.tree.map(jnp.asarray, tree)))
    for k in ("a", "b/c"):
        np.testing.assert_allclose(
            _get(got, k).numpy(), np.asarray(_get(want, k)), rtol=2e-7,
            atol=0, err_msg=k)
        np.testing.assert_allclose(
            _get(gerr, k).numpy(), np.asarray(_get(werr, k)), rtol=0,
            atol=1e-6, err_msg=k)


def _case_compressed_psum() -> None:
    import torch.distributed as dist

    rank, n = dist.get_rank(), dist.get_world_size()

    def grad(r):
        return torch.from_numpy(np.random.default_rng(r).standard_normal(
            (300,)).astype(np.float32))

    err = torch.full((300,), 0.001)
    with hlo_analysis.TraceCounter() as tc:
        mean, new_err = compression.compressed_psum(
            grad(rank), dist.group.WORLD, err)
        mean = mean.clone()
    parts = [compression.decompress(*compression.ef_quantize(grad(r), err)[:2])
             for r in range(n)]
    want = parts[0]
    for p in parts[1:]:
        want = want + p
    # gloo sums the parts in its own order: two sums of n terms in fp32
    # differ by at most 2 (n - 1) roundings of the sum of their magnitudes
    bound = 2 * (n - 1) * 2.0 ** -24 * torch.stack(parts).abs().sum(0) / n
    assert bool(((mean - want / n).abs() <= bound).all())
    assert torch.equal(new_err, compression.ef_quantize(grad(rank), err)[2])
    plain = sum(grad(r) for r in range(n)) / n
    assert float((mean - plain).abs().max()) < 0.05
    # the link traffic is one fp32 all-reduce's, counted from the record
    assert tc.records == [("all-reduce", 300 * 4, n)]
    stats = hlo_analysis.collective_stats(tc.records)
    assert stats.link_bytes == 2 * 300 * 4 * (n - 1) / n


def test_compressed_psum_over_a_gloo_group(tmp_path):
    run_world(__file__, "_case_compressed_psum", 4, tmp_path)


def test_meshes_over_a_fake_world(fake_mesh):
    """``make_pe_mesh`` takes the world as (pe, data) and raises with the
    reference's messages; the production mesh never shrinks to fit."""
    from repro_torch.launch.mesh import make_pe_mesh
    dryrun.start_fake_world(8)
    mesh = make_pe_mesh(2, device_type="cpu")
    assert mesh.mesh_dim_names == ("pe", "data") and mesh.shape == (2, 4)
    with pytest.raises(ValueError, match="n_pes must be >= 1, got 0"):
        make_pe_mesh(0, device_type="cpu")
    with pytest.raises(ValueError,
                       match="n_pes=3 does not divide the 8 available"):
        make_pe_mesh(3, device_type="cpu")
    with pytest.raises(ValueError, match="needs a world of 256, got 8"):
        make_production_mesh(device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_pe_mesh(2)


def test_production_mesh_wants_the_card(fake_mesh):
    """Without ``device_type`` the production mesh lives on the card, and
    raises where there is none: no mesh falls back to the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default mesh is valid here")
    dryrun.start_fake_world(256)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_production_mesh()


def test_local_mesh_starts_a_world_of_one(fake_mesh):
    """With no process group, ``make_local_mesh`` starts a world of one
    (gloo on the CPU); by default it wants the card and raises without
    one."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    if dist.is_initialized():
        dist.destroy_process_group()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_local_mesh()
    mesh = make_local_mesh(device="cpu")
    assert mesh.shape == (1, 1) and mesh.mesh_dim_names == ("data", "model")
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
    with pytest.raises(ValueError, match="does not divide the world of 1"):
        make_local_mesh(2, device="cpu")
