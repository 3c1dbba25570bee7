"""The port's examples (``examples_torch/``), its ``perf_iter``
experiment and the DORA half of ``kernels.ops`` against the JAX
package's, on the CPU.

* ``ops.matmul`` / ``linear`` / ``softmax`` / ``gelu`` against the
  reference's ``ops`` in its "auto" mode (the jnp oracle on the CPU) and
  its "pallas" mode (the Pallas kernels in interpret mode), fp32 at
  rtol = atol = 5e-5: every epilogue, with and without bias, ``linear``
  over 3-D inputs; gradients through the plain versions on the CPU.
* quickstart: BERT-S's binary equals the reference's byte for byte (both
  MILP solves optimal), and every layer's CPU output is within 5e-4 of
  the reference's ``DoraCompiler.execute``.
* dora_scheduling: the seeded GA's makespan equals the reference's; the
  4-segment partitioned MILP (every segment solved to optimality) too.
* serve_batch: with the reference's parameters carried across, the
  greedy requests' tokens equal the reference ``BatchServer``'s; sampled
  ones are checked for length and vocabulary range (the two RNGs never
  agree).
* train_lm: both presets equal the reference's field for field; the
  tiny preset with a fault after its first checkpoint recovers once and
  replays an uninterrupted run's losses within 1e-6 relative.
* grad_compression over worlds of 1 (in this process) and 2 (gloo
  processes): the fp32 path equals one-process full-batch gradient
  descent to 1e-5 max|w|, and the printed bytes are the all-reduced
  tensor's.
* perf_iter: every lever of the reference's ``apply_opts`` (read from
  its AST: the file sets ``XLA_FLAGS`` at import) sets the same field to
  the same value; ``bf16_moments`` lowers the per-chip argument bytes of
  a reduced cell on a fake (2, 2) mesh.
* the C.6 probe (``experiments_torch/jamba_c6.py``) needs the card.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_models as ref_models
from repro.configs import get_config as ref_get_config
from repro.core import (CompileOptions as RefOptions,
                        DoraCompiler as RefCompiler,
                        DoraPlatform as RefPlatform, GAConfig as RefGAConfig,
                        GAScheduler as RefGAScheduler,
                        MilpScheduler as RefMilpScheduler, Policy as RefPolicy,
                        build_candidate_table as ref_candidate_table,
                        partitioned_solve as ref_partitioned_solve)
from repro.kernels import ops as ref_ops
from repro.launch.mesh import make_local_mesh as ref_local_mesh
from repro.launch.serve import BatchServer as RefBatchServer
from repro.launch.serve import Request as RefRequest
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels.ref import EPILOGUES

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from examples_torch import (dora_scheduling, grad_compression,  # noqa: E402
                            quickstart, serve_batch, train_lm)
from experiments_torch import perf_iter  # noqa: E402

TOL = 5e-5


def _load(path: Path, name: str):
    """A reference script as a module, without running its ``main``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _arr(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ref_ops(mode, fn, *args):
    """The reference's ``ops.<fn>`` in ``mode``, restored to "auto"."""
    ref_ops.set_kernel_mode(mode)
    try:
        return np.asarray(getattr(ref_ops, fn)(
            *(jnp.asarray(a) if isinstance(a, np.ndarray) else a
              for a in args)))
    finally:
        ref_ops.set_kernel_mode("auto")


def _t(a):
    return None if a is None else torch.from_numpy(a)


# ------------------------------------------------------------------- ops

# every epilogue with its bias; the epilogues without one also with a bias
# given (read by neither package)
MATMUL_CASES = [(e, True) for e in EPILOGUES] + \
    [(e, False) for e in EPILOGUES if not e.startswith("bias")]


@pytest.mark.parametrize("mode", ["auto", "pallas"])
@pytest.mark.parametrize("epilogue,bias", MATMUL_CASES,
                         ids=[f"{e}-{'bias' if b else 'nobias'}"
                              for e, b in MATMUL_CASES])
def test_matmul_matches_the_reference_ops(epilogue, bias, mode):
    a, b = _arr((37, 50), 1), _arr((50, 29), 2)
    c = _arr((29,), 3) if bias else None
    want = _ref_ops(mode, "matmul", a, b, c, epilogue)
    got = ops.matmul(_t(a), _t(b), _t(c), epilogue)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert torch.equal(got, ops.matmul(_t(a), _t(b), _t(c), epilogue,
                                       plain=True))


@pytest.mark.parametrize("mode", ["auto", "pallas"])
@pytest.mark.parametrize("epilogue", ["none", "bias_gelu", "relu2"])
def test_linear_flattens_3d_inputs_as_the_reference(epilogue, mode):
    x, w = _arr((2, 5, 50), 4), _arr((50, 29), 5)
    c = _arr((29,), 6) if epilogue.startswith("bias") else None
    want = _ref_ops(mode, "linear", x, w, c, epilogue)
    # a non-contiguous view: linear makes the rows contiguous
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(1, 0, 2))
                          ).transpose(0, 1)
    got = ops.linear(xt, _t(w), _t(c), epilogue)
    assert got.shape == (2, 5, 29)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", ["auto", "pallas"])
@pytest.mark.parametrize("fn", ["softmax", "gelu"])
@pytest.mark.parametrize("shape", [(9, 33), (2, 7, 33)])
def test_softmax_and_gelu_match_the_reference_ops(fn, shape, mode):
    x = _arr(shape, 7) * 3
    want = _ref_ops(mode, fn, x)
    got = getattr(ops, fn)(torch.from_numpy(x))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert torch.equal(got, getattr(ops, fn)(torch.from_numpy(x),
                                             plain=True))


def test_linear_differentiates_through_the_plain_version_on_the_cpu():
    """The CPU's gradient of sum(linear(x, w)**2) against ``jax.grad`` of
    the reference's (``tests/test_kernels.py``'s oracle path)."""
    x, w = _arr((8, 16), 8), _arr((16, 4), 9)
    want = jax.grad(lambda w_: jnp.sum(ref_ops.linear(jnp.asarray(x), w_)
                                       ** 2))(jnp.asarray(w))
    wt = torch.from_numpy(w).requires_grad_(True)
    (got,) = torch.autograd.grad((ops.linear(torch.from_numpy(x), wt)
                                  ** 2).sum(), wt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))
    xt = torch.from_numpy(x).requires_grad_(True)
    (gs,) = torch.autograd.grad((ops.softmax(xt) * xt).sum(), xt)
    (gg,) = torch.autograd.grad(ops.gelu(xt).sum(), xt)
    assert bool(torch.isfinite(gs).all() and torch.isfinite(gg).all())


def test_dora_entry_points_refuse_a_dtensor():
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(device="cpu")
    try:
        a = DTensor.from_local(torch.ones(4, 4), mesh,
                               [Replicate(), Replicate()])
        for call in (lambda: ops.matmul(a, a), lambda: ops.linear(a, a),
                     lambda: ops.softmax(a), lambda: ops.gelu(a),
                     lambda: ops.matmul(a, a, plain=True)):
            with pytest.raises(TypeError, match="DTensor"):
                call()
    finally:
        torch.distributed.destroy_process_group()


# ------------------------------------------------------------- quickstart

def test_quickstart_binary_and_outputs_match_the_reference():
    r = quickstart.run(quickstart.parse_args(["--device", "cpu"]),
                       device="cpu")
    res = r["result"]
    compiler = RefCompiler(RefPlatform.vck190(), RefPolicy.dora())
    ref_res = compiler.compile(ref_models.bert_s(),
                               RefOptions(engine="milp", time_budget_s=5.0))
    assert res.optimal and ref_res.optimal
    assert res.codegen.program.encode() == ref_res.codegen.program.encode()
    want = compiler.execute(ref_res, ref_models.bert_s().random_inputs(0))
    for layer in r["graph"].layers:
        np.testing.assert_allclose(r["outputs"][layer.name],
                                   want[layer.name], rtol=5e-4, atol=5e-4,
                                   err_msg=layer.name)
    assert len(r["head"]) == 12 and r["sim_makespan_s"] > 0
    assert r["rel_l2"] < 1e-4


# -------------------------------------------------------- dora_scheduling

def test_dora_scheduling_matches_the_reference_engines():
    """The seeded GA is deterministic; each of the 4 segments' MILPs is
    solved to optimality well inside its budget, so the partitioned
    makespans agree; the whole-graph MILP stops at its budget in both
    packages, so its makespan is compared only where both are optimal."""
    r = dora_scheduling.run(dora_scheduling.parse_args([]))
    plat = RefPlatform.vck190()
    g = ref_models.deit_s()
    table = ref_candidate_table(g, plat, RefPolicy.dora())
    assert r["n_modes"] == sum(len(v) for v in table.values())
    ga = RefGAScheduler(plat, RefGAConfig(population=48, generations=40,
                                          seed=0)).solve(g, table)
    assert r["ga"].best_makespan == ga.best_makespan
    assert r["ga"].generations_run == ga.generations_run == 40
    part = ref_partitioned_solve(
        g, table, plat, 4, lambda: RefMilpScheduler(plat, time_budget_s=2.0))
    assert r["partitioned"].makespan == part.makespan
    milp = RefMilpScheduler(plat, time_budget_s=10.0).solve(g, table)
    if r["milp"].optimal and milp.optimal:
        assert r["milp"].schedule.makespan == milp.schedule.makespan


# ------------------------------------------------------------ serve_batch

def test_serve_batch_greedy_tokens_equal_the_reference_servers():
    args = serve_batch.parse_args(["--device", "cpu"])
    cfg = get_config(args.arch, reduced=True)
    ref = RefBatchServer(ref_get_config(args.arch, reduced=True),
                         ref_local_mesh(), max_len=128)
    requests = serve_batch.requests_for(cfg, args.batch, args.gen)
    want = ref.serve([RefRequest(r.id, r.prompt, r.max_new, r.temperature)
                      for r in requests])["outputs"]
    got = serve_batch.run(args, device="cpu", params=params_from_jax(
        cfg, jax.tree.map(np.asarray, ref.params), "cpu"))
    assert [len(r.prompt) for r in got["requests"]] == \
        [len(r.prompt) for r in requests]
    for r in requests:
        out = got["outputs"][r.id]
        assert len(out) == args.gen
        if r.temperature == 0:
            assert out == want[r.id]
        else:
            assert all(0 <= t < cfg.vocab_size for t in out)
    assert got["prefill_s"] > 0 and got["decode_tok_per_s"] > 0


# --------------------------------------------------------------- train_lm

@pytest.mark.parametrize("preset", ["tiny", "100m"])
def test_train_lm_presets_equal_the_references(preset):
    ref = _load(ROOT / "examples" / "train_lm.py", "_ref_train_lm")
    cfg, shape = train_lm.preset_config(preset)
    rcfg, rshape = ref.preset_config(preset)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert dataclasses.astuple(shape) == dataclasses.astuple(rshape)
    assert cfg.param_count() == rcfg.param_count()


def test_train_lm_recovers_a_fault_and_replays_the_losses(tmp_path):
    """30 steps of the tiny preset (a checkpoint at step 25) with a fault
    at step 27: one failure, steps 25-26 replayed from the checkpoint,
    every loss within 1e-6 relative of an uninterrupted run's."""
    assert train_lm.CKPT_EVERY == 25
    runs = {}
    for fail in (-1, 27):
        args = train_lm.parse_args(["--device", "cpu", "--steps", "30",
                                    "--fail-at", str(fail), "--ckpt-dir",
                                    str(tmp_path / f"run{fail}")])
        runs[fail] = train_lm.run(args, device="cpu")
    clean, faulty = runs[-1], runs[27]
    assert clean["failures"] == 0 and faulty["failures"] == 1
    steps = [m["step"] for m in faulty["metrics"]]
    assert steps == list(range(27)) + list(range(25, 30))
    want = {m["step"]: m["loss"] for m in clean["metrics"]}
    for m in faulty["metrics"]:
        assert abs(m["loss"] - want[m["step"]]) <= 1e-6 * abs(
            want[m["step"]])
    assert clean["losses"][-1] < clean["losses"][0]


# -------------------------------------------------------- grad_compression

def _full_batch_gd(world: int) -> np.ndarray:
    """Gradient descent on every row in one process, as the fp32 path's
    mean of the ranks' gradients should give."""
    X, y = grad_compression.problem(world)
    xs, ys = torch.from_numpy(X), torch.from_numpy(y)
    w = torch.zeros(grad_compression.D)
    for _ in range(grad_compression.STEPS):
        w = w - grad_compression.LR * grad_compression.local_grad(w, xs, ys)
    return w.numpy()


@pytest.mark.parametrize("world", [1, 2])
def test_grad_compression_matches_full_batch_descent(world):
    args = grad_compression.parse_args(["--device", "cpu", "--world",
                                        str(world)])
    r = grad_compression.run(args, device="cpu")
    assert r["world"] == world
    want = _full_batch_gd(world)
    paths = r["paths"]
    fp32 = np.asarray(paths["fp32 all-reduce"]["w"])
    assert np.abs(fp32 - want).max() <= 1e-5 * np.abs(want).max()
    for res in paths.values():
        # one all-reduce of D fp32 values a step, compressed or not
        assert res["all_reduces"] == 1
        assert res["wire_bytes"] == 4 * grad_compression.D
        assert res["link_bytes"] == 2 * 4 * grad_compression.D * (
            world - 1) / world
        assert np.isfinite(res["mse"])
    # error feedback keeps the int8 path's convergence near the fp32 one's
    int8 = np.asarray(paths["int8 EF all-reduce"]["w"])
    assert np.abs(int8 - fp32).max() <= 1e-2 * np.abs(fp32).max()


# --------------------------------------------------------------- perf_iter

def _reference_levers() -> dict[str, tuple[str, object]]:
    """lever -> (field, value) from the reference's ``apply_opts``; the
    prefix lever ``microbatch`` maps to ("microbatch", int)."""
    tree = ast.parse((ROOT / "experiments" / "perf_iter.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == "apply_opts")
    levers = {}
    for node in ast.walk(fn):
        if not isinstance(node, ast.If):
            continue
        test, body = node.test, node.body[0]
        if not (isinstance(body, ast.Assign)
                and isinstance(body.value, ast.Call)):
            continue
        (kw,) = body.value.keywords
        if isinstance(test, ast.Compare):
            value = ast.literal_eval(kw.value)
            levers[ast.literal_eval(test.comparators[0])] = (kw.arg, value)
        else:      # o.startswith("microbatch")
            levers[ast.literal_eval(test.args[0])] = (kw.arg, int)
    return levers


def test_perf_iter_levers_set_the_references_fields():
    levers = _reference_levers()
    assert len(levers) == 11
    base = get_config("qwen3-4b")
    for lever, (field, value) in levers.items():
        if value is int:
            cfg = perf_iter.apply_opts(base, [f"{lever}4"])
            assert getattr(cfg, field) == 4, lever
        else:
            cfg = perf_iter.apply_opts(base, [lever])
            assert getattr(cfg, field) == value, lever
        changed = {f.name for f in dataclasses.fields(cfg)
                   if getattr(cfg, f.name) != getattr(base, f.name)}
        assert changed <= {field}, (lever, changed)
    with pytest.raises(KeyError):
        perf_iter.apply_opts(base, ["no_such_lever"])


def test_perf_iter_bf16_moments_lowers_the_argument_bytes():
    cfg = get_config("qwen3-4b", reduced=True)
    base = perf_iter.measure(cfg, "train_4k", False, mesh_shape=(2, 2))
    bf16 = perf_iter.measure(perf_iter.apply_opts(cfg, ["bf16_moments"]),
                             "train_4k", False, mesh_shape=(2, 2))
    assert 0 < bf16["args_gib"] < base["args_gib"]
    assert base["step_s"] == max(base["roofline"][k] for k in
                                 ("compute_s", "memory_s", "collective_s"))


def test_jamba_c6_probe_needs_the_card(monkeypatch):
    """The C.6 probe trains full-width cuts: it refuses to start without
    a card, and its variants include the cut ``chip_smoke.py`` trains."""
    from experiments_torch import jamba_c6
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        jamba_c6.main()
    assert {"base", "90 steps", "first layer", "llama4"} <= set(
        jamba_c6.variants())
