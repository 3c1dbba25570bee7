"""The port's training path against the JAX package's, on the CPU.

``lm.loss_fn`` / ``encdec.loss_fn`` and their gradients against
``jax.value_and_grad`` of the reference's losses on reduced configs (fp32
compute), every leaf within 1e-4 · max|g| of that leaf; one
``make_train_step`` step against the reference's jitted step on a
one-device mesh, with one and two microbatches; remat on and off; the
call structure a step gives the kernels (what ``chip_smoke.py`` counts on
the card); and ports of tests/test_system.py's trainer tests (the loss
falls and resumes, an injected fault is survived) plus a fault-resumed
run that replays the uninterrupted losses.  Parameters come from the
reference's ``init`` with the norm gains perturbed, and cross (with the
gradient trees) through ``convert.params_from_jax``; batches from
``SyntheticLM``, which gives both packages the same tokens.
"""

import dataclasses
import weakref
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as ref_get_config
from repro.configs.shapes import ShapeSpec as RefShapeSpec
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import encdec as ref_encdec
from repro.models import lm as ref_lm
from repro.optim import adamw as ref_adamw
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.convert import encdec_params_from_jax, params_from_jax
from repro_torch.data import for_arch
from repro_torch.kernels import ref
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import TrainOptions, Trainer
from repro_torch.models import encdec, lm
from repro_torch.optim import OptConfig, init_state

LOSS_ARCHS = ["qwen3-4b", "mamba2-2.7b", "nemotron-4-15b", "qwen2-vl-2b",
              "qwen1.5-4b", "internlm2-20b", "dbrx-132b",
              "llama4-maverick-400b-a17b", "jamba-1.5-large-398b",
              "whisper-medium"]
GRAD_TOL = 1e-4
B, S = 2, 16


def _perturb(tree, rng, path=""):
    """Norm gains and biases off their ones and zeros, so that a wrong
    gradient through them shows."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, f"{path}/{k}") for k, v in tree.items()}
    arr = np.asarray(tree)
    if "norm" in path or path.rsplit("/", 1)[-1] in ("bq", "bk", "bv"):
        arr = arr + rng.normal(scale=0.1, size=arr.shape).astype(arr.dtype)
    return arr


def _setup(arch):
    cfg, rcfg = get_config(arch, reduced=True), ref_get_config(arch,
                                                                reduced=True)
    model = ref_encdec if rcfg.is_encdec else ref_lm
    jp = _perturb(model.init(rcfg, jax.random.PRNGKey(1))[0],
                  np.random.default_rng(2))
    batch = for_arch(cfg, S, B, seed=3).batch(0)
    return cfg, rcfg, jp, batch


def _to_port(cfg, tree):
    return (encdec_params_from_jax if cfg.is_encdec else params_from_jax)(
        cfg, jax.tree.map(np.asarray, tree), "cpu")


def _port_loss(cfg, p, batch):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    if cfg.is_encdec:
        return encdec.loss_fn(cfg, p, t["frames"], t["tokens"], t["labels"])
    return lm.loss_fn(cfg, p, t["tokens"], t["labels"])


def _ref_loss(rcfg, batch):
    j = {k: jnp.asarray(v) for k, v in batch.items()}
    if rcfg.is_encdec:
        return lambda p: ref_encdec.loss_fn(rcfg, p, j["frames"], j["tokens"],
                                            j["labels"])
    return lambda p: ref_lm.loss_fn(rcfg, p, j["tokens"], j["labels"])


def _leaves_close(got_tree, want_tree, tol=GRAD_TOL):
    for (path, got), want in zip(T.leaves_with_paths(got_tree),
                                 T.leaves(want_tree)):
        got, want = got.detach().float(), want.detach().float()
        err = float((got - want).abs().max())
        assert err <= tol * float(want.abs().max()), (path, err)


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_loss_and_grads_match_jax_value_and_grad(arch):
    cfg, rcfg, jp, batch = _setup(arch)
    want, g_ref = jax.value_and_grad(_ref_loss(rcfg, batch))(
        jax.tree.map(jnp.asarray, jp))
    p = _to_port(cfg, jp)
    leaves = T.leaves(p)
    for t in leaves:
        t.requires_grad_(True)
    loss = _port_loss(cfg, p, batch)
    grads = T.unflatten(p, list(torch.autograd.grad(loss, leaves)))
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    _leaves_close(grads, _to_port(cfg, g_ref))


def test_loss_carries_the_moe_aux():
    """dbrx's loss is nll + z-loss + the load-balance loss: the aux that
    ``forward`` now returns, as the reference's."""
    cfg, rcfg, jp, batch = _setup("dbrx-132b")
    p = _to_port(cfg, jp)
    logits, aux = lm.forward(cfg, p, torch.from_numpy(batch["tokens"]))
    _, want_aux = ref_lm.forward(rcfg, jax.tree.map(jnp.asarray, jp),
                                 jnp.asarray(batch["tokens"]))
    assert float(aux) > 0
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)
    labels = torch.from_numpy(batch["labels"])
    assert float(_port_loss(cfg, p, batch)) == pytest.approx(
        float(lm.lm_loss(logits, labels) + aux), rel=1e-6)


@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_matches_the_reference_step(mb):
    """One step of both packages from the same parameters and batch.  The
    optimizer's eps is 1e-3 here: with AdamW's default 1e-8 the first
    step moves each parameter by lr · sign(g), which flips for gradients
    within fp32 rounding of zero; at 1e-3 the update is smooth in g."""
    cfg, rcfg, jp, _ = _setup("qwen3-4b")
    cfg, rcfg = (dataclasses.replace(c, microbatch=mb) for c in (cfg, rcfg))
    kw = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10, eps=1e-3)
    shape = ShapeSpec("t", S, 4, "train")
    bundle = ref_make_train_step(rcfg, make_local_mesh(),
                                 RefShapeSpec("t", S, 4, "train"),
                                 ref_adamw.OptConfig(**kw))
    rparams = jax.tree.map(jnp.asarray, jp)
    ropt = ref_adamw.init_state(rparams, ref_adamw.OptConfig(**kw))
    batch = for_arch(cfg, S, 4, seed=5).batch(0)
    rnew, _, rm = bundle.jit()(rparams, ropt,
                               {k: jnp.asarray(v) for k, v in batch.items()})
    opt = OptConfig(**kw)
    step = make_train_step(cfg, shape, opt, "cpu")
    p = _to_port(cfg, jp)
    p, state, m = step(p, init_state(p, opt),
                       {k: torch.from_numpy(v).long() for k, v in
                        batch.items()})
    assert float(m["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                  rel=1e-4)
    assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    assert int(state["step"]) == 1
    _leaves_close(p, _to_port(cfg, rnew), tol=1e-5)


def test_microbatches_give_the_whole_batch_step():
    cfg, _, jp, _ = _setup("qwen3-4b")
    opt = OptConfig(warmup_steps=1, eps=1e-3)
    batch = {k: torch.from_numpy(v).long()
             for k, v in for_arch(cfg, S, 4, seed=6).batch(0).items()}
    out = []
    for mb in (1, 2):
        c = dataclasses.replace(cfg, microbatch=mb)
        p = _to_port(c, jp)
        step = make_train_step(c, ShapeSpec("t", S, 4, "train"), opt, "cpu")
        out.append(step(p, init_state(p, opt), batch))
    assert float(out[1][2]["loss"]) == pytest.approx(float(out[0][2]["loss"]),
                                                     rel=1e-5)
    _leaves_close(out[1][0], out[0][0], tol=1e-5)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(dataclasses.replace(cfg, microbatch=3),
                        ShapeSpec("t", S, 4, "train"), opt, "cpu")


class _Products(TorchDispatchMode):
    """Counts the products dispatched while open, by op."""

    def __init__(self):
        super().__init__()
        self.n = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in ("mm", "addmm", "bmm", "baddbmm"):
            self.n[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen3-4b", "whisper-medium", "dbrx-132b"])
def test_remat_gives_the_same_gradients(arch):
    """remat off, and on under each ``remat_policy``: the same gradients
    to the bit.  The products the backward runs, counted by op with a
    ``TorchDispatchMode``, show what each policy recomputes beside the
    gradient's own products (remat off): "nothing" every product of the
    layers, "dots" none, "dots_nb" the batched products (attention's
    einsums on the CPU, dbrx's experts) and no 2-D weight product.
    whisper's encoder-decoder keeps "nothing" under every policy, as the
    reference's does."""
    cfg, _, jp, batch = _setup(arch)
    grads, products = {}, {}
    for policy in (None, "nothing", "dots", "dots_nb"):
        c = dataclasses.replace(cfg, remat=policy is not None,
                                remat_policy=policy or "nothing")
        p = _to_port(c, jp)
        leaves = T.leaves(p)
        for t in leaves:
            t.requires_grad_(True)
        loss = _port_loss(c, p, batch)
        with _Products() as seen:
            grads[policy] = torch.autograd.grad(loss, leaves)
        products[policy] = seen.n
    for policy in ("nothing", "dots", "dots_nb"):
        for a, b in zip(grads[None], grads[policy]):
            assert torch.equal(a, b), policy
    again = {policy: n - products[None] for policy, n in products.items()}
    assert again["nothing"]["mm"] > 0 and again["nothing"]["bmm"] > 0
    if cfg.is_encdec:
        assert again["dots"] == again["dots_nb"] == again["nothing"]
    else:
        assert not again["dots"]
        assert again["dots_nb"] == Counter(bmm=again["nothing"]["bmm"])


def test_remat_refuses_an_unknown_policy():
    cfg, _, jp, batch = _setup("qwen3-4b")
    c = dataclasses.replace(cfg, remat=True, remat_policy="everything")
    p = _to_port(c, jp)
    T.leaves(p)[0].requires_grad_(True)
    with pytest.raises(ValueError, match="remat_policy"):
        _port_loss(c, p, batch)


def test_step_call_structure_with_remat(monkeypatch):
    """What a train step gives the rmsnorm and attention kernels (on the CPU
    their plain versions; chip_smoke.py counts the kernels on the card):
    the forward's 4 norms a layer (norm1, q-norm, k-norm, norm2) and the
    final norm, the remat recompute's 4 a layer, and one attention a layer
    in each; the backward kernels run once per forward call outside the
    recompute, which autograd differentiates."""
    cfg = dataclasses.replace(get_config("qwen3-4b", reduced=True),
                              n_layers=3, remat=True)
    calls = {"rmsnorm": 0, "attention": 0}

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(ref, "rmsnorm_rows",
                        counted("rmsnorm", ref.rmsnorm_rows))
    monkeypatch.setattr(ref, "mha_attention",
                        counted("attention", ref.mha_attention))
    p = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = OptConfig()
    step = make_train_step(cfg, ShapeSpec("t", 32, 2, "train"), opt, "cpu")
    step(p, init_state(p, opt),
         for_arch(cfg, 32, 2).device_batch(0, "cpu"))
    L = cfg.n_layers
    assert calls == {"rmsnorm": (4 * L + 1) + 4 * L, "attention": 2 * L}


def test_trainer_loss_decreases_and_resumes(tmp_path):
    cfg = get_config("qwen3-4b", reduced=True)
    shape = ShapeSpec("t", 64, 8, "train")
    tr = Trainer(cfg, shape, device="cpu", options=TrainOptions(
        steps=40, ckpt_every=10, ckpt_dir=str(tmp_path), log_every=1000))
    tr.run()
    losses = [m["loss"] for m in tr.metrics_log]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05
    # resume continues from the checkpoint, not from scratch
    tr2 = Trainer(cfg, shape, device="cpu", options=TrainOptions(
        steps=45, ckpt_every=10, ckpt_dir=str(tmp_path), log_every=1000))
    tr2.run()
    assert min(m["step"] for m in tr2.metrics_log) == 40


def test_trainer_survives_injected_fault(tmp_path):
    cfg = get_config("mamba2-2.7b", reduced=True)
    tr = Trainer(cfg, ShapeSpec("t", 32, 4, "train"), device="cpu",
                 options=TrainOptions(steps=16, ckpt_every=5,
                                      ckpt_dir=str(tmp_path),
                                      fail_at_step=8, log_every=1000))
    tr.run()
    assert tr.failures == 1
    assert "injected fault" in tr.fault_log[0]
    assert max(m["step"] for m in tr.metrics_log) == 15


def test_fault_resume_replays_the_uninterrupted_losses(tmp_path):
    cfg = get_config("qwen3-4b", reduced=True)
    shape = ShapeSpec("t", 32, 4, "train")
    runs = []
    for fail in (-1, 7):
        tr = Trainer(cfg, shape, device="cpu", options=TrainOptions(
            steps=12, ckpt_every=5, ckpt_dir=str(tmp_path / str(fail)),
            fail_at_step=fail, log_every=1000))
        tr.run()
        runs.append({m["step"]: m["loss"] for m in tr.metrics_log})
    assert runs[1].keys() == runs[0].keys() == set(range(12))
    for s in range(12):
        assert runs[1][s] == pytest.approx(runs[0][s], rel=1e-6)


def test_trainer_trains_reduced_dbrx_and_replays_a_fault(tmp_path):
    """A MoE arch through ``Trainer`` (reduced dbrx-132b: top-2 of 4
    experts, layernorm; its config's bf16 moments, peak lr 1e-3 as the
    card's MoE runs take): the loss falls, and a
    run with a fault at step 7, resumed from step 5's checkpoint, replays
    the uninterrupted losses (the index dispatch's backward is
    deterministic).  4 x 32 tokens, as the replay test above: past 32,768
    elements PyTorch's CPU backward of a gather (the embedding's, the
    dispatch's) accumulates with parallel atomics, and two runs then part
    in the last bits; the card's sorts its indices and sums in order."""
    cfg = get_config("dbrx-132b", reduced=True)
    assert cfg.moment_dtype == "bfloat16"
    shape = ShapeSpec("t", 32, 4, "train")
    opt = OptConfig(peak_lr=1e-3, warmup_steps=5, total_steps=30)
    runs = []
    for fail in (-1, 7):
        tr = Trainer(cfg, shape, opt=opt, device="cpu", options=TrainOptions(
            steps=30, ckpt_every=5, ckpt_dir=str(tmp_path / str(fail)),
            fail_at_step=fail, log_every=1000))
        tr.run()
        runs.append({m["step"]: m["loss"] for m in tr.metrics_log})
    losses = [runs[0][s] for s in range(30)]
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.05
    assert runs[1].keys() == runs[0].keys() == set(range(30))
    for s in range(30):
        assert runs[1][s] == pytest.approx(runs[0][s], rel=1e-6)


def test_trainer_gives_a_passed_optconfig_the_configs_moments():
    """An ``OptConfig`` that names no ``moment_dtype`` takes the arch
    config's (bf16 for the >= 100B MoE configs), one that names its own
    keeps it, and the drawn state's moments are of that dtype."""
    cfg = get_config("dbrx-132b", reduced=True)
    shape = ShapeSpec("t", 16, 2, "train")
    for opt, want in ((OptConfig(peak_lr=1e-3), torch.bfloat16),
                      (OptConfig(moment_dtype="float32"), torch.float32)):
        tr = Trainer(cfg, shape, opt=opt, device="cpu",
                     options=TrainOptions(steps=1, ckpt_every=0))
        assert tr.opt_cfg.peak_lr == opt.peak_lr
        _, state, _ = tr.init_state()
        moments = T.leaves(state["m"]) + T.leaves(state["v"])
        assert moments and all(t.dtype == want for t in moments)


def test_trainer_drops_the_old_state_before_drawing_a_new_one(tmp_path):
    """A step that fails with its state referenced from the failing frame
    (as a real fault's traceback holds the step's gradients): when the
    fault path draws the new state, no reference to the old parameters
    or moments is left (weakrefs, no garbage collection), so a fault at
    full width does not hold two states."""
    cfg = get_config("qwen3-4b", reduced=True)
    tr = Trainer(cfg, ShapeSpec("t", 16, 2, "train"), device="cpu",
                 options=TrainOptions(steps=3, ckpt_every=0,
                                      ckpt_dir=str(tmp_path),
                                      log_every=1000))
    drawn, alive_at_draw = [], []
    init_state, step_fn = tr.init_state, tr.step_fn

    def counted_init_state(seed=0):
        alive_at_draw.append(sum(r() is not None for r in drawn))
        params, opt_state, step = init_state(seed)
        drawn.extend(weakref.ref(t) for t in
                     T.leaves(params) + T.leaves(opt_state))
        return params, opt_state, step

    def failing_step(params, opt_state, batch):
        if tr.metrics_log and not tr.failures:
            held = (params, opt_state)   # noqa: F841 — in the traceback
            raise RuntimeError("fault with the step's state referenced")
        return step_fn(params, opt_state, batch)

    tr.init_state, tr.step_fn = counted_init_state, failing_step
    tr.run()
    assert tr.failures == 1 and len(alive_at_draw) == 2
    assert alive_at_draw == [0, 0]
    assert [m["step"] for m in tr.metrics_log] == [0, 0, 1, 2]


def test_training_entry_points_default_to_the_card(monkeypatch):
    """``device=None`` means the CUDA card, and raises where there is
    none: the trainer, the step and the data's device batch."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-4b", reduced=True)
    shape = ShapeSpec("t", 16, 2, "train")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg, shape)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_train_step(cfg, shape)
    with pytest.raises(RuntimeError, match="CUDA"):
        for_arch(cfg, 16, 2).device_batch(0)
