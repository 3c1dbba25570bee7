"""The port's training substrate against the JAX package's: AdamW and its
schedule, the synthetic data pipeline and checkpointing.

Ports of tests/test_substrate.py (optimizer, data, checkpoint), plus
parity: the same gradients through both optimizers for 5 steps give the
same parameters (weight-decay mask included, in the port's per-layer
layout), and both pipelines give the same tokens for a (seed, step).
Inputs are seeded numpy; the reference's trees cross through
``convert.params_from_jax``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.models import lm as ref_lm
from repro.optim import adamw as ref_adamw
from repro_torch import checkpoint as ckpt
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data import DataConfig, SyntheticLM, for_arch
from repro_torch.optim import (OptConfig, adamw, apply_updates,
                               clip_by_global_norm, decay_mask, init_state,
                               lr_at)


# ----------------------------------------------------------------- optimizer

def test_adamw_descends_quadratic():
    opt = OptConfig(peak_lr=0.1, warmup_steps=0, total_steps=200,
                    weight_decay=0.0, grad_clip=1e9)
    params = {"w": torch.ones((4, 4)) * 3.0}
    state = init_state(params, opt)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = apply_updates(params, grads, state, opt)
    assert float(params["w"].abs().max()) < 0.3


def test_lr_schedule_shape():
    opt = OptConfig(peak_lr=1.0, min_lr=0.1, warmup_steps=10,
                    total_steps=110)
    lrs = [float(lr_at(opt, s)) for s in (0, 5, 10, 60, 110)]
    assert lrs[1] == pytest.approx(0.5, abs=0.01)
    assert lrs[2] == pytest.approx(1.0, abs=0.01)
    assert lrs[2] > lrs[3] > lrs[4] >= 0.1 - 1e-6


@pytest.mark.parametrize("step", [0, 1, 5, 50, 99, 100, 101, 3000, 10_000,
                                  20_000])
def test_lr_schedule_matches_the_reference(step):
    opt = OptConfig(warmup_steps=100, total_steps=10_000)
    want = float(ref_adamw.lr_at(ref_adamw.OptConfig(
        warmup_steps=100, total_steps=10_000), jnp.int32(step)))
    got = lr_at(opt, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)


def test_grad_clip():
    g = {"a": torch.ones((10,)) * 100.0}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(100 * np.sqrt(10), rel=1e-5)
    assert float(clipped["a"].square().sum().sqrt()) == \
        pytest.approx(1.0, rel=1e-4)


def test_bf16_moments():
    opt = OptConfig(moment_dtype="bfloat16")
    params = {"w": torch.ones((8,))}
    state = init_state(params, opt)
    assert state["m"]["w"].dtype == torch.bfloat16
    params, state, _ = apply_updates(params, {"w": torch.ones((8,))},
                                     state, opt)
    assert state["v"]["w"].dtype == torch.bfloat16
    assert int(state["step"]) == 1


def _ref_tree(arch="qwen3-4b"):
    """The reference's reduced parameters (stacked over the layers) and
    random gradients of the same structure, as numpy trees."""
    rcfg = ref_get_config(arch, reduced=True)
    jp = jax.tree.map(np.asarray, ref_lm.init(rcfg, jax.random.PRNGKey(0))[0])
    rng = np.random.default_rng(7)
    grads = [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32) * 0.1, jp) for _ in range(5)]
    return rcfg, jp, grads


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_five_steps_match_the_reference(moments):
    rcfg, jp, grads = _ref_tree()
    cfg = get_config("qwen3-4b", reduced=True)
    ropt = ref_adamw.OptConfig(warmup_steps=2, total_steps=10,
                               moment_dtype=moments)
    opt = OptConfig(warmup_steps=2, total_steps=10, moment_dtype=moments)
    rp = jax.tree.map(jnp.asarray, jp)
    rstate = ref_adamw.init_state(rp, ropt)
    p = params_from_jax(cfg, jp, "cpu")
    state = init_state(p, opt)
    for g in grads:
        rp, rstate, rm = ref_adamw.apply_updates(
            rp, jax.tree.map(jnp.asarray, g), rstate, ropt)
        p, state, m = apply_updates(p, params_from_jax(cfg, g, "cpu"),
                                    state, opt)
        assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                      rel=1e-5)
    # fp32 moments: within 1e-6 relative.  bf16 moments round every step,
    # and XLA fuses b1 m + (1 - b1) g where PyTorch rounds twice, so a
    # moment may round to the neighbouring bf16 value: one ulp (2^-8) of m
    # or v moves a step's update by at most lr 2^-7; five steps, 5 lr 2^-7
    want = params_from_jax(cfg, jax.tree.map(np.asarray, rp), "cpu")
    for (path, got), exp in zip(T.leaves_with_paths(p), T.leaves(want)):
        err = float((got - exp).abs().max())
        tol = (1e-6 * float(exp.abs().max()) if moments == "float32"
               else 5 * opt.peak_lr * 2.0 ** -7)
        assert err <= tol, (path, err)
    assert int(state["step"]) == 5


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_sliced_update_is_the_whole_leaf_update_to_the_bit(moments,
                                                           monkeypatch):
    """A leaf past ``adamw.SLICE`` elements is updated a slice of its flat
    view at a time (on the card, dbrx-132b's expert leaves): AdamW is
    element-wise, so five clipped and decayed steps in slices of 1,000
    elements (the last one of each leaf partial) leave the parameters and
    both moments equal to the whole-leaf update's, bit for bit."""
    _, jp, grads = _ref_tree()
    cfg = get_config("qwen3-4b", reduced=True)
    opt = OptConfig(warmup_steps=2, total_steps=10, moment_dtype=moments,
                    grad_clip=0.5)
    runs = []
    for slice_ in (adamw.SLICE, 1000):
        monkeypatch.setattr(adamw, "SLICE", slice_)
        p = params_from_jax(cfg, jp, "cpu")
        state = init_state(p, opt)
        for g in grads:
            p, state, _ = apply_updates(p, params_from_jax(cfg, g, "cpu"),
                                        state, opt)
        runs.append([p, state["m"], state["v"]])
    sliced = [t for t in T.leaves(runs[1][0]) if t.numel() > 1000]
    assert sliced and any(t.numel() % 1000 for t in sliced)
    for whole, parts in zip(runs[0], runs[1]):
        for (path, a), b in zip(T.leaves_with_paths(whole), T.leaves(parts)):
            assert a.dtype == b.dtype and torch.equal(a, b), path


def test_weight_decay_falls_where_the_reference_stacks_the_leaf():
    """The reference stacks each layer's leaves over the layers, so a
    layer's norm gain is 2-D there and decayed; only the ends' 1-D leaves
    (final_norm) escape.  With zero gradients AdamW's step is the decay
    alone: p <- p (1 - lr wd)."""
    cfg = get_config("qwen3-4b", reduced=True)
    _, jp, _ = _ref_tree()
    p = params_from_jax(cfg, jp, "cpu")
    mask = decay_mask(p)
    assert mask["layers"][0]["norm1"]["scale"] is True
    assert mask["layers"][1]["attn"]["q_norm"] is True
    assert mask["final_norm"]["scale"] is False
    assert mask["embed"] is True and mask["lm_head"] is True
    opt = OptConfig(warmup_steps=0, peak_lr=0.5, weight_decay=0.1)
    before = T.tree_map(torch.clone, p)
    p, _, m = apply_updates(p, T.tree_map(torch.zeros_like, p),
                            init_state(p, opt), opt)
    shrink = 1.0 - float(m["lr"]) * 0.1
    torch.testing.assert_close(p["layers"][0]["norm1"]["scale"],
                               before["layers"][0]["norm1"]["scale"] * shrink)
    assert torch.equal(p["final_norm"]["scale"], before["final_norm"]["scale"])


# ---------------------------------------------------------------------- data

def test_data_deterministic_and_restart_safe():
    cfg = DataConfig(vocab_size=97, seq_len=32, global_batch=4, seed=7)
    a = SyntheticLM(cfg).batch(12)
    b = SyntheticLM(cfg).batch(12)   # a fresh pipeline (after a restart)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["labels"], b["labels"])
    c = SyntheticLM(cfg).batch(13)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_data_labels_are_shifted_tokens():
    b = SyntheticLM(DataConfig(vocab_size=97, seq_len=16, global_batch=2,
                               seed=1)).batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_data_learnable_structure():
    """Markov ridge: the next token is predictable 85% of the time."""
    cfg = DataConfig(vocab_size=256, seq_len=128, global_batch=8, seed=3)
    p = SyntheticLM(cfg)
    b = p.batch(0)
    pred = (b["tokens"] * p._a + p._b) % cfg.vocab_size
    assert 0.75 < (pred == b["labels"]).mean() < 0.95


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 9), (3, 1), (11, 250)])
@pytest.mark.parametrize("frames", [0, 8])
def test_data_gives_the_reference_batches_bit_for_bit(seed, step, frames):
    kw = dict(vocab_size=151_936, seq_len=24, global_batch=3, seed=seed,
              frames_dim=frames)
    want = RefSyntheticLM(RefDataConfig(**kw)).batch(step)
    got = SyntheticLM(DataConfig(**kw)).batch(step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_device_batch_and_for_arch():
    cfg = get_config("whisper-medium", reduced=True)
    data = for_arch(cfg, seq_len=8, global_batch=2, seed=1)
    b = data.device_batch(3, "cpu")
    host = data.batch(3)
    assert b["tokens"].dtype == torch.int64 and b["labels"].dtype == torch.int64
    assert b["frames"].dtype == torch.float32
    assert tuple(b["frames"].shape) == (2, 8, cfg.d_model)
    for k in host:
        np.testing.assert_array_equal(b[k].numpy(), host[k])
    assert "frames" not in for_arch(get_config("qwen3-4b", reduced=True),
                                    8, 2).batch(0)


# ---------------------------------------------------------------- checkpoint

def test_checkpoint_roundtrip_and_latest(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.int32)},
            "layers": [{"w": torch.full((3,), 2.5)},
                       {"w": torch.full((3,), 3.5)}]}
    ckpt.save(str(tmp_path), 3, tree, extra={"next_step": 3})
    ckpt.save(str(tmp_path), 7, tree, extra={"next_step": 7})
    assert ckpt.latest_step(str(tmp_path)) == 7
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000007"]
    restored, extra = ckpt.restore(str(tmp_path), 7, tree)
    assert extra["next_step"] == 7
    for got, want in zip(T.leaves(restored), T.leaves(tree)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    with np.load(tmp_path / "step_00000007" / "arrays.npz") as data:
        assert sorted(data.files) == ["a", "b/c", "layers/0/w", "layers/1/w"]


def test_checkpoint_keeps_bf16_leaves_bit_for_bit(tmp_path):
    w = torch.randn(5, 7, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    tree = {"m": w, "step": torch.tensor(3, dtype=torch.int32)}
    path = ckpt.save(str(tmp_path), 1, tree)
    with open(os.path.join(path, "manifest.json")) as f:
        assert '"m": "bfloat16"' in f.read()
    with np.load(os.path.join(path, "arrays.npz")) as data:
        assert data["m"].dtype == np.uint16
    restored, _ = ckpt.restore(str(tmp_path), 1, tree)
    assert restored["m"].dtype == torch.bfloat16
    assert torch.equal(restored["m"].view(torch.int16), w.view(torch.int16))
    assert int(restored["step"]) == 3


def test_checkpoint_detects_corruption(tmp_path):
    tree = {"a": torch.arange(16.0)}
    path = ckpt.save(str(tmp_path), 1, tree)
    np.savez(os.path.join(path, "arrays.npz"), a=np.arange(16.0) + 1)
    with pytest.raises(IOError):
        ckpt.restore(str(tmp_path), 1, tree)


def test_async_saver_snapshots_before_the_caller_moves_on(tmp_path):
    tree = {"w": torch.ones((32, 32))}
    s = ckpt.AsyncSaver()
    s.save(str(tmp_path), 5, tree)
    tree["w"].add_(1.0)       # the trainer updates in place
    s.wait()
    assert ckpt.latest_step(str(tmp_path)) == 5
    restored, _ = ckpt.restore(str(tmp_path), 5, tree)
    assert torch.equal(restored["w"], torch.ones((32, 32)))


def test_checkpoint_shape_mismatch_rejected(tmp_path):
    ckpt.save(str(tmp_path), 1, {"w": torch.ones((4,))})
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), 1, {"w": torch.ones((5,))})


def test_restore_casts_to_the_model_leaf_and_ignores_partial_steps(tmp_path):
    ckpt.save(str(tmp_path), 2, {"w": torch.ones((3,), dtype=torch.float64)})
    os.makedirs(tmp_path / "step_00000009.tmp")      # a save cut short
    assert ckpt.latest_step(str(tmp_path)) == 2
    restored, _ = ckpt.restore(str(tmp_path), 2, {"w": torch.zeros(3)})
    assert restored["w"].dtype == torch.float32
    assert ckpt.latest_step(str(tmp_path / "missing")) is None


def test_tree_paths_and_unflatten():
    tree = {"b": [torch.zeros(1), {"y": torch.ones(2), "x": torch.ones(3)}],
            "a": torch.zeros(4)}
    paths = [p for p, _ in T.leaves_with_paths(tree)]
    assert paths == ["a", "b/0", "b/1/x", "b/1/y"]
    again = T.unflatten(tree, T.leaves(tree))
    assert [p for p, _ in T.leaves_with_paths(again)] == paths
    with pytest.raises(ValueError):
        T.unflatten({"a": 1}, [1, 2])
