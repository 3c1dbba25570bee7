"""The port's training step at train_4k's shape against the JAX package's,
on the CPU (ROADMAP C.9).

``chip_smoke.py`` trains qwen3-4b's cut at train_4k's 2 x 4,096 tokens a
step.  Here the reference's reduced qwen3-4b takes that run's schedule (2
warm-up steps to peak lr 1e-3, a cosine to ``total_steps`` 10) on 2 x
4,096 tokens of ``SyntheticLM`` seed 0 through both packages'
``make_train_step`` (the port's runs ``apply_updates``) from the same
parameters, carried across by ``convert.params_from_jax``, for its first
STEPS steps: the warm-up, the peak and the first step of the cosine, so
every branch of the schedule.  (At this length a step of the plain
attention takes seconds on the CPU in either package, so the run stops
there.)  Every step's loss and gradient norm agree within 1e-4 relative:
a fault of the port's step or optimizer at this length would part the
two runs.  AdamW's eps is 1e-3, for the reason
``test_train_step_matches_the_reference_step`` gives; on the CPU the
embedding's backward (an accumulating ``index_put_`` over 8,192 rows)
adds with atomics, so two port runs can differ in the last bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs.shapes import ShapeSpec as RefShapeSpec
from repro.launch.mesh import make_local_mesh
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import lm as ref_lm
from repro.optim import adamw as ref_adamw
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.convert import params_from_jax
from repro_torch.data import for_arch
from repro_torch.launch.steps import make_train_step
from repro_torch.optim import OptConfig, init_state

ARCH, BATCH, SEQ, WARMUP, PEAK_LR, TOTAL = "qwen3-4b", 2, 4096, 2, 1e-3, 10
STEPS, EPS, REL = 3, 1e-3, 1e-4


def test_train_4k_steps_match_the_reference_steps():
    cfg, rcfg = get_config(ARCH, reduced=True), ref_get_config(ARCH,
                                                                reduced=True)
    kw = dict(peak_lr=PEAK_LR, warmup_steps=WARMUP, total_steps=TOTAL,
              eps=EPS)
    tree, _ = ref_lm.init(rcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, tree)
    ref_step = ref_make_train_step(
        rcfg, make_local_mesh(), RefShapeSpec("train_4k", SEQ, BATCH,
                                              "train"),
        ref_adamw.OptConfig(**kw)).jit()
    rparams = jax.tree.map(jnp.asarray, np_tree)
    ropt = ref_adamw.init_state(rparams, ref_adamw.OptConfig(**kw))
    opt = OptConfig(**kw)
    step = make_train_step(cfg, ShapeSpec("train_4k", SEQ, BATCH, "train"),
                           opt, "cpu")
    params = params_from_jax(cfg, np_tree, "cpu")
    state = init_state(params, opt)
    data = for_arch(cfg, SEQ, BATCH, seed=0)
    got, want = [], []
    for i in range(STEPS):
        batch = data.batch(i)
        assert batch["tokens"].shape == (BATCH, SEQ)
        rparams, ropt, rm = ref_step(
            rparams, ropt, {k: jnp.asarray(v) for k, v in batch.items()})
        params, state, m = step(params, state, {
            k: torch.from_numpy(v).long() for k, v in batch.items()})
        want.append((float(rm["loss"]), float(rm["grad_norm"]),
                     float(rm["lr"])))
        got.append((float(m["loss"]), float(m["grad_norm"]), float(m["lr"])))
    for i, ((loss, gnorm, lr), (rloss, rgnorm, rlr)) in enumerate(
            zip(got, want)):
        assert np.isfinite([loss, gnorm]).all(), (i, got)
        assert loss == pytest.approx(rloss, rel=REL), (i, got, want)
        assert gnorm == pytest.approx(rgnorm, rel=REL), (i, got, want)
        assert lr == pytest.approx(rlr, rel=1e-6), (i, got, want)
    # the warm-up's half of the peak, the peak, then the cosine below it
    assert want[0][2] == pytest.approx(PEAK_LR / 2) and \
        want[1][2] == pytest.approx(PEAK_LR) and want[2][2] < PEAK_LR
    assert int(state["step"]) == STEPS
