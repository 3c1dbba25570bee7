"""M-RoPE and qwen2-vl-2b in the port against the JAX package's.

``apply_rope`` with (3, B, S) position ids and ``m_rope_sections``, and
qwen2-vl-2b's reduced config (M-RoPE sections (2, 3, 3), qkv bias, fp32
compute) through ``lm.forward`` with distinct (t, h, w) ids, ``prefill``,
``decode_step`` and ``BatchServer``.  The reference's parameters cross as
numpy (``params_from_jax``; norm gains and biases perturbed so that ones
and zeros hide nothing); the port runs its plain versions on the CPU.
Logits are held to 1e-4 of their largest magnitude, as in
``tests/test_torch_models.py``: fp32 sums in another order, and XLA's
sin/cos against torch's in the last bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.mesh import make_local_mesh
from repro.launch.serve import BatchServer as RefBatchServer
from repro.launch.serve import Request as RefRequest
from repro.models import lm as ref_lm
from repro.models.layers import apply_rope as ref_apply_rope
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import BatchServer, Request
from repro_torch.models import lm
from repro_torch.models.layers import apply_rope

ARCH = "qwen2-vl-2b"


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_m_rope_reduces_to_rope_for_text():
    """Port of tests/test_models.py::test_m_rope_reduces_to_rope_for_text."""
    x = torch.from_numpy(_x((2, 8, 4, 16), 3))
    pos = torch.arange(8, dtype=torch.int32)[None].repeat(2, 1)
    std = apply_rope(x, pos, 1e4)
    mr = apply_rope(x, pos[None].expand(3, 2, 8), 1e4, m_rope_sections=(2, 3, 3))
    np.testing.assert_allclose(std.numpy(), mr.numpy(), rtol=1e-6, atol=1e-6)


def test_m_rope_sections_differ_for_spatial_ids():
    """Port of tests/test_models.py::test_m_rope_sections_differ_for_spatial_ids."""
    x = torch.from_numpy(_x((1, 4, 2, 16), 4))
    text = torch.arange(4, dtype=torch.int32)[None][None].expand(3, 1, 4)
    img = text.clone()
    img[1] += 7                          # different h-position ids
    a = apply_rope(x, text, 1e4, m_rope_sections=(2, 3, 3))
    b = apply_rope(x, img, 1e4, m_rope_sections=(2, 3, 3))
    assert float((a - b).abs().max()) > 1e-3


def _ids(B, S, seed):
    """Distinct (t, h, w) ids: t counts the tokens, h and w walk a grid
    (an image's patches), offset per row."""
    rng = np.random.default_rng(seed)
    t = np.broadcast_to(np.arange(S), (B, S))
    h = (np.arange(S) // 4)[None] + rng.integers(0, 5, (B, 1))
    w = (np.arange(S) % 4)[None] + rng.integers(0, 5, (B, 1))
    return np.stack([t, h, w]).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_the_reference_for_distinct_ids(dtype):
    x = _x((2, 12, 4, 16), 5)
    ids = _ids(2, 12, 6)
    got = apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                     torch.from_numpy(ids), 1e6, m_rope_sections=(2, 3, 3))
    want = ref_apply_rope(jnp.asarray(x, dtype), jnp.asarray(ids), 1e6,
                          m_rope_sections=(2, 3, 3))
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_m_rope_sections_must_cover_half_the_head():
    x = torch.zeros(1, 2, 1, 16)
    ids = torch.zeros(3, 1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="sum"):
        apply_rope(x, ids, 1e4, m_rope_sections=(2, 3, 2))
    with pytest.raises(ValueError, match="sum"):
        apply_rope(x, ids, 1e4)


def _perturb(tree, rng, path=""):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, f"{path}/{k}") for k, v in tree.items()}
    arr = np.asarray(tree)
    if "norm" in path or path.rsplit("/", 1)[-1] in ("bq", "bk", "bv"):
        arr = arr + rng.normal(scale=0.1, size=arr.shape).astype(arr.dtype)
    return arr


_PARAMS = {}


def _params():
    """(port cfg, ref cfg, jax params, port params on the CPU)."""
    if not _PARAMS:
        cfg, rcfg = get_config(ARCH, reduced=True), ref_get_config(ARCH,
                                                                  reduced=True)
        tree, _ = ref_lm.init(rcfg, jax.random.PRNGKey(7))
        np_tree = _perturb(jax.tree.map(np.asarray, tree),
                           np.random.default_rng(8))
        _PARAMS.update(cfg=cfg, rcfg=rcfg,
                       jp=jax.tree.map(jnp.asarray, np_tree),
                       p=params_from_jax(cfg, np_tree, "cpu"))
    return _PARAMS["cfg"], _PARAMS["rcfg"], _PARAMS["jp"], _PARAMS["p"]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


def test_qwen2_vl_config_is_served_at_its_published_width():
    cfg = get_config(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (28, 1536, 12, 2, 128, 8960, 151936)
    assert cfg.m_rope and cfg.m_rope_sections == (16, 24, 24)
    assert sum(cfg.m_rope_sections) == cfg.head_dim // 2 and cfg.qkv_bias
    lm.check_supported(cfg)


@pytest.mark.parametrize("ids", ["text", "spatial"])
def test_forward_matches_the_reference(ids):
    """``lm.forward`` with the default (text) positions and with distinct
    (t, h, w) ids fed through ``positions=``."""
    cfg, rcfg, jp, p = _params()
    tok = _tokens(cfg, (2, 12), 9)
    if ids == "text":
        want, _ = ref_lm.forward(rcfg, jp, jnp.asarray(tok, jnp.int32))
        got, _ = lm.forward(cfg, p, torch.from_numpy(tok))
    else:
        pos = _ids(2, 12, 10)
        want, _ = ref_lm.forward(rcfg, jp, jnp.asarray(tok, jnp.int32),
                                 positions=jnp.asarray(pos))
        got, _ = lm.forward(cfg, p, torch.from_numpy(tok),
                            positions=torch.from_numpy(pos))
        text, _ = lm.forward(cfg, p, torch.from_numpy(tok))
        assert float((got - text).abs().max()) > 1e-3
    _close(got.numpy(), want)


def test_prefill_and_decode_match_the_reference():
    cfg, rcfg, jp, p = _params()
    tok = _tokens(cfg, (2, 12), 11)
    want, rcache = ref_lm.prefill(rcfg, jp, jnp.asarray(tok[:, :8], jnp.int32),
                                  max_len=12)
    got, cache = lm.prefill(cfg, p, torch.from_numpy(tok[:, :8]), max_len=12)
    _close(got.numpy(), want)
    for kv in ("k", "v"):
        np.testing.assert_allclose(cache["pos0"][kv].numpy(),
                                   np.asarray(rcache["pos0"][kv]),
                                   rtol=1e-5, atol=1e-5)
    for t in range(8, 12):
        want, rcache = ref_lm.decode_step(
            rcfg, jp, rcache, jnp.asarray(tok[:, t:t + 1], jnp.int32),
            jnp.int32(t))
        got, cache = lm.decode_step(cfg, p, cache,
                                    torch.from_numpy(tok[:, t:t + 1]), t)
        _close(got.numpy(), want)


def test_decode_consistency():
    """Port of tests/test_models.py::test_decode_consistency[qwen2-vl-2b]:
    prefill + decode steps give forward's logits on the port's own
    parameters."""
    cfg = get_config(ARCH, reduced=True)
    B, S, Sp = 2, 12, 8
    tok = torch.from_numpy(_tokens(cfg, (B, S), 1))
    p = lm.init(cfg, torch.Generator().manual_seed(1), "cpu")
    full, _ = lm.forward(cfg, p, tok)
    pre, cache = lm.prefill(cfg, p, tok[:, :Sp], max_len=S)
    errs = [float((pre - full[:, Sp - 1]).abs().max())]
    for t in range(Sp, S):
        step, cache = lm.decode_step(cfg, p, cache, tok[:, t:t + 1], t)
        errs.append(float((step - full[:, t]).abs().max()))
    assert max(errs) < 2e-3, errs


def test_greedy_tokens_equal_the_reference_servers():
    cfg, rcfg = get_config(ARCH, reduced=True), ref_get_config(ARCH,
                                                              reduced=True)
    ref = RefBatchServer(rcfg, make_local_mesh(), max_len=64)
    port = BatchServer(cfg, max_len=64, device="cpu",
                       params=params_from_jax(
                           cfg, jax.tree.map(np.asarray, ref.params), "cpu"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 17, 11)]
    want = ref.serve([RefRequest(i, q, 10) for i, q in enumerate(prompts)])
    got = port.serve([Request(i, q, 10) for i, q in enumerate(prompts)])
    assert got["outputs"] == want["outputs"]


def test_every_norm_and_attention_goes_through_the_kernel_wrappers(monkeypatch):
    """The call structure chip_smoke.py's launch counts derive from: per
    prefill or decode step, 2 rmsnorm calls a layer (no q/k-norm) plus the
    final norm, and one attention a layer; bf16 compute, ``init_cast``."""
    from repro_torch.kernels import ops
    calls = {"rmsnorm": 0, "attention": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(ops, "rmsnorm_rows", counted("rmsnorm", ops.rmsnorm_rows))
    monkeypatch.setattr(ops, "flash_attention",
                        counted("attention", ops.flash_attention))
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              compute_dtype="bfloat16")
    p = lm.init_cast(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.from_numpy(_tokens(cfg, (2, 9), 8))
    _, cache = lm.prefill(cfg, p, tok[:, :6], max_len=9)
    for t in range(6, 9):
        lm.decode_step(cfg, p, cache, tok[:, t:t + 1], t)
    assert calls == {"rmsnorm": 4 * (2 * cfg.n_layers + 1),
                     "attention": 4 * cfg.n_layers}
