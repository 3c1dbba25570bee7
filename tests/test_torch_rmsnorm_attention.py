"""The port's rmsnorm and flash-attention wrappers against the JAX
package's Pallas kernels and oracles.

On the CPU the wrappers run their plain PyTorch versions, which are held
against ``rmsnorm_rows_pallas`` / ``flash_attention_pallas`` in interpret
mode and the jnp oracles on the same seeded numpy inputs, with the
tolerances of tests/test_kernels.py.  The CUDA kernels are held against
the plain versions on the card in test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.sfu import rmsnorm_rows_pallas
from repro_torch.kernels import flash_attention, ops, rmsnorm_rows

SFU_SHAPES = [(64, 128), (100, 300), (8, 17), (256, 512), (5, 1000)]
ATTN_SHAPES = [(1, 4, 2, 64, 64, 32), (2, 8, 2, 32, 128, 64),
               (1, 2, 1, 1, 96, 32), (1, 4, 4, 50, 50, 16),
               (1, 2, 2, 1, 500, 64), (2, 6, 3, 40, 100, 32)]


def _np(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("shape", SFU_SHAPES)
@pytest.mark.parametrize("with_gamma", [False, True], ids=["plain", "gamma"])
def test_rmsnorm_rows(shape, with_gamma):
    x = _np(shape, 40, scale=2.0)
    g = _np((shape[1],), 41) if with_gamma else None
    got = _f32(rmsnorm_rows(torch.from_numpy(x),
                            None if g is None else torch.from_numpy(g)))
    jg = None if g is None else jnp.asarray(g)
    for want in (rmsnorm_rows_pallas(jnp.asarray(x), jg, interpret=True),
                 jref.rmsnorm_rows(jnp.asarray(x), jg)):
        np.testing.assert_allclose(got, _f32(want), rtol=1e-4, atol=1e-5)


def test_rmsnorm_bf16_rows_keep_their_dtype_and_divide_by_the_true_width():
    x = _np((6, 2560), 42)
    g = _np((2560,), 43)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = rmsnorm_rows(xb, torch.from_numpy(g))
    assert got.dtype == torch.bfloat16
    want = jref.rmsnorm_rows(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                             jnp.asarray(g))
    np.testing.assert_array_equal(_f32(got), _f32(want))
    # ops.rmsnorm flattens the leading dims (q/k-norm over heads)
    q = torch.from_numpy(_np((2, 3, 4, 16), 44))
    np.testing.assert_array_equal(
        ops.rmsnorm(q, torch.ones(16)).numpy(),
        rmsnorm_rows(q.reshape(-1, 16), torch.ones(16)).reshape(q.shape).numpy())


def _qkv(shape, dtype=np.float32):
    B, Hq, Hkv, Sq, Skv, D = shape
    return (_np((B, Hq, Sq, D), 45), _np((B, Hkv, Skv, D), 46),
            _np((B, Hkv, Skv, D), 47))


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention(shape, causal):
    q, k, v = _qkv(shape)
    got = _f32(flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal))
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    for want in (flash_attention_pallas(jq, jk, jv, causal=causal, block_q=32,
                                        block_k=64, interpret=True),
                 jref.mha_attention(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(got, _f32(want), rtol=1e-4, atol=2e-5)


def test_flash_attention_bf16():
    q, k, v = _np((1, 4, 32, 64), 48), _np((1, 2, 64, 64), 49), \
        _np((1, 2, 64, 64), 50)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (tq, tk, tv))
    for want in (flash_attention_pallas(jq, jk, jv, block_q=32, block_k=32,
                                        interpret=True),
                 jref.mha_attention(jq, jk, jv)):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("pos", [0, 37, 95])
def test_flash_attention_decode_over_a_cache_prefix(pos):
    """Decode: one query over the first pos + 1 rows of a 96-row cache,
    against the oracle's ``kv_len``; rows past pos are never read."""
    q = _np((2, 4, 1, 32), 51)
    k, v = _np((2, 2, 96, 32), 52), _np((2, 2, 96, 32), 53)
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    tk[:, :, pos + 1:] = float("nan")
    tv[:, :, pos + 1:] = float("nan")
    got = flash_attention(torch.from_numpy(q), tk, tv, causal=False,
                          kv_len=pos + 1)
    want = jref.mha_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=False,
                              kv_len=jnp.full((2,), pos + 1, jnp.int32))
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=2e-5)


def test_flash_attention_rows_without_a_key_give_zero_like_the_kernel():
    """Causal with Sq > Skv: the Pallas kernel gives 0 where the oracle
    gives NaN; the port follows the kernel."""
    q, k, v = _qkv((1, 2, 1, 40, 24, 32))
    got = _f32(flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True))
    want = _f32(flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=True,
                                       block_q=32, block_k=64, interpret=True))
    assert (got[:, :, :16] == 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    oracle = _f32(jref.mha_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=True))
    assert np.isnan(oracle[:, :, :16]).all()
    np.testing.assert_allclose(got[:, :, 16:], oracle[:, :, 16:], rtol=1e-4,
                               atol=2e-5)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(4, 8)
    with pytest.raises(TypeError):
        rmsnorm_rows(x.half())
    with pytest.raises(ValueError):
        rmsnorm_rows(x, torch.ones(8, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        rmsnorm_rows(x.t())
    q, k = torch.zeros(1, 3, 4, 16), torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError):
        flash_attention(q, k, k)          # 3 query heads over 2 KV heads
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 2, 4, 16), k, k, kv_len=5)
    with pytest.raises(TypeError):
        flash_attention(torch.zeros(1, 2, 4, 16), k.bfloat16(), k.bfloat16())


# (B, Hq, Hkv, Sq, Skv, D, q_chunk): GQA groups of 1, 2 and 4, Sq < Skv,
# a chunk of the whole and chunks of a few rows
CHUNKED = [(1, 4, 2, 64, 64, 32, 16), (2, 8, 2, 32, 128, 64, 8),
           (1, 4, 4, 48, 48, 16, 48), (2, 4, 1, 40, 100, 32, 10)]


@pytest.mark.parametrize("shape", CHUNKED)
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_mha_attention_chunked_matches_the_reference(shape, causal):
    """``ref.mha_attention_chunked`` against the reference's (a scan over
    query chunks with a grouped einsum) and against the port's
    unchunked ``mha_attention``: fp32 reorderings only."""
    from repro_torch.kernels import ref
    B, Hq, Hkv, Sq, Skv, D, qc = shape
    q, k, v = (_np((B, Hq, Sq, D), 1), _np((B, Hkv, Skv, D), 2),
               _np((B, Hkv, Skv, D), 3))
    got = ref.mha_attention_chunked(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal, q_chunk=qc)
    want = jref.mha_attention_chunked(*map(jnp.asarray, (q, k, v)),
                                      causal=causal, q_chunk=qc)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)
    whole = ref.mha_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal)
    np.testing.assert_allclose(_f32(got), _f32(whole), rtol=2e-6, atol=2e-6)


def test_plain_attention_is_chunked_at_the_threshold(monkeypatch):
    """``layers.attention_fwd`` takes the chunked plain version at and
    past ``cfg.attn_chunk_threshold`` query rows (the reference's switch,
    ``src/repro/models/layers.py:153-156``), the dense one below it, and
    both give ``ref.mha_attention``'s numbers."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.models import layers
    cfg = dataclasses.replace(get_config("qwen3-4b", reduced=True),
                              attn_chunk_threshold=32)
    p = layers.init_attention(cfg, torch.Generator().manual_seed(0), "cpu")
    calls = []
    real = ref.mha_attention_chunked
    monkeypatch.setattr(ref, "mha_attention_chunked",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    for S, chunked in ((31, False), (32, True), (64, True)):
        x = torch.from_numpy(_np((2, S, cfg.d_model), S))
        pos = torch.arange(S)[None].expand(2, S)
        calls.clear()
        out, _ = layers.attention_fwd(cfg, p, x, pos, plain=True)
        assert bool(calls) == chunked, S
        dense = dataclasses.replace(cfg, attn_chunk_threshold=10 ** 9)
        want, _ = layers.attention_fwd(dense, p, x, pos, plain=True)
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=2e-6,
                                   atol=2e-6)
