"""The port at the reference's long sequence lengths, against the JAX
package, on the CPU.

``prefill_32k`` and ``long_500k`` (``src/repro/configs/shapes.py``) take
paths the short tests never reach: past ``attn_chunk_threshold`` both
packages run their plain attention over 1,024-row query chunks, RoPE
turns at positions past 32,768, and decode reads a cache of 32,800 rows.
At 524,288 positions the plain SSD cannot hold its heads-wide b and c
at once, so ``chip_smoke.py`` holds the ``ssd`` kernel against
``ref.ssd_chained``, ``ref.ssd_chunked`` over segments chained through
the state: here that chain is held against one whole-sequence call and
the reference's ``ssd_chunked``.  Parameters come from
``repro.models.lm.init`` and cross as numpy through ``params_from_jax``;
data comes from seeded numpy.  Reduced configs at fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import ref as jref
from repro.models import lm as ref_lm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ref
from repro_torch.models import lm

# prefill_32k's cache and the first decode positions past it
LONG_MAX_LEN, DECODE_POSITIONS = 32800, (32768, 32769, 32799)


def test_chunked_prefill_and_decode_past_32k_match_the_reference(
        monkeypatch):
    """Reduced qwen3-4b at its own ``attn_chunk_threshold``: an 8,192-token
    prompt takes both packages' chunked plain attention (the port's plain
    versions, ``plain=True``; counted on its side), then decode steps
    write and read rows past 32,768 of a 32,800-row cache with RoPE at
    those positions; every pass's logits within 1e-5 of the largest."""
    cfg, rcfg = (get("qwen3-4b", reduced=True)
                 for get in (get_config, ref_get_config))
    S = cfg.attn_chunk_threshold
    assert S == rcfg.attn_chunk_threshold == 8192
    tree, _ = ref_lm.init(rcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, tree)
    jp, p = jax.tree.map(jnp.asarray, np_tree), params_from_jax(
        cfg, np_tree, "cpu")
    tok = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, S + len(DECODE_POSITIONS)))

    chunked = []
    plain_chunked = ref.mha_attention_chunked
    monkeypatch.setattr(ref, "mha_attention_chunked",
                        lambda *a, **k: chunked.append(1) or
                        plain_chunked(*a, **k))
    want, rcache = ref_lm.prefill(rcfg, jp, jnp.asarray(tok[:, :S], jnp.int32),
                                  max_len=LONG_MAX_LEN)
    got, cache = lm.prefill(cfg, p, torch.from_numpy(tok[:, :S]),
                            max_len=LONG_MAX_LEN, plain=True)
    assert len(chunked) == cfg.n_layers
    assert cache["pos0"]["k"].shape[3] == LONG_MAX_LEN
    passes = [(got, want)]
    for i, pos in enumerate(DECODE_POSITIONS):
        step = tok[:, S + i:S + i + 1]
        want, rcache = ref_lm.decode_step(
            rcfg, jp, rcache, jnp.asarray(step, jnp.int32), jnp.int32(pos))
        got, cache = lm.decode_step(cfg, p, cache, torch.from_numpy(step),
                                    pos, plain=True)
        passes.append((got, want))
    for got, want in passes:
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
    # the rows each decode step wrote, and none between the prompt's and
    # theirs
    k = cache["pos0"]["k"][0]
    assert bool(k[:, :, list(DECODE_POSITIONS)].abs().amax(-1).gt(0).all())
    assert not k[:, :, S:DECODE_POSITIONS[0]].any()


def _ssd_inputs(B, S, H, P, G, N, seed):
    """x ~ N(0, 1), a = -|N(0, 0.1²)|, b and c ~ N(0, 0.3²), float32
    numpy, as the reference's ``_ssd_inputs`` draws them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, H, P))
    a = -np.abs(rng.normal(size=(B, S, H))) * 0.1
    b, c = (rng.normal(size=(B, S, G, N)) * 0.3 for _ in range(2))
    return [v.astype(np.float32) for v in (x, a, b, c)]


@pytest.mark.parametrize("init", [False, True], ids=["zero", "initial"])
def test_ssd_chained_over_segments_is_one_whole_call(init):
    """``ref.ssd_chained`` over 4 segments of 128 positions (chunks of
    32) against one ``ref.ssd_chunked`` call over all 512 and the
    reference's ``ssd_chunked``, from zero and from an initial state: y
    and the final state within 1e-5 of their largest."""
    B, S, H, P, G, N = 2, 512, 4, 16, 2, 8
    x, a, b, c = _ssd_inputs(B, S, H, P, G, N, 1)
    s0 = np.random.default_rng(2).normal(size=(B, H, P, N)).astype(
        np.float32) if init else None
    t = [torch.from_numpy(v) for v in (x, a, b, c)]
    ts0 = None if s0 is None else torch.from_numpy(s0)
    parts = list(ref.ssd_chained(*t, segment=128, chunk=32,
                                 initial_state=ts0))
    assert [s for s, _, _ in parts] == [0, 128, 256, 384]
    y = torch.cat([y for _, y, _ in parts], dim=1)
    state = parts[-1][2]
    whole = ref.ssd_chunked(*t, chunk=32, initial_state=ts0)
    jwant = jref.ssd_chunked(*(jnp.asarray(v) for v in (x, a, b, c)),
                             chunk=32, initial_state=None if s0 is None
                             else jnp.asarray(s0))
    for want_y, want_s in (whole, jwant):
        want_y, want_s = np.asarray(want_y), np.asarray(want_s)
        for got, want in ((y, want_y), (state, want_s)):
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-5 * float(np.abs(want).max()))


def test_ssd_chained_refuses_segments_that_cut_a_chunk():
    x, a, b, c = (torch.from_numpy(v)
                  for v in _ssd_inputs(1, 256, 2, 8, 1, 4, 3))
    with pytest.raises(ValueError, match="whole chunks"):
        next(ref.ssd_chained(x, a, b, c, segment=96, chunk=64))
    with pytest.raises(ValueError, match="whole chunks"):
        next(ref.ssd_chained(x, a, b, c, segment=192, chunk=64))


@pytest.mark.parametrize("shape", [(1, 4, 2, 64, 40, 16, 16),
                                   (2, 4, 1, 96, 96, 16, 32),
                                   (1, 2, 2, 32, 200, 8, 8)])
def test_chunked_attention_reads_only_the_keys_its_chunk_sees(shape):
    """Causal, each query chunk of ``ref.mha_attention_chunked`` reads the
    keys up to its last row's position (none where Sq > Skv leaves a
    whole chunk blind, which gives zeros): ``mha_attention``'s numbers
    within fp32 reordering, the keys past them never read (NaN there)."""
    B, Hq, Hkv, Sq, Skv, D, qc = shape
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))
    want = ref.mha_attention(q, k, v, causal=True)
    got = ref.mha_attention_chunked(q, k, v, causal=True, q_chunk=qc)
    torch.testing.assert_close(got, want, rtol=2e-6, atol=2e-6)
    # the first chunk never reads the keys past its last row's position
    first = Skv - Sq + qc
    if 0 < first < Skv:
        k2, v2 = k.clone(), v.clone()
        k2[:, :, first:], v2[:, :, first:] = float("nan"), float("nan")
        head = ref.mha_attention_chunked(q, k2, v2, causal=True,
                                         q_chunk=qc)[:, :, :qc]
        assert torch.isfinite(head).all()
        torch.testing.assert_close(head, want[:, :, :qc], rtol=2e-6,
                                   atol=2e-6)
