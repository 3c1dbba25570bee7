"""The other archs at the reference's 32k lengths, against the JAX package,
on the CPU.

``prefill_32k`` and ``decode_32k`` (``src/repro/configs/shapes.py``) take
internlm2-20b, nemotron-4-15b, qwen1.5-4b, qwen2-vl-2b and whisper-medium
where their short tests never go: past ``attn_chunk_threshold`` both
packages run their plain attention over 1,024-row query chunks (whisper's
encoder and cross-attention non-causally, over every key), and decode
writes and reads rows past 32,768 of a 32,800-row cache, with RoPE,
M-RoPE's three text streams or whisper's sinusoidal positions there.  To
keep the prompts short the threshold is lowered to 2,048 on both sides (a
multiple of the chunk).  Reduced configs at fp32; parameters come from the
reference's ``init`` and cross as numpy; data comes from seeded numpy.
Every pass's logits are held within 1e-5 of their largest.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import shapes as ref_shapes
from repro.kernels import ref as jref
from repro.models import encdec as ref_encdec
from repro.models import lm as ref_lm
from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, enc_len
from repro_torch.convert import encdec_params_from_jax, params_from_jax
from repro_torch.kernels import ref
from repro_torch.models import encdec, lm

# the chunked plain path's threshold on both sides, prefill_32k's cache and
# the first decode positions past its prompt
THRESHOLD, LONG_MAX_LEN, DECODE_POSITIONS = 2048, 32800, (32768, 32769, 32799)
DENSE_ARCHS = ("internlm2-20b", "nemotron-4-15b", "qwen1.5-4b", "qwen2-vl-2b")


def _configs(arch):
    """(port, reference) reduced configs with the lowered threshold."""
    return tuple(dataclasses.replace(get(arch, reduced=True),
                                     attn_chunk_threshold=THRESHOLD)
                 for get in (get_config, ref_get_config))


def _count_chunked(monkeypatch) -> list:
    """Calls of the port's chunked plain attention, from now on."""
    calls = []
    plain_chunked = ref.mha_attention_chunked
    monkeypatch.setattr(ref, "mha_attention_chunked",
                        lambda *a, **k: calls.append(k.get("causal", True))
                        or plain_chunked(*a, **k))
    return calls


def _close(passes):
    for got, want in passes:
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_chunked_prefill_and_decode_past_32k_match_the_reference(
        arch, monkeypatch):
    """A prompt at the threshold takes both packages' chunked plain
    attention (causal; each layer's counted on the port's side), then
    decode steps at 32,768, 32,769 and 32,799 of a 32,800-row cache:
    qwen1.5-4b's qkv bias, qwen2-vl-2b's M-RoPE text streams, nemotron-4-
    15b's layernorm, internlm2-20b's grouped heads at those positions."""
    cfg, rcfg = _configs(arch)
    tree, _ = ref_lm.init(rcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, tree)
    jp, p = jax.tree.map(jnp.asarray, np_tree), params_from_jax(
        cfg, np_tree, "cpu")
    S = THRESHOLD
    tok = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, S + len(DECODE_POSITIONS)))

    chunked = _count_chunked(monkeypatch)
    want, rcache = ref_lm.prefill(rcfg, jp, jnp.asarray(tok[:, :S], jnp.int32),
                                  max_len=LONG_MAX_LEN)
    got, cache = lm.prefill(cfg, p, torch.from_numpy(tok[:, :S]),
                            max_len=LONG_MAX_LEN, plain=True)
    assert chunked == [True] * cfg.n_layers
    passes = [(got, want)]
    for i, pos in enumerate(DECODE_POSITIONS):
        step = tok[:, S + i:S + i + 1]
        want, rcache = ref_lm.decode_step(
            rcfg, jp, rcache, jnp.asarray(step, jnp.int32), jnp.int32(pos))
        got, cache = lm.decode_step(cfg, p, cache, torch.from_numpy(step),
                                    pos, plain=True)
        passes.append((got, want))
    _close(passes)
    k = cache["pos0"]["k"][0]
    assert k.shape[2] == LONG_MAX_LEN
    assert bool(k[:, :, list(DECODE_POSITIONS)].abs().amax(-1).gt(0).all())
    assert not k[:, :, S:DECODE_POSITIONS[0]].any()


def test_whisper_chunked_encoder_prompt_and_decode_past_32k(monkeypatch):
    """whisper-medium: the encoder over as many frames as the threshold
    (non-causal, chunked), the prompt's causal self-attention and its
    cross-attention (non-causal, chunked) over them, then decode steps at
    32,768, 32,769 and 32,799 with their sinusoidal positions, the
    cross-attention over every frame."""
    cfg, rcfg = _configs("whisper-medium")
    tree, _ = ref_encdec.init(rcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, tree)
    jp, p = jax.tree.map(jnp.asarray, np_tree), encdec_params_from_jax(
        cfg, np_tree, "cpu")
    S = THRESHOLD
    rng = np.random.default_rng(2)
    frames = rng.standard_normal((1, S, cfg.d_model)).astype(np.float32)
    tok = rng.integers(0, cfg.vocab_size, (1, S + len(DECODE_POSITIONS)))

    chunked = _count_chunked(monkeypatch)
    want, rcache = ref_encdec.prefill(
        rcfg, jp, jnp.asarray(frames), jnp.asarray(tok[:, :S], jnp.int32),
        max_len=LONG_MAX_LEN)
    got, cache = encdec.prefill(cfg, p, torch.from_numpy(frames),
                                torch.from_numpy(tok[:, :S]),
                                max_len=LONG_MAX_LEN, plain=True)
    # encoder layers (full), then each decoder layer's self (causal) and
    # cross (full) attention
    assert chunked == [False] * cfg.encoder_layers \
        + [True, False] * cfg.n_layers
    assert cache["self_k"].shape[3] == LONG_MAX_LEN
    assert cache["cross_k"].shape[3] == S
    passes = [(got, want)]
    for i, pos in enumerate(DECODE_POSITIONS):
        step = tok[:, S + i:S + i + 1]
        want, rcache = ref_encdec.decode_step(
            rcfg, jp, rcache, jnp.asarray(step, jnp.int32), jnp.int32(pos))
        got, cache = encdec.decode_step(cfg, p, cache, torch.from_numpy(step),
                                        pos, plain=True)
        passes.append((got, want))
    _close(passes)


@pytest.mark.parametrize("sq,skv", [(2048, 2048), (2048, 3000)],
                         ids=["self", "cross"])
def test_non_causal_chunked_attention_reads_every_key(sq, skv):
    """Non-causal, each query chunk attends over every key (the causal key
    range does not apply): the port's chunked plain version against its
    unchunked one and the reference's chunked scan, GQA 2."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((1, 4, sq, 16), (1, 2, skv, 16), (1, 2, skv, 16)))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = ref.mha_attention_chunked(tq, tk, tv, causal=False)
    torch.testing.assert_close(
        got, ref.mha_attention(tq, tk, tv, causal=False), rtol=2e-6,
        atol=2e-6)
    want = np.asarray(jref.mha_attention_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("d", [64, 1024])
def test_sinusoidal_past_32k_is_the_references(d):
    """The encoder's and the prompt's positions over a 32,800-row
    sequence, in float64 on both sides: the same bits."""
    got = encdec.sinusoidal(LONG_MAX_LEN, d)
    np.testing.assert_array_equal(
        got, np.asarray(ref_encdec.sinusoidal(LONG_MAX_LEN, d)))


@pytest.mark.parametrize("d", [64, 1024])
def test_decode_position_past_32k_is_the_references(d):
    """decode_step's fp32 encoding of positions past 32,768 against the
    reference's (jnp.power, sin, cos in fp32): the angles pos / 10000^(i/d)
    of the two may part by an ulp of the angle (2^-8 at these positions),
    and the encodings by no more."""
    dim = jnp.arange(0, d, 2, dtype=jnp.float32)
    for pos in DECODE_POSITIONS:
        ang = jnp.float32(pos) / jnp.power(10000.0, dim / d)
        want = np.zeros(d, np.float32)
        want[0::2] = np.asarray(jnp.sin(ang))
        want[1::2] = np.asarray(jnp.cos(ang))
        got = encdec._decode_position(d, pos, torch.device("cpu"),
                                      torch.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2 ** -8)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_encoder_frames_are_the_references(shape):
    """whisper's encoder reads as many frames as the cell's sequence."""
    cfg, rcfg = (get("whisper-medium") for get in (get_config,
                                                    ref_get_config))
    assert enc_len(cfg, SHAPES[shape]) == ref_shapes._enc_len(
        rcfg, ref_shapes.SHAPES[shape]) == SHAPES[shape].seq_len


@pytest.mark.parametrize("shape", [
    (2, 4, 2, 64, 64, True), (1, 6, 3, 40, 100, True),
    (1, 2, 1, 50, 30, True), (2, 4, 4, 33, 70, False), (1, 2, 2, 1, 96, True)],
    ids=["square", "offset", "blind-rows", "full", "decode"])
def test_plain_attention_without_autograd_is_the_autograd_path_bit_for_bit(
        shape):
    """``ref.mha_attention`` where autograd records nothing (its passes in
    place, the masks over the key columns past the offset) against the
    same call on inputs that require grad (torch.where over every score):
    the same bits, rows that see no key (0) included; and its chunked
    form likewise."""
    B, Hq, Hkv, Sq, Skv, causal = shape
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((B, Hq, Sq, 16), (B, Hkv, Skv, 16),
                         (B, Hkv, Skv, 16)))
    got = ref.mha_attention(q, k, v, causal=causal)
    want = ref.mha_attention(*(t.clone().requires_grad_() for t in (q, k, v)),
                             causal=causal)
    assert torch.equal(got, want.detach())
    if Sq > Skv and causal:
        assert not got[:, :, :Sq - Skv].any()
    if Sq % 16 == 0:
        chunked = ref.mha_attention_chunked(q, k, v, causal=causal, q_chunk=16)
        with_grad = ref.mha_attention_chunked(
            *(t.clone().requires_grad_() for t in (q, k, v)), causal=causal,
            q_chunk=16)
        assert torch.equal(chunked, with_grad.detach())
