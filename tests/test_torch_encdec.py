"""whisper-medium's encoder-decoder in the port against the JAX package's.

The reduced config (2 encoder and 2 decoder layers, d_model 64, 4 heads
of 16, layernorm, gelu MLP, fp32 compute) runs ``encode``, ``forward``,
``prefill`` and ``decode_step`` on the reference's parameters, carried as
numpy by ``convert.encdec_params_from_jax`` with the norm gains and biases
perturbed.  Frames and tokens come from seeded numpy.  Logits are held to
1e-4 of their largest magnitude and encoder states to 1e-4 of theirs
(fp32 sums in another order; XLA's sin/cos/pow against torch's in the
last bit, ROADMAP C.3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import encdec as ref_encdec
from repro_torch.configs import get_config
from repro_torch.convert import encdec_params_from_jax
from repro_torch.models import encdec

ARCH = "whisper-medium"


def _perturb(tree, rng, path=""):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, f"{path}/{k}") for k, v in tree.items()}
    arr = np.asarray(tree)
    if "norm" in path:
        arr = arr + rng.normal(scale=0.1, size=arr.shape).astype(arr.dtype)
    return arr


_PARAMS = {}


def _params():
    """(port cfg, ref cfg, jax params, port params on the CPU)."""
    if not _PARAMS:
        cfg, rcfg = get_config(ARCH, reduced=True), ref_get_config(ARCH,
                                                                  reduced=True)
        tree, _ = ref_encdec.init(rcfg, jax.random.PRNGKey(5))
        np_tree = _perturb(jax.tree.map(np.asarray, tree),
                           np.random.default_rng(6))
        _PARAMS.update(cfg=cfg, rcfg=rcfg,
                       jp=jax.tree.map(jnp.asarray, np_tree),
                       p=encdec_params_from_jax(cfg, np_tree, "cpu"))
    return _PARAMS["cfg"], _PARAMS["rcfg"], _PARAMS["jp"], _PARAMS["p"]


def _inputs(cfg, B, S_enc, S, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S_enc, cfg.d_model)).astype(np.float32),
            rng.integers(0, cfg.vocab_size, (B, S)))


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))


def test_whisper_config_is_run_at_its_published_width():
    cfg = get_config(ARCH)
    assert (cfg.encoder_layers, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (24, 24, 1024, 16, 16, 64, 4096, 51865)
    assert cfg.is_encdec and cfg.norm_kind == "layernorm" \
        and cfg.mlp_kind == "gelu"
    encdec.check_supported(cfg)


@pytest.mark.parametrize("seq, offset", [(16, 0), (1500, 0), (7, 3)])
def test_sinusoidal_is_the_references(seq, offset):
    got = encdec.sinusoidal(seq, 64, offset)
    want = np.asarray(ref_encdec.sinusoidal(seq, 64, offset))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pos", [0, 6, 1499])
def test_decode_position_is_the_references(pos):
    """decode_step's fp32 encoding of one position against the reference's
    (jnp.power, sin, cos in fp32): equal to an ulp of XLA's functions."""
    d = 64
    dim = jnp.arange(0, d, 2, dtype=jnp.float32)
    ang = jnp.float32(pos) / jnp.power(10000.0, dim / d)
    want = np.zeros(d, np.float32)
    want[0::2], want[1::2] = np.asarray(jnp.sin(ang)), np.asarray(jnp.cos(ang))
    got = encdec._decode_position(d, pos, torch.device("cpu"), torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


def test_encode_matches_the_reference():
    cfg, rcfg, jp, p = _params()
    frames, _ = _inputs(cfg, 2, 20, 1, 1)
    want = ref_encdec.encode(rcfg, jp, jnp.asarray(frames))
    got = encdec.encode(cfg, p, torch.from_numpy(frames))
    assert got.shape == (2, 20, cfg.d_model) and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_forward_matches_the_reference():
    cfg, rcfg, jp, p = _params()
    frames, tok = _inputs(cfg, 2, 20, 12, 2)
    want, _ = ref_encdec.forward(rcfg, jp, jnp.asarray(frames),
                                 jnp.asarray(tok, jnp.int32))
    got = encdec.forward(cfg, p, torch.from_numpy(frames),
                         torch.from_numpy(tok))
    assert got.shape == (2, 12, cfg.vocab_size) and got.dtype == torch.float32
    _close(got.numpy(), want)


def test_prefill_and_decode_match_the_reference():
    """The cross cache over a 20-frame encoder, the self cache of an
    8-token prompt, then 4 decode steps reading both."""
    cfg, rcfg, jp, p = _params()
    frames, tok = _inputs(cfg, 2, 20, 12, 3)
    want, rcache = ref_encdec.prefill(rcfg, jp, jnp.asarray(frames),
                                      jnp.asarray(tok[:, :8], jnp.int32),
                                      max_len=12)
    got, cache = encdec.prefill(cfg, p, torch.from_numpy(frames),
                                torch.from_numpy(tok[:, :8]), max_len=12)
    _close(got.numpy(), want)
    assert set(cache) == set(rcache)
    for name, t in cache.items():
        assert tuple(t.shape) == rcache[name].shape, name
        np.testing.assert_allclose(t.numpy(), np.asarray(rcache[name]),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    for t in range(8, 12):
        want, rcache = ref_encdec.decode_step(
            rcfg, jp, rcache, jnp.asarray(tok[:, t:t + 1], jnp.int32),
            jnp.int32(t))
        got, cache = encdec.decode_step(cfg, p, cache,
                                        torch.from_numpy(tok[:, t:t + 1]), t)
        _close(got.numpy(), want)


@pytest.mark.parametrize("kv_len", [None, 12])
def test_cross_attention_decode_matches_the_reference(kv_len):
    """``layers.attention_decode(cross=True)`` over an encoder cache of 20
    rows, all of them or the first ``kv_len``: it writes nothing to the
    cache and gives the reference's output."""
    from repro.models import layers as ref_layers
    from repro_torch.models import layers
    cfg, rcfg, jp, p = _params()
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, 2, cfg.n_kv_heads, 20, cfg.head_dim)
                             ).astype(np.float32)
    attn = p["decoder"][0]["cross_attn"]
    ck, cv = (torch.from_numpy(a.copy()) for a in kv)
    got, ck2, cv2 = layers.attention_decode(cfg, attn, torch.from_numpy(x),
                                            ck, cv, 5, cross=True,
                                            kv_len=kv_len)
    assert torch.equal(ck2, torch.from_numpy(kv[0]))
    assert torch.equal(cv2, torch.from_numpy(kv[1]))
    ref_attn = jax.tree.map(lambda a: a[0], jp["decoder"])["cross_attn"]
    want, _, _ = ref_layers.attention_decode(
        rcfg, ref_attn, jnp.asarray(x), jnp.asarray(kv[0]),
        jnp.asarray(kv[1]), jnp.int32(5), cross=True, kv_len=kv_len)
    _close(got.numpy(), want)


def test_whisper_decode_consistency():
    """Port of tests/test_models.py::test_whisper_decode_consistency on the
    port's own parameters: prefill + decode give forward's logits."""
    cfg = get_config(ARCH, reduced=True)
    B, S = 2, 10
    p = encdec.init(cfg, torch.Generator().manual_seed(2), "cpu")
    frames, tok = _inputs(cfg, B, 16, S, 2)
    frames, tok = torch.from_numpy(frames), torch.from_numpy(tok)
    full = encdec.forward(cfg, p, frames, tok)
    pre, cache = encdec.prefill(cfg, p, frames, tok[:, :6], max_len=S)
    errs = [float((pre - full[:, 5]).abs().max())]
    for t in range(6, S):
        sl, cache = encdec.decode_step(cfg, p, cache, tok[:, t:t + 1], t)
        errs.append(float((sl - full[:, t]).abs().max()))
    assert max(errs) < 2e-3, errs


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_init_cast_is_cast_params_of_init_bit_for_bit(compute):
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              compute_dtype=compute)
    want = encdec.cast_params(cfg, encdec.init(
        cfg, torch.Generator().manual_seed(4), "cpu"))
    got = encdec.init_cast(cfg, torch.Generator().manual_seed(4), "cpu")
    want_leaves, got_leaves = dict(_leaves(want)), dict(_leaves(got))
    assert list(got_leaves) == list(want_leaves)
    for path, t in want_leaves.items():
        assert got_leaves[path].dtype == t.dtype and torch.equal(
            got_leaves[path], t), path
    for path, t in got_leaves.items():
        assert t.dtype == (torch.float32 if "norm" in path
                           else getattr(torch, compute)), path


def test_init_has_the_reference_tree_and_shapes():
    cfg, _, _, carried = _params()
    own = encdec.init(cfg, torch.Generator().manual_seed(0), "cpu")

    def shapes(tree):
        return {path: (tuple(t.shape), t.dtype) for path, t in _leaves(tree)}

    assert shapes(own) == shapes(carried)
    assert len(own["encoder"]) == cfg.encoder_layers
    assert len(own["decoder"]) == cfg.n_layers
    with pytest.raises(ValueError, match="stacked"):
        bad = dataclasses.replace(cfg, n_layers=cfg.n_layers + 1)
        tree, _ = ref_encdec.init(ref_get_config(ARCH, reduced=True),
                                  jax.random.PRNGKey(0))
        encdec_params_from_jax(bad, jax.tree.map(np.asarray, tree), "cpu")


def test_every_norm_and_attention_goes_through_the_kernel_wrappers(monkeypatch):
    """The call structure chip_smoke.py's launch counts derive from, in
    bf16 compute: a prefill runs 2 layernorms an encoder layer, the
    encoder's final norm, 3 a decoder layer and the final norm, and 3
    attentions a layer pair (encoder, self, cross); a decode step 3
    layernorms a decoder layer and the final norm, and 2 attentions a
    decoder layer.  The rows reach the layernorm kernel in bf16; with
    ``plain=True`` no wrapper is called."""
    from repro_torch.kernels import ops, ref
    calls = {"layernorm": [], "attention": 0}

    def norm(x, *args, **kwargs):
        calls["layernorm"].append(x.dtype)
        return ref.layernorm_rows(x, *args, **kwargs)

    def attention(*args, **kwargs):
        calls["attention"] += 1
        return ref.mha_attention(*args, **kwargs)

    monkeypatch.setattr(ops, "layernorm_rows", norm)
    monkeypatch.setattr(ops, "flash_attention", attention)
    cfg = dataclasses.replace(get_config(ARCH, reduced=True),
                              compute_dtype="bfloat16")
    Le, Ld = cfg.encoder_layers, cfg.n_layers
    p = encdec.init_cast(cfg, torch.Generator().manual_seed(0), "cpu")
    frames, tok = _inputs(cfg, 2, 20, 9, 4)
    frames, tok = torch.from_numpy(frames), torch.from_numpy(tok)
    for plain in (True, False):
        calls["layernorm"].clear()
        calls["attention"] = 0
        _, cache = encdec.prefill(cfg, p, frames, tok[:, :6], max_len=9,
                                  plain=plain)
        prefill_calls = (len(calls["layernorm"]), calls["attention"])
        for t in range(6, 9):
            encdec.decode_step(cfg, p, cache, tok[:, t:t + 1], t, plain=plain)
        if plain:
            assert calls == {"layernorm": [], "attention": 0}
            continue
        assert prefill_calls == (2 * Le + 1 + 3 * Ld + 1, Le + 2 * Ld)
        assert len(calls["layernorm"]) == prefill_calls[0] + 3 * (3 * Ld + 1)
        assert calls["attention"] == prefill_calls[1] + 3 * 2 * Ld
        assert set(calls["layernorm"]) == {torch.bfloat16}
