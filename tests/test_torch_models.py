"""The port's dense decoders against the JAX package's.

Parameters come from ``repro.models.lm.init`` (the two RNGs never
agree), with the norm gains and QKV biases perturbed so that ones and
zeros hide nothing, and cross as numpy through ``params_from_jax``.
Tokens come from seeded numpy.  Configs are the reduced ones (fp32
compute); the JAX side runs its oracles, the port its plain versions on
``device="cpu"``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro_torch.configs import ARCH_IDS, all_configs, get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import lm

DENSE = ["qwen3-4b", "qwen1.5-4b", "internlm2-20b", "nemotron-4-15b",
         "qwen3-4b-gqa"]
# the MoE archs, unported before MoE was, and the cache repeated over the
# KV heads, unported before the multi-device layer was
UNSUPPORTED = ["jamba-1.5-large-398b",
               "llama4-maverick-400b-a17b", "dbrx-132b"]


def _configs(arch):
    """(port cfg, reference cfg), reduced; "qwen3-4b-gqa" is reduced
    qwen3-4b with 2 KV heads for its 4 query heads (every reduced arch
    has as many KV heads as query heads)."""
    base = arch.removesuffix("-gqa")
    cfg, rcfg = get_config(base, reduced=True), ref_get_config(base, reduced=True)
    if arch.endswith("-gqa"):
        cfg = dataclasses.replace(cfg, n_kv_heads=2)
        rcfg = dataclasses.replace(rcfg, n_kv_heads=2)
    return cfg, rcfg


def _perturb(tree, rng, path=""):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, f"{path}/{k}") for k, v in tree.items()}
    arr = np.asarray(tree)
    leaf = path.rsplit("/", 1)[-1]
    if "norm" in path or leaf in ("bq", "bk", "bv"):
        arr = arr + rng.normal(scale=0.1, size=arr.shape).astype(arr.dtype)
    return arr


_PARAMS = {}


def _params(arch):
    """(port cfg, ref cfg, numpy tree, jax tree, port params on the CPU)."""
    if arch not in _PARAMS:
        cfg, rcfg = _configs(arch)
        tree, _ = ref_lm.init(rcfg, jax.random.PRNGKey(3))
        np_tree = _perturb(jax.tree.map(np.asarray, tree),
                           np.random.default_rng(4))
        _PARAMS[arch] = (cfg, rcfg, np_tree, jax.tree.map(jnp.asarray, np_tree),
                         params_from_jax(cfg, np_tree, "cpu"))
    return _PARAMS[arch]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape)


def _close(got, want, scale):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_logits_match_the_reference(arch):
    cfg, rcfg, _, jp, p = _params(arch)
    tok = _tokens(cfg, (2, 12), 5)
    want, want_aux = ref_lm.forward(rcfg, jp, jnp.asarray(tok, jnp.int32))
    got, aux = lm.forward(cfg, p, torch.from_numpy(tok))
    assert got.dtype == torch.float32
    assert aux.dtype == torch.float32 and float(aux) == float(want_aux) == 0
    _close(got.numpy(), want, float(jnp.abs(want).max()))


@pytest.mark.parametrize("arch", DENSE)
def test_loss_fn_matches_the_reference(arch):
    """``lm.loss_fn`` (nll + z-loss on the fp32 logits' log-sum-exp + the
    aux, 0 here) against ``repro.models.lm.loss_fn`` on the same tokens
    and labels; tests/test_torch_train.py holds the gradients."""
    cfg, rcfg, _, jp, p = _params(arch)
    tok = _tokens(cfg, (2, 13), 7)
    want = ref_lm.loss_fn(rcfg, jp, jnp.asarray(tok[:, :-1], jnp.int32),
                          jnp.asarray(tok[:, 1:], jnp.int32))
    got = lm.loss_fn(cfg, p, torch.from_numpy(tok[:, :-1]),
                     torch.from_numpy(tok[:, 1:]))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    plain = lm.loss_fn(cfg, p, torch.from_numpy(tok[:, :-1]),
                       torch.from_numpy(tok[:, 1:]), z_loss=0.0)
    assert float(plain) < float(got)      # the z-loss adds a positive term


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_the_reference(arch):
    cfg, rcfg, _, jp, p = _params(arch)
    tok = _tokens(cfg, (2, 12), 6)
    want, rcache = ref_lm.prefill(rcfg, jp, jnp.asarray(tok[:, :8], jnp.int32),
                                  max_len=12)
    got, cache = lm.prefill(cfg, p, torch.from_numpy(tok[:, :8]), max_len=12)
    scale = float(jnp.abs(want).max())
    _close(got.numpy(), want, scale)
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
        _close(got.numpy(), want, scale)


def test_decode_consistency():
    """Port of tests/test_models.py::test_decode_consistency on qwen3-4b:
    prefill + decode steps give forward's logits, on the port's own
    parameters."""
    cfg = get_config("qwen3-4b", reduced=True)
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


def test_init_has_the_reference_tree_and_shapes():
    cfg, _, _, _, carried = _params("qwen3-4b")
    own = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert shapes(own) == shapes(carried)
    assert len(own["layers"]) == cfg.n_layers
    # the reference's scales: embed 0.02, lm_head 1/sqrt(d)
    assert abs(float(own["embed"].std()) - 0.02) < 2e-3
    assert abs(float(own["lm_head"].std()) - cfg.d_model ** -0.5) < 0.02


def test_casting_once_at_load_gives_the_numbers_of_casting_at_use():
    """bf16 compute: ``cast_params`` at load against the weights cast at
    every use (the reference's ``.astype(x.dtype)``), bit for bit, on
    qwen3-4b and mamba2-2.7b (whose A_log, dt_bias and gated-norm gain the
    model code uses in fp32: casting them would change the numbers)."""
    for arch, weight, kept in (
            ("qwen3-4b", ("attn", "wq"), [("attn", "q_norm")]),
            ("mamba2-2.7b", ("ssm", "in_proj"),
             [("ssm", "A_log"), ("ssm", "dt_bias"), ("ssm", "norm")])):
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  compute_dtype="bfloat16")
        p = lm.init(cfg, torch.Generator().manual_seed(2), "cpu")
        cast = lm.cast_params(cfg, p)
        layer = cast["layers"][0]
        assert layer[weight[0]][weight[1]].dtype == torch.bfloat16
        for sub, name in kept:
            assert layer[sub][name].dtype == torch.float32, (arch, name)
        assert layer["norm1"]["scale"].dtype == torch.float32
        tok = torch.from_numpy(_tokens(cfg, (2, 6), 7))
        assert torch.equal(lm.forward(cfg, p, tok)[0],
                           lm.forward(cfg, cast, tok)[0])
        pre, c1 = lm.prefill(cfg, p, tok, max_len=8)
        pre_c, c2 = lm.prefill(cfg, cast, tok, max_len=8)
        assert torch.equal(pre, pre_c)
        for name, t in c1["pos0"].items():
            assert torch.equal(t, c2["pos0"][name]), (arch, name)
        step, _ = lm.decode_step(cfg, p, c1, tok[:, :1], 6)
        step_c, _ = lm.decode_step(cfg, cast, c2, tok[:, :1], 6)
        assert torch.equal(step, step_c)
    assert c1["pos0"]["conv"].dtype == torch.bfloat16
    assert c1["pos0"]["state"].dtype == torch.float32


def test_params_from_jax_keeps_the_in_out_layout():
    cfg, _, np_tree, _, p = _params("qwen3-4b")
    wq = np_tree["blocks"]["pos0"]["attn"]["wq"]
    assert wq.shape == (cfg.n_blocks, cfg.d_model, cfg.q_dim)
    for b in range(cfg.n_blocks):
        np.testing.assert_array_equal(p["layers"][b]["attn"]["wq"].numpy(),
                                      wq[b])
    with pytest.raises(ValueError):
        params_from_jax(dataclasses.replace(cfg, n_layers=cfg.n_layers + 1),
                        np_tree, "cpu")


def _plain(value):
    """A config field in a form both packages compare equal in: the
    pattern's ``LayerPattern``s (two classes) as (name, fields)."""
    if isinstance(value, tuple):
        return tuple(_plain(v) for v in value)
    if dataclasses.is_dataclass(value):
        return (type(value).__name__, dataclasses.astuple(value))
    return value


def test_arch_configs_equal_the_reference_field_by_field():
    assert ARCH_IDS == REF_ARCH_IDS
    for reduced in (False, True):
        configs = all_configs(reduced)
        for arch in ARCH_IDS:
            port, want = configs[arch], ref_get_config(arch, reduced)
            fields = [f.name for f in dataclasses.fields(want)]
            assert [f.name for f in dataclasses.fields(port)] == fields
            for name in fields:
                assert _plain(getattr(port, name)) == \
                    _plain(getattr(want, name)), (arch, name)
            for prop in ("n_blocks", "q_dim", "kv_dim", "ssm_inner",
                         "is_encdec", "param_count", "active_param_count"):
                got, ref = getattr(port, prop), getattr(want, prop)
                if callable(got):
                    got, ref = got(), ref()
                assert got == ref, (arch, prop)
    with pytest.raises(KeyError):
        get_config("gpt-2")


def test_qwen3_4b_is_served_at_its_published_width():
    cfg = get_config("qwen3-4b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (36, 2560, 32, 8, 128, 9728, 151936)
    assert cfg.qk_norm and cfg.param_dtype == "float32" \
        and cfg.compute_dtype == "bfloat16"
    assert abs(cfg.param_count() - 4.41e9) < 0.01e9
    lm.check_supported(cfg)


@pytest.mark.parametrize("arch", UNSUPPORTED)
def test_unported_archs_raise(arch):
    """A MoE arch inits, forwards and serves on the CPU; with
    ``kv_cache_repeat=2`` (its 4 query heads over 2 KV heads, so that
    the 4 cached heads group them) its cache holds each KV head twice, in
    the reference's layout, and prefill and decode give the logits of
    the unrepeated cache, bit for bit."""
    cfg = get_config(arch, reduced=True)
    lm.check_supported(cfg)
    p = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.from_numpy(_tokens(cfg, (2, 5), 14))
    logits, _ = lm.forward(cfg, p, tok)
    assert logits.shape == (2, 5, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    from repro_torch.launch.serve import BatchServer, Request
    out = BatchServer(cfg, max_len=12, device="cpu", params=p).serve(
        [Request(0, tok[0].numpy(), 4)])["outputs"]
    assert len(out[0]) == 4
    cfg = dataclasses.replace(cfg, n_kv_heads=2)
    p = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    sharded = dataclasses.replace(cfg, kv_cache_repeat=2)
    want = jax.eval_shape(lambda: ref_lm.init_cache(
        dataclasses.replace(ref_get_config(arch, reduced=True), n_kv_heads=2,
                            kv_cache_repeat=2), 2, 12))
    got = lm.init_cache(sharded, 2, 12, device="cpu")
    assert {k: {n: tuple(t.shape) for n, t in v.items()}
            for k, v in got.items()} == \
        {k: {n: tuple(t.shape) for n, t in v.items()}
         for k, v in want.items()}
    (l1, c1), (l2, c2) = (lm.prefill(c, p, tok, max_len=12)
                          for c in (cfg, sharded))
    assert torch.equal(l1, l2)
    for pos in range(5, 7):
        step = l1.argmax(-1)[:, None]
        l1, _ = lm.decode_step(cfg, p, c1, step, pos)
        l2, _ = lm.decode_step(sharded, p, c2, step, pos)
        assert torch.equal(l1, l2)
    for key, leaves in c1.items():
        if "k" in leaves:
            for n in ("k", "v"):
                assert torch.equal(c2[key][n],
                                   leaves[n].repeat_interleave(2, dim=2))


def test_encoder_decoder_archs_are_sent_to_encdec():
    """whisper runs through ``models.encdec``; ``lm`` names it, and
    ``encdec`` refuses a decoder-only arch the same way."""
    from repro_torch.models import encdec
    cfg = get_config("whisper-medium", reduced=True)
    with pytest.raises(ValueError, match="models.encdec"):
        lm.init(cfg, torch.Generator(), "cpu")
    with pytest.raises(ValueError, match="models.encdec"):
        lm.forward(cfg, {}, torch.zeros(1, 2, dtype=torch.long))
    with pytest.raises(ValueError, match="models.lm"):
        encdec.init(get_config("qwen2-vl-2b", reduced=True),
                    torch.Generator(), "cpu")


def test_every_norm_and_attention_goes_through_the_kernel_wrappers(monkeypatch):
    """The call structure chip_smoke.py's launch counts derive from: per
    prefill or decode step, 4 rmsnorm calls a layer (norm1, q-norm,
    k-norm, norm2) plus the final norm, and one attention a layer; with
    ``plain=True`` the wrappers are never called."""
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
    cfg = get_config("qwen3-4b", reduced=True)
    p = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.from_numpy(_tokens(cfg, (2, 9), 8))
    for plain in (True, False):
        _, cache = lm.prefill(cfg, p, tok[:, :6], max_len=9, plain=plain)
        for t in range(6, 9):
            lm.decode_step(cfg, p, cache, tok[:, t:t + 1], t, plain=plain)
        steps = 0 if plain else 4
        assert calls == {"rmsnorm": steps * (4 * cfg.n_layers + 1),
                         "attention": steps * cfg.n_layers}


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_nemotron_norms_hand_layernorm_rows_their_own_dtype(monkeypatch,
                                                            compute):
    """nemotron-4-15b's 2 norms a layer and its final norm reach the
    layernorm row kernel's wrapper in x's own dtype (bf16 when served: no
    cast to fp32 before it, none back after), as many times a step as
    chip_smoke.py counts; on the CPU ``apply_norm`` equals
    ``ref.layernorm_rows`` of the rows bit for bit, and ``plain=True``
    never calls the wrapper."""
    from repro_torch.kernels import ops, ref
    from repro_torch.models import layers
    cfg = dataclasses.replace(get_config("nemotron-4-15b", reduced=True),
                              compute_dtype=compute)
    dtypes = []

    def recorded(x, *args, **kwargs):
        dtypes.append(x.dtype)
        return ref.layernorm_rows(x, *args, **kwargs)

    monkeypatch.setattr(ops, "layernorm_rows", recorded)
    p = lm.init_cast(cfg, torch.Generator().manual_seed(2), "cpu")
    tok = torch.from_numpy(_tokens(cfg, (2, 9), 10))
    for plain in (True, False):
        dtypes.clear()
        _, cache = lm.prefill(cfg, p, tok[:, :6], max_len=9, plain=plain)
        for t in range(6, 9):
            lm.decode_step(cfg, p, cache, tok[:, t:t + 1], t, plain=plain)
        steps = 0 if plain else 4
        assert dtypes == [getattr(torch, compute)] * (
            steps * (2 * cfg.n_layers + 1))
    monkeypatch.undo()
    x = torch.from_numpy(_np_rows((2, 5, cfg.d_model), 11)).to(
        getattr(torch, compute))
    norm = {"scale": torch.from_numpy(_np_rows((cfg.d_model,), 12)),
            "bias": torch.from_numpy(_np_rows((cfg.d_model,), 13))}
    got = layers.apply_norm(cfg, norm, x)
    want = ref.layernorm_rows(x.reshape(-1, cfg.d_model), norm["scale"],
                              norm["bias"]).reshape(x.shape)
    assert got.dtype == x.dtype and torch.equal(got, want)


def _np_rows(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# every arch the port serves, by its reduced config
SERVED = ["qwen3-4b", "qwen1.5-4b", "internlm2-20b", "nemotron-4-15b",
          "mamba2-2.7b", "dbrx-132b", "llama4-maverick-400b-a17b",
          "jamba-1.5-large-398b"]


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
@pytest.mark.parametrize("arch", SERVED)
def test_init_cast_is_cast_params_of_init_bit_for_bit(arch, compute):
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype=compute)
    want = lm.cast_params(cfg, lm.init(cfg, torch.Generator().manual_seed(5),
                                       "cpu"))
    got = lm.init_cast(cfg, torch.Generator().manual_seed(5), "cpu")
    want_leaves, got_leaves = dict(_leaves(want)), dict(_leaves(got))
    assert list(got_leaves) == list(want_leaves)
    for path, t in want_leaves.items():
        assert got_leaves[path].dtype == t.dtype, path
        assert torch.equal(got_leaves[path], t), path
    assert got["layers"][0]["norm1"]["scale"].dtype == torch.float32
    if compute == "bfloat16":
        assert got["embed"].dtype == torch.bfloat16


def test_init_cast_holds_one_fp32_layer_at_a_time(monkeypatch):
    """Each layer's fp32 weights are gone (no reference left) before the
    next layer is drawn, and the embedding's and head's before the first
    layer: watched through weak references to what ``_init_layer`` and the
    cast return.  In a MoE layer, at most one fp32 expert matrix is live
    (``_moe_draws_hold_one_fp32_expert``)."""
    import weakref
    cfg = dataclasses.replace(get_config("internlm2-20b", reduced=True),
                              compute_dtype="bfloat16", n_layers=4)
    drawn, live_at_draw = [], []
    init_layer = lm._init_layer

    def watched(*args, **kwargs):
        live_at_draw.append(sum(ref() is not None for ref in drawn))
        lp = init_layer(*args, **kwargs)
        drawn.extend(weakref.ref(t) for name, sub in lp.items()
                     if not name.startswith("norm")
                     for k, t in sub.items() if k not in lm._KEEP_FP)
        return lp

    monkeypatch.setattr(lm, "_init_layer", watched)
    params = lm.init_cast(cfg, torch.Generator().manual_seed(0), "cpu")
    assert live_at_draw == [0, 0, 0, 0]
    assert len(drawn) == 4 * 7 and all(ref() is None for ref in drawn)
    # the fp32 embedding and head were dropped too: only bf16 tensors and
    # fp32 norm gains are left
    assert {t.dtype for _, t in _leaves(params)} == {torch.bfloat16,
                                                     torch.float32}
    assert all(t.dtype == torch.bfloat16 for path, t in _leaves(params)
               if "norm" not in path)
    # init keeps every fp32 layer, as it must
    drawn.clear()
    kept = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert sum(ref() is not None for ref in drawn) == 4 * 7
    del kept
    monkeypatch.undo()
    _moe_draws_hold_one_fp32_expert(monkeypatch)


def _moe_draws_hold_one_fp32_expert(monkeypatch):
    """llama4's pattern (a dense and a MoE layer), 4 experts, bf16: every
    fp32 draw of ``layers._init`` is watched; when an expert matrix is
    drawn, no earlier fp32 draw is live but those the parameters keep
    (the fp32 router), so the mixer was cast before the experts and each
    expert matrix dropped once copied into its bf16 leaf."""
    import weakref
    from repro_torch.models import layers
    cfg = dataclasses.replace(get_config("llama4-maverick-400b-a17b",
                                         reduced=True),
                              compute_dtype="bfloat16")
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    draws, live_at, in_moe = [], [], []
    init, init_moe = layers._init, layers.init_moe

    def watched(gen, shape, *args, **kwargs):
        if in_moe:
            live_at.append((tuple(shape),
                            [r for r in draws if r() is not None]))
        t = init(gen, shape, *args, **kwargs)
        draws.append(weakref.ref(t))
        return t

    def moe(*args, **kwargs):
        in_moe.append(True)
        try:
            return init_moe(*args, **kwargs)
        finally:
            in_moe.clear()

    monkeypatch.setattr(layers, "_init", watched)
    monkeypatch.setattr(layers, "init_moe", moe)
    params = lm.init_cast(cfg, torch.Generator().manual_seed(0), "cpu")
    kept = {id(t) for _, t in _leaves(params)}
    expert = [(shape, [r for r in live if id(r()) not in kept])
              for shape, live in live_at if shape in ((d, f), (f, d))]
    n_moe = sum(p.ffn == "moe" for p in cfg.pattern) * cfg.n_blocks
    assert len(expert) == 3 * E * n_moe
    assert all(not live for _, live in expert)
    for lp in params["layers"]:
        if "moe" in lp:
            assert lp["moe"]["router"].dtype == torch.float32
            assert lp["attn"]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "nemotron-4-15b",
                                  "mamba2-2.7b"])
def test_batch_server_drawn_from_a_seed_serves_the_tokens_of_init(arch):
    """``BatchServer(cfg, seed=s)`` (drawn by ``init_cast``) and a server
    given ``lm.init``'s parameters from the same seed serve the same
    greedy tokens, in bf16 compute."""
    from repro_torch.launch.serve import BatchServer, Request
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              compute_dtype="bfloat16")
    prompts = [_tokens(cfg, (n,), 9 + n).astype(np.int32) for n in (7, 3)]
    outs = []
    for params in (None, lm.init(cfg, torch.Generator().manual_seed(3),
                                 "cpu")):
        server = BatchServer(cfg, max_len=16, seed=3, device="cpu",
                             params=params)
        outs.append(server.serve([Request(i, p, 6)
                                  for i, p in enumerate(prompts)])["outputs"])
    assert outs[0] == outs[1]
    assert all(len(t) == 6 for t in outs[0].values())
