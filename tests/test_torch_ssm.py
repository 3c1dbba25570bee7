"""The port's SSM and hybrid decoders against the JAX package's.

Parameters come from ``repro.models.lm.init`` with ``A_log``, ``D``,
``dt_bias``, ``conv_b`` and every norm gain perturbed (so that ones and
zeros hide nothing) and cross as numpy through ``params_from_jax``.
Tokens come from seeded numpy.  Configs are the reduced ones (fp32
compute): mamba2-2.7b, mamba2-2.7b with two state groups, and
jamba-1.5-large with its MoE FFNs replaced by dense ones on both sides
(a hybrid of attention and SSM layers; its MoE FFNs are held to the
reference in tests/test_torch_moe.py).  The JAX
side runs its oracles, the port its plain versions on ``device="cpu"``.
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
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.launch.serve import BatchServer, Request
from repro_torch.models import lm, ssm

ARCHS = ["mamba2-2.7b", "mamba2-2.7b-g2", "jamba-1.5-large-398b-dense"]
PERTURBED = ("A_log", "D", "dt_bias", "conv_b")


def _no_moe(cfg):
    pattern = tuple(dataclasses.replace(p, ffn="dense") if p.ffn == "moe"
                    else p for p in cfg.pattern)
    return dataclasses.replace(cfg, pattern=pattern, n_experts=0, top_k=0)


def _configs(arch):
    """(port cfg, reference cfg), reduced; "-g2" sets two state groups,
    "-dense" replaces MoE FFNs by dense ones."""
    base = arch.removesuffix("-g2").removesuffix("-dense")
    cfg, rcfg = get_config(base, reduced=True), ref_get_config(base, reduced=True)
    if arch.endswith("-g2"):
        cfg = dataclasses.replace(cfg, ssm_groups=2)
        rcfg = dataclasses.replace(rcfg, ssm_groups=2)
    if arch.endswith("-dense"):
        cfg, rcfg = _no_moe(cfg), _no_moe(rcfg)
    return cfg, rcfg


def _perturb(tree, rng, path=""):
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, f"{path}/{k}") for k, v in tree.items()}
    arr = np.asarray(tree)
    if "norm" in path or path.rsplit("/", 1)[-1] in PERTURBED:
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


def _cache_close(cache, rcache):
    """Every cache entry within 1e-4 of its largest magnitude, the logits'
    tolerance: the hybrid's deeper entries carry eight layers of fp32
    rounding."""
    assert set(cache) == set(rcache)
    for pos, entry in cache.items():
        assert set(entry) == set(rcache[pos])
        for name, t in entry.items():
            want = np.asarray(rcache[pos][name])
            assert t.dtype == torch.float32 and t.shape == want.shape
            _close(t.numpy(), want, float(np.abs(want).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_the_reference(arch):
    cfg, rcfg, _, jp, p = _params(arch)
    tok = _tokens(cfg, (2, 12), 5)
    want, _ = ref_lm.forward(rcfg, jp, jnp.asarray(tok, jnp.int32))
    got, _ = lm.forward(cfg, p, torch.from_numpy(tok))
    assert got.dtype == torch.float32
    _close(got.numpy(), want, float(jnp.abs(want).max()))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_decode_match_the_reference(arch):
    """Prefill's logits and every cache entry (k/v of the attention
    positions, conv window and SSD state of the SSM positions), then
    four decode steps."""
    cfg, rcfg, _, jp, p = _params(arch)
    tok = _tokens(cfg, (2, 12), 6)
    want, rcache = ref_lm.prefill(rcfg, jp, jnp.asarray(tok[:, :8], jnp.int32),
                                  max_len=12)
    got, cache = lm.prefill(cfg, p, torch.from_numpy(tok[:, :8]), max_len=12)
    scale = float(jnp.abs(want).max())
    _close(got.numpy(), want, scale)
    _cache_close(cache, rcache)
    for t in range(8, 12):
        want, rcache = ref_lm.decode_step(
            rcfg, jp, rcache, jnp.asarray(tok[:, t:t + 1], jnp.int32),
            jnp.int32(t))
        got, cache = lm.decode_step(cfg, p, cache,
                                    torch.from_numpy(tok[:, t:t + 1]), t)
        _close(got.numpy(), want, scale)
    _cache_close(cache, rcache)


def test_greedy_tokens_equal_the_reference_servers():
    cfg, rcfg = _configs("mamba2-2.7b")
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
    assert all(len(v) == 10 for v in got["outputs"].values())


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "mamba2-2.7b-g2"])
def test_decode_consistency(arch):
    """Port of tests/test_models.py::test_decode_consistency on the port's
    own parameters: prefill + decode steps give forward's logits, also
    from a 2-token prompt, shorter than the conv window of 3."""
    cfg, _ = _configs(arch)
    tok = torch.from_numpy(_tokens(cfg, (2, 12), 1))
    p = lm.init(cfg, torch.Generator().manual_seed(1), "cpu")
    full, _ = lm.forward(cfg, p, tok)
    for Sp in (8, 2):
        pre, cache = lm.prefill(cfg, p, tok[:, :Sp], max_len=12)
        errs = [float((pre - full[:, Sp - 1]).abs().max())]
        for t in range(Sp, 12):
            step, cache = lm.decode_step(cfg, p, cache, tok[:, t:t + 1], t)
            errs.append(float((step - full[:, t]).abs().max()))
        assert max(errs) < 2e-3, (Sp, errs)


def test_init_ssm_has_the_reference_values_shapes_and_scales():
    cfg = get_config("mamba2-2.7b", reduced=True)
    rcfg = ref_get_config("mamba2-2.7b", reduced=True)
    want, _ = ref_ssm.init_ssm(rcfg, jax.random.PRNGKey(0))
    got = ssm.init_ssm(cfg, torch.Generator().manual_seed(0),
                       torch.device("cpu"))
    assert set(got) == set(want)
    for name, t in got.items():
        assert tuple(t.shape) == want[name].shape and t.dtype == torch.float32
    # deterministic leaves: the reference's values (within an fp32 ulp:
    # torch's and XLA's log differ in the last bit)
    for name in ("A_log", "D", "dt_bias", "conv_b", "norm"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=3e-7, atol=0, err_msg=name)
    d, din = cfg.d_model, cfg.ssm_inner
    for name, std in (("in_proj", d ** -0.5), ("conv_w", 0.1),
                      ("out_proj", din ** -0.5)):
        assert abs(float(got[name].std()) / std - 1) < 0.1, name


def test_mamba2_is_served_at_its_published_width():
    cfg = get_config("mamba2-2.7b")
    assert (cfg.n_layers, cfg.d_model, cfg.ssm_heads, cfg.ssm_head_dim,
            cfg.ssm_state, cfg.ssm_groups, cfg.ssm_conv_width,
            cfg.vocab_size) == (64, 2560, 80, 64, 128, 1, 4, 50280)
    assert [(p.mixer, p.ffn) for p in cfg.pattern] == [("ssm", "none")]
    assert abs(cfg.param_count() - 2.83e9) < 0.01e9
    lm.check_supported(cfg)
    # the hybrid with its MoE FFNs runs, with its KV cache repeated too:
    # each attention position's k/v hold every KV head twice, the SSM
    # positions' conv window and state are unchanged (the reference's
    # layout)
    jamba = get_config("jamba-1.5-large-398b")
    lm.check_supported(jamba)
    rep = dataclasses.replace(jamba, kv_cache_repeat=2)
    lm.check_supported(rep)
    small = dataclasses.replace(get_config("jamba-1.5-large-398b",
                                           reduced=True), n_kv_heads=2,
                                kv_cache_repeat=2)
    cache = lm.init_cache(small, 2, 8, device="cpu")
    want = jax.eval_shape(lambda: ref_lm.init_cache(dataclasses.replace(
        ref_get_config("jamba-1.5-large-398b", reduced=True), n_kv_heads=2,
        kv_cache_repeat=2), 2, 8))
    assert {k: {n: tuple(t.shape) for n, t in v.items()}
            for k, v in cache.items()} == \
        {k: {n: tuple(t.shape) for n, t in v.items()}
         for k, v in want.items()}


def test_params_from_jax_carries_ssm_leaves_and_mixer_only_layers():
    cfg, _, np_tree, _, p = _params("mamba2-2.7b")
    assert len(p["layers"]) == cfg.n_layers
    for b, layer in enumerate(p["layers"]):
        assert set(layer) == {"norm1", "ssm"}         # ffn "none"
        for name, t in layer["ssm"].items():
            np.testing.assert_array_equal(
                t.numpy(), np_tree["blocks"]["pos0"]["ssm"][name][b])
    cfg, _, np_tree, _, p = _params("jamba-1.5-large-398b-dense")
    for i, layer in enumerate(p["layers"]):
        pat = cfg.pattern[i % cfg.pattern_len]
        mixer = "attn" if pat.mixer == "attn" else "ssm"
        assert set(layer) == {"norm1", mixer, "norm2", "mlp"}
        want = np_tree["blocks"][f"pos{i % cfg.pattern_len}"][mixer]
        for name, t in layer[mixer].items():
            np.testing.assert_array_equal(
                t.numpy(), want[name][i // cfg.pattern_len])


def test_init_cache_has_the_reference_layout():
    cfg, rcfg = _configs("jamba-1.5-large-398b-dense")
    got = lm.init_cache(cfg, 2, 16, device="cpu")
    want = ref_lm.init_cache(rcfg, 2, 16)
    assert set(got) == set(want)
    for pos, entry in got.items():
        assert set(entry) == set(want[pos])
        for name, t in entry.items():
            assert tuple(t.shape) == want[pos][name].shape, (pos, name)
            assert str(t.dtype).removeprefix("torch.") == \
                str(want[pos][name].dtype), (pos, name)
            assert not t.any()


def test_every_ssd_and_norm_goes_through_the_kernel_wrappers(monkeypatch):
    """The call structure chip_smoke.py's launch counts derive from for
    mamba2: one SSD kernel call a layer in prefill (decode updates the
    state in plain PyTorch), two rmsnorm calls a layer (norm1 and the
    gated norm) plus the final norm per prefill or decode step; with
    ``plain=True`` the wrappers are never called."""
    calls = {"rmsnorm": 0, "ssd": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(ops, "rmsnorm_rows", counted("rmsnorm", ops.rmsnorm_rows))
    monkeypatch.setattr(ops, "ssd_kernel", counted("ssd", ops.ssd_kernel))
    cfg = get_config("mamba2-2.7b", reduced=True)
    p = lm.init(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = torch.from_numpy(_tokens(cfg, (2, 9), 8))
    for plain in (True, False):
        _, cache = lm.prefill(cfg, p, tok[:, :6], max_len=9, plain=plain)
        for t in range(6, 9):
            lm.decode_step(cfg, p, cache, tok[:, t:t + 1], t, plain=plain)
        steps = 0 if plain else 4
        assert calls == {"rmsnorm": steps * (2 * cfg.n_layers + 1),
                         "ssd": 0 if plain else cfg.n_layers}


def _drift(monkeypatch, n_layers, compute_dtype):
    """Relative L2 between the logits of the SSD's chunked algorithm and
    of its recurrence, the same weights and tokens, at mamba2's pattern
    and width 128."""
    from repro_torch.kernels import ref
    cfg = dataclasses.replace(get_config("mamba2-2.7b"), n_layers=n_layers,
                              d_model=128, vocab_size=512,
                              compute_dtype=compute_dtype)
    p = lm.cast_params(cfg, lm.init(cfg, torch.Generator().manual_seed(0),
                                    "cpu"))
    tok = torch.from_numpy(_tokens(cfg, (2, 256), 0))
    chunked, _ = lm.forward(cfg, p, tok, plain=True)  # S = 256, chunk 128
    with monkeypatch.context() as m:
        m.setattr(ref, "ssd_plain", lambda x, a, b, c, *, chunk,
                  initial_state=None: ref.ssd_scan(x, a, b, c))
        scan, _ = lm.forward(cfg, p, tok, plain=True)
    return float((chunked - scan).norm() / scan.norm())


def test_bf16_drift_grows_with_depth_and_fp32_holds(monkeypatch):
    """Why chip_smoke.py's SSM_RTOL is loose, SSM_SHALLOW_RTOL (8 layers)
    tighter and SSM_FP32_RTOL sharp: two fp32 orders of the same SSD (the
    chunked algorithm, the kernel's, and the recurrence) give bf16 outputs
    one ulp apart here and there, and over 64 SSM layers of random bf16
    weights those differences grow to several percent of the logits,
    about ten times the drift of 8 layers; in fp32 compute the two stay
    within 1e-4."""
    deep, shallow = (_drift(monkeypatch, n, "bfloat16") for n in (64, 8))
    assert deep > 0.05 and deep > 4 * shallow, (deep, shallow)
    assert _drift(monkeypatch, 64, "float32") < 1e-4
