"""The MoE archs at the reference's 32k lengths, against the JAX package,
on the CPU.

``prefill_32k`` and ``decode_32k`` (``src/repro/configs/shapes.py``) take
dbrx-132b, llama4-maverick and jamba-1.5-large where their short tests
never go: a prompt past ``attn_chunk_threshold``, whose plain attention
runs over 1,024-row query chunks and whose MoE layers route several
groups of 1,024 tokens a row, and decode steps that write and read rows
past 32,768 of a 32,800-row cache.  To keep the prompts short the
threshold is lowered to 2,048 on both sides: two rows of 2,048 tokens, two
route groups a row.  Reduced configs at fp32; parameters come from the
reference's ``init`` and cross as numpy; data comes from seeded numpy.
Every pass's logits are held within 1e-5 of their largest, on the port's
plain versions (the one-hot dispatch, the chunked attention) and on its
main path (slots filled by index; on the CPU each kernel's wrapper runs
its plain version).  Then the routing of a 32k prefill itself at each
arch's real experts, top-k and capacity factor: 64 groups of 1,024
tokens, each expert's capacity, the drops and the queue positions against
the reference's ``moe_fwd`` dispatch, group by group.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.layers as ref_layers
from repro.configs import get_config as ref_get_config
from repro.models import lm as ref_lm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ref
from repro_torch.models import layers, lm

# the chunked plain path's threshold on both sides, prefill_32k's cache and
# the first decode positions past its prompt
THRESHOLD, LONG_MAX_LEN, DECODE_POSITIONS = 2048, 32800, (32768, 32769, 32799)
MOE_ARCHS = ("dbrx-132b", "llama4-maverick-400b-a17b", "jamba-1.5-large-398b")
# a 32k prefill's routing: (arch, experts, top-k, each expert's slots of a
# 1,024-token group); jamba with the serving phase's 12 of its 16 experts
# (MOE_CUTS of chip_smoke.py) and with the 8 that its 32k cut on the card
# keeps (LONG_MOE_CUTS: 12 do not fit there beside a 32k prefill)
ROUTING = {"dbrx-132b": ("dbrx-132b", 16, 4, 320),
           "llama4-maverick-400b-a17b": ("llama4-maverick-400b-a17b", 128, 1,
                                         10),
           "jamba-1.5-large-398b": ("jamba-1.5-large-398b", 12, 2, 214),
           "jamba-1.5-large-398b-8": ("jamba-1.5-large-398b", 8, 2, 320)}
GROUPS, GROUP, D_ROUTE = 64, 1024, 8


def _configs(arch):
    """(port, reference) reduced configs with the lowered threshold."""
    return tuple(dataclasses.replace(get(arch, reduced=True),
                                     attn_chunk_threshold=THRESHOLD)
                 for get in (get_config, ref_get_config))


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's params (numpy), the tokens, and its logits: the
    prefill of 2 x 2,048 tokens, then a decode step at each of
    DECODE_POSITIONS fed the tokens after the prompt (each jit-compiled
    once, the position traced)."""
    _, rcfg = _configs(arch)
    tree, _ = ref_lm.init(rcfg, jax.random.PRNGKey(0))
    np_tree = jax.tree.map(np.asarray, tree)
    jp = jax.tree.map(jnp.asarray, np_tree)
    S = THRESHOLD
    tok = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (2, S + len(DECODE_POSITIONS)))
    prefill = jax.jit(lambda p, t: ref_lm.prefill(rcfg, p, t,
                                                  max_len=LONG_MAX_LEN))
    decode = jax.jit(lambda p, c, t, pos: ref_lm.decode_step(rcfg, p, c, t,
                                                             pos))
    want, rcache = prefill(jp, jnp.asarray(tok[:, :S], jnp.int32))
    passes = [np.asarray(want)]
    for i, pos in enumerate(DECODE_POSITIONS):
        want, rcache = decode(jp, rcache, jnp.asarray(
            tok[:, S + i:S + i + 1], jnp.int32), jnp.int32(pos))
        passes.append(np.asarray(want))
    return np_tree, tok, passes


@pytest.mark.parametrize("plain", [True, False], ids=["plain", "index"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_past_the_threshold_and_decode_past_32k_match_the_reference(
        arch, plain, monkeypatch):
    """Two prompts at the threshold: every attention layer's plain path
    chunked (causal), every MoE layer routing 4 groups of 1,024, then
    decode steps at 32,768, 32,769 and 32,799 of a 32,800-row cache, one
    token a group; dbrx's layernorm and top-2, llama4's dense and MoE
    layers in turn, jamba's SSM layers beside its attention layer."""
    cfg, _ = _configs(arch)
    np_tree, tok, want = _reference(arch)
    p = params_from_jax(cfg, np_tree, "cpu")
    S = THRESHOLD
    chunked, groups = [], []
    plain_chunked, route = ref.mha_attention_chunked, layers.moe_route
    monkeypatch.setattr(ref, "mha_attention_chunked",
                        lambda *a, **k: chunked.append(k.get("causal", True))
                        or plain_chunked(*a, **k))

    def routed(*a, **k):
        r = route(*a, **k)
        groups.append((r.xg.shape[:2], r.cap))
        return r
    monkeypatch.setattr(layers, "moe_route", routed)
    got, cache = lm.prefill(cfg, p, torch.from_numpy(tok[:, :S]),
                            max_len=LONG_MAX_LEN, plain=plain)
    attn = sum(cfg.pattern[i % cfg.pattern_len].mixer == "attn"
               for i in range(cfg.n_layers))
    moe = sum(cfg.pattern[i % cfg.pattern_len].ffn == "moe"
              for i in range(cfg.n_layers))
    assert chunked == ([True] * attn if plain else [])
    cap = max(1, math.ceil(GROUP * cfg.top_k / cfg.n_experts
                           * cfg.capacity_factor))
    assert groups == [((4, GROUP), cap)] * moe
    passes = [got]
    for i, pos in enumerate(DECODE_POSITIONS):
        step = tok[:, S + i:S + i + 1]
        got, cache = lm.decode_step(cfg, p, cache, torch.from_numpy(step),
                                    pos, plain=plain)
        passes.append(got)
    assert groups[moe:] == [((2, 1), math.ceil(cfg.top_k / cfg.n_experts
                                               * cfg.capacity_factor))] \
        * moe * len(DECODE_POSITIONS)
    for got, w in zip(passes, want):
        assert got.dtype == torch.float32 and got.shape == w.shape
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))
    first = next(i for i in range(cfg.n_layers)
                 if cfg.pattern[i % cfg.pattern_len].mixer == "attn")
    k = cache[f"pos{first % cfg.pattern_len}"]["k"][first // cfg.pattern_len]
    assert k.shape[2] == LONG_MAX_LEN
    assert bool(k[:, :, list(DECODE_POSITIONS)].abs().amax(-1).gt(0).all())
    assert not k[:, :, S:DECODE_POSITIONS[0]].any()


def _route_configs(case):
    """(port, reference) configs at the arch's real experts (or its cut's),
    top-k and capacity factor, reduced in width."""
    arch, E, K, _ = ROUTING[case]
    full = get_config(arch)
    kw = dict(n_experts=E, top_k=K, capacity_factor=full.capacity_factor,
              d_model=D_ROUTE, d_ff=16)
    return tuple(dataclasses.replace(get(arch, reduced=True), **kw)
                 for get in (get_config, ref_get_config))


@functools.lru_cache(maxsize=None)
def _reference_dispatch(case, groups_a_call):
    """The reference's moe_fwd over the 64 groups, ``groups_a_call`` at a
    time (jit-compiled once): its y and its dispatched slots xe (E, g, C,
    D), read where ``moe_fwd`` hands them to ``constrain``."""
    cfg, rcfg = _route_configs(case)
    rp, x = _route_inputs(case)

    def fwd(p, xs):
        seen = []
        real = ref_layers.constrain
        ref_layers.constrain = lambda a, *axes: seen.append(a) or a \
            if a.ndim == 4 else a
        try:
            y, _ = ref_layers.moe_fwd(rcfg, p, xs)
        finally:
            ref_layers.constrain = real
        return y, seen[0]
    run = jax.jit(fwd)
    xg = x.reshape(GROUPS, GROUP, D_ROUTE)
    ys, xes = [], []
    for g0 in range(0, GROUPS, groups_a_call):
        y, xe = run(rp, jnp.asarray(xg[g0:g0 + groups_a_call]))
        ys.append(np.asarray(y))
        xes.append(np.asarray(xe))
    return np.concatenate(ys), np.concatenate(xes, axis=1)


@functools.lru_cache(maxsize=None)
def _route_inputs(case):
    """Seeded leaves of the reference's ``init_moe`` shapes, with an N(0,
    1) router (so that routes are decided, and some experts draw more
    than their capacity), and 2 x 32,768 seeded tokens."""
    _, rcfg = _route_configs(case)
    E, d, f = rcfg.n_experts, rcfg.d_model, rcfg.d_ff
    rng = np.random.default_rng(5)
    shapes = {"router": (d, E), "w_gate": (E, d, f), "w_up": (E, d, f),
              "w_down": (E, f, d)}
    rp = {k: jnp.asarray((rng.normal(size=s) / (1 if k == "router"
                                                 else math.sqrt(s[1])))
                         .astype(np.float32)) for k, s in shapes.items()}
    x = (rng.normal(size=(2, 32768, D_ROUTE)) + 0.5).astype(np.float32)
    return rp, x


@pytest.mark.parametrize("case", list(ROUTING))
def test_routing_of_a_32k_prefill_is_the_references_group_by_group(case):
    """2 x 32,768 tokens route in 64 groups of 1,024 (a group never spans
    rows), each expert taking cap = ceil(1,024 K / E x 1.25) slots of a
    group (320 of 16 at top-4, 10 of 128 at top-1, 214 of 12 and 320 of 8
    at top-2): the port's slots filled by index hold the reference's
    tokens slot for slot (queue positions slot-major, then token order),
    the same choices drop, and y agrees."""
    cfg, _ = _route_configs(case)
    _, E, K, cap = ROUTING[case]
    rp, x = _route_inputs(case)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    xt = torch.from_numpy(x)
    r = layers.moe_route(cfg, tp, xt)
    assert r.cap == cap and tuple(r.xg.shape) == (GROUPS, GROUP, D_ROUTE)
    assert torch.equal(r.xg[GROUPS // 2], xt[1, :GROUP])
    y, _, xe = layers._moe_index(cfg, tp, r)
    kept = r.pos < cap
    assert 0 < int((~kept).sum()) < kept.numel()
    # GShard's order: every token's k-th choice queues before any token's
    # (k+1)-th, in token order, so a kept choice's position counts the
    # choices of its expert before it
    order = r.idx.transpose(1, 2).reshape(GROUPS, K * GROUP)
    first = torch.nn.functional.one_hot(order, E).cumsum(1)
    want_pos = first.gather(2, order[..., None])[..., 0] - 1
    assert torch.equal(r.pos, want_pos.view(GROUPS, K, GROUP).transpose(1, 2))
    # a power of two of groups a call, as many as keep its (g, K x 1,024,
    # E, C) one-hot dispatch under 2^26 elements
    per_call = 2 ** int(math.log2(max(1, 2**26 // (K * GROUP * E * cap))))
    want_y, want_xe = _reference_dispatch(case, per_call)
    np.testing.assert_array_equal(xe.view(E, GROUPS, cap, D_ROUTE).numpy(),
                                  want_xe)
    filled = (np.abs(want_xe).sum(-1) > 0).sum(axis=(0, 2))
    np.testing.assert_array_equal(kept.sum((1, 2)).numpy(), filled)
    np.testing.assert_allclose(y.view(GROUPS, GROUP, D_ROUTE).numpy(), want_y,
                               rtol=1e-6, atol=1e-5 * float(np.abs(want_y).max()))


@pytest.mark.parametrize("init", [False, True], ids=["zero", "initial"])
def test_plain_ssd_past_its_segment_is_one_chunked_call(init, monkeypatch):
    """Past ``SSD_PLAIN_SEGMENT`` positions (lowered here to 128) the port's
    plain SSD runs a segment at a time: y and the final state within 1e-5
    of their largest against one ``ssd_chunked`` call and the reference's
    ``ssd_chunked``, from zero and from an initial state; y keeps x's
    dtype and a gradient flows through the chain."""
    from repro.kernels import ref as jref
    monkeypatch.setattr(ref, "SSD_PLAIN_SEGMENT", 128)
    B, S, H, P, G, N = 2, 512, 8, 16, 2, 8
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, S, H, P)).astype(np.float32)
    a = -np.exp(rng.normal(size=(B, S, H)) * 0.3 - 2).astype(np.float32)
    b, c = (rng.normal(size=(B, S, G, N)).astype(np.float32) * 0.3
            for _ in range(2))
    s0 = rng.normal(size=(B, H, P, N)).astype(np.float32) if init else None
    t = [torch.from_numpy(v) for v in (x, a, b, c)]
    ts0 = None if s0 is None else torch.from_numpy(s0)
    t[0].requires_grad_(True)
    y, state = ref.ssd_plain(*t, chunk=32, initial_state=ts0)
    y.square().sum().backward()
    assert y.dtype == torch.float32 and y.shape == x.shape
    assert t[0].grad is not None and bool(torch.isfinite(t[0].grad).all())
    whole = ref.ssd_chunked(*(v.detach() for v in t), chunk=32,
                            initial_state=ts0)
    jwant = jref.ssd_chunked(*(jnp.asarray(v) for v in (x, a, b, c)),
                             chunk=32, initial_state=None if s0 is None
                             else jnp.asarray(s0))
    for want_y, want_s in (whole, jwant):
        for got, want in ((y.detach(), want_y), (state.detach(), want_s)):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-5 * float(np.abs(want).max()))
