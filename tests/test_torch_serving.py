"""The port's ``BatchServer`` against the reference's.

The reference server draws its parameters from ``PRNGKey(0)``; they
cross to the port as numpy through ``params_from_jax``, and both serve
the same seeded prompts of different lengths (so the left padding, which
both attend to, is exercised).  Greedy token ids must be identical.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch.mesh import make_local_mesh
from repro.launch.serve import BatchServer as RefBatchServer
from repro.launch.serve import Request as RefRequest
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import BatchServer, Request


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


def test_greedy_tokens_equal_the_reference_servers():
    cfg, rcfg = get_config("qwen3-4b", reduced=True), \
        ref_get_config("qwen3-4b", reduced=True)
    ref = RefBatchServer(rcfg, make_local_mesh(), max_len=64)
    port = BatchServer(cfg, max_len=64, device="cpu",
                       params=params_from_jax(
                           cfg, jax.tree.map(np.asarray, ref.params), "cpu"))
    prompts = _prompts(cfg.vocab_size, (5, 17, 11))
    want = ref.serve([RefRequest(i, p, 10) for i, p in enumerate(prompts)])
    got = port.serve([Request(i, p, 10) for i, p in enumerate(prompts)])
    assert got["outputs"] == want["outputs"]
    assert all(len(v) == 10 for v in got["outputs"].values())
    assert set(got) == set(want)


def test_batch_server_greedy_deterministic():
    """Port of tests/test_system.py::test_batch_server_greedy_deterministic,
    on qwen2-vl-2b (M-RoPE) as there."""
    cfg = get_config("qwen2-vl-2b", reduced=True)
    server = BatchServer(cfg, max_len=64, device="cpu")
    prompts = _prompts(cfg.vocab_size, (8, 8))
    r1 = server.serve([Request(0, prompts[0], 8), Request(1, prompts[1], 8)])
    r2 = server.serve([Request(0, prompts[0], 8), Request(1, prompts[1], 8)])
    assert r1["outputs"] == r2["outputs"]
    assert all(len(v) == 8 for v in r1["outputs"].values())
    assert r1["decode_tok_per_s"] > 0 and r1["prefill_s"] > 0


def test_temperature_sampling_is_seeded_and_leaves_greedy_rows_alone():
    cfg = get_config("qwen3-4b", reduced=True)
    server = BatchServer(cfg, max_len=32, seed=1, device="cpu")
    prompts = _prompts(cfg.vocab_size, (6, 9), seed=2)

    def run(t1):
        return server.serve([Request(0, prompts[0], 6),
                             Request(1, prompts[1], 6, temperature=t1)])

    mixed, again, greedy = run(0.7), run(0.7), run(0.0)
    assert mixed["outputs"] == again["outputs"]
    assert mixed["outputs"][0] == greedy["outputs"][0]
    assert all(0 <= t < cfg.vocab_size for t in mixed["outputs"][1])


def test_serve_refuses_what_the_cache_cannot_hold_and_unported_archs():
    cfg = get_config("qwen3-4b", reduced=True)
    server = BatchServer(cfg, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        server.serve([Request(0, np.zeros(12, np.int32), 6)])
    # a MoE arch serves, and with its KV cache repeated (each head held
    # twice, as a sharded cache holds it) serves the same tokens
    moe = get_config("llama4-maverick-400b-a17b", reduced=True)
    prompt = _prompts(moe.vocab_size, (5,))[0]
    server = BatchServer(moe, max_len=16, device="cpu")
    out = server.serve([Request(0, prompt, 4)])["outputs"]
    assert len(out[0]) == 4
    gqa = dataclasses.replace(moe, n_kv_heads=2)   # 4 query heads
    repeated = BatchServer(dataclasses.replace(gqa, kv_cache_repeat=2),
                           max_len=16, device="cpu")
    plain = BatchServer(gqa, max_len=16, device="cpu")
    assert torch.equal(repeated.params["layers"][0]["attn"]["wk"],
                       plain.params["layers"][0]["attn"]["wk"])
    assert repeated.serve([Request(0, prompt, 4)])["outputs"] == \
        plain.serve([Request(0, prompt, 4)])["outputs"]
