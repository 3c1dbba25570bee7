"""The launch plans of the port's redesigned kernels, on the CPU.

``gemm_plan`` cuts K into split-K slabs for ``flex_gemm``,
``decode_plan`` cuts the KV rows into splits for ``flash_attention``'s
decode path, ``norm_plan`` gives a row's 16-byte vectors to the
threads of the one-pass norm kernel (rmsnorm and layernorm),
``warp_plan`` a row of at most 1,024 to the lanes of the layernorm and
softmax warp kernels, and ``ssd_plan`` lays out the SSD scan's chunks and
the blocks that carry its state.  All are pure functions of the shape
(and the card's SM count, or the operands' alignment), so they are
checked here: each covers K, the KV rows, a row's vectors or elements or
the positions and state exactly once, and fills the card where the
length allows.  The kernels that follow the plans are
held against the plain versions on the card in test_torch_cuda.py.
"""

import importlib
from collections import Counter
from pathlib import Path

import pytest

from repro_torch.configs import get_config, paper_models
from repro_torch.core import CompileOptions, DoraCompiler, OpType

# the modules, not the wrappers of the same name that the package exports
fa = importlib.import_module("repro_torch.kernels.flash_attention")
fg = importlib.import_module("repro_torch.kernels.flex_gemm")
sfu = importlib.import_module("repro_torch.kernels.sfu")
ssd = importlib.import_module("repro_torch.kernels.ssd")

H100_SMS = 132
# BERT-L's MMU_GEMM tiles (M, K, N) and their launches in one run, as the
# port's compiler gives them (engine "list")
BERT_L_TILES = {(256, 256, 256): 48, (512, 256, 192): 48,
                (512, 512, 384): 48, (512, 512, 768): 4,
                (512, 768, 768): 12, (256, 256, 3072): 24}
# the reference's GEMM sweep, DeiT-L's ragged 197-row tiles, the -S
# models' narrow ones (N = 1)
OTHER_GEMMS = [(128, 128, 128), (100, 200, 300), (7, 33, 129),
               (256, 512, 384), (1, 17, 5), (130, 257, 131), (512, 64, 1024),
               (197, 197, 768), (197, 256, 197), (197, 1024, 384),
               (1024, 32, 1), (256, 512, 512), (64, 0, 64)]
# qwen3-4b's decode reads 513..543 cache rows; the card tests' lengths
DECODE_LENGTHS = [0, 1, 63, 64, 65, 513, 540, 543, 1024]


def _mmu_tiles(name):
    res = DoraCompiler().compile(paper_models.get(name),
                                 CompileOptions(engine="list"))
    return Counter((i.body.bound_i, i.body.bound_k, i.body.bound_j)
                   for i in res.codegen.program.instructions
                   if i.op_type == OpType.MMU_GEMM and i.body.ping_op == 1)


def test_bert_l_tiles_are_the_ones_the_plan_is_checked_at():
    assert dict(_mmu_tiles("BERT-L")) == BERT_L_TILES


def _slabs(K, plan):
    """[start, end) of each slab in K, as the kernel walks them."""
    k_tiles = -(-K // fg.BLOCK_K)
    return [(z * plan.tiles_per_split * fg.BLOCK_K,
             min(K, min(k_tiles, (z + 1) * plan.tiles_per_split) * fg.BLOCK_K))
            for z in range(plan.splits)]


@pytest.mark.parametrize("shape", list(BERT_L_TILES) + OTHER_GEMMS)
def test_gemm_plan_covers_k_once_in_whole_tiles(shape):
    M, K, N = shape
    plan = fg.gemm_plan(M, K, N, H100_SMS)
    assert plan.blocks == -(-M // 64) * -(-N // 64)
    slabs = _slabs(K, plan)
    # contiguous, non-empty, from 0 to K, each a whole number of tiles but
    # the last
    assert slabs[0][0] == 0 and slabs[-1][1] == K
    for (a0, a1), (b0, _) in zip(slabs, slabs[1:]):
        assert a1 == b0 and a1 > a0 and (a1 - a0) % fg.BLOCK_K == 0
    assert plan.splits == 1 or plan.tiles_per_split >= fg.MIN_SPLIT_TILES


@pytest.mark.parametrize("shape", list(BERT_L_TILES) + OTHER_GEMMS)
def test_gemm_plan_fills_the_card_where_k_allows(shape):
    """Where slabs of at least MIN_SPLIT_TILES tiles can give every SM a
    block, the plan does; else it cuts K into the most such slabs the
    cost model finds worth a reduce, and never splits an output that
    fills the card alone."""
    M, K, N = shape
    plan = fg.gemm_plan(M, K, N, H100_SMS)
    k_tiles = -(-K // fg.BLOCK_K)
    most = max(1, k_tiles // fg.MIN_SPLIT_TILES)    # slabs of 2 tiles
    if plan.blocks * most >= H100_SMS:
        assert plan.blocks * plan.splits >= H100_SMS
    if plan.blocks >= H100_SMS:
        assert plan.splits == 1


def test_gemm_plan_at_bert_l():
    """BERT-L's tiles: a block for every SM at all but 256x256x256, whose
    16 K tiles allow 8 slabs of 2 (128 blocks); where the output is
    short of the card, K is cut so that the blocks come in nearly whole
    waves of 132 (384 blocks: 3 an SM on most SMs)."""
    got = {s: fg.gemm_plan(*s, H100_SMS) for s in BERT_L_TILES}
    assert {s: (p.blocks, p.splits) for s, p in got.items()} == {
        (256, 256, 256): (16, 8), (512, 256, 192): (24, 8),
        (512, 512, 384): (48, 8), (512, 512, 768): (96, 4),
        (512, 768, 768): (96, 4), (256, 256, 3072): (192, 1)}
    assert sum(n for s, n in BERT_L_TILES.items()
               if got[s].blocks * got[s].splits < H100_SMS) == 48


def test_gemm_plan_prices_the_reduce():
    """One slab where the output fills the card; the reduce's cost keeps
    a cut that adds no wave from being taken."""
    assert fg.gemm_plan(3072, 1024, 4096, H100_SMS).splits == 1
    assert fg.gemm_plan(256, 256, 3072, H100_SMS).splits == 1
    assert fg.gemm_plan(7, 33, 129, H100_SMS).splits == 1


@pytest.mark.parametrize("skv", DECODE_LENGTHS)
@pytest.mark.parametrize("pairs", [1, 32, 64, 256])
def test_decode_plan_covers_the_rows_once_in_whole_chunks(skv, pairs):
    plan = fa.decode_plan(skv, pairs, H100_SMS)
    assert plan.rows_per_split % fa.DECODE_CHUNK == 0
    assert plan.rows_per_split >= fa.MIN_SPLIT_ROWS
    assert plan.splits >= 1
    # every split non-empty, together exactly [0, skv)
    assert (plan.splits - 1) * plan.rows_per_split < max(skv, 1)
    assert plan.splits * plan.rows_per_split >= skv
    assert plan.combine == (plan.splits > 1)


@pytest.mark.parametrize("skv", DECODE_LENGTHS)
def test_decode_plan_fills_the_card_at_qwen3_4b_where_the_length_allows(skv):
    cfg = get_config("qwen3-4b")
    pairs = 4 * cfg.n_kv_heads          # the served batch of 4
    plan = fa.decode_plan(skv, pairs, H100_SMS)
    most = max(1, -(-skv // fa.MIN_SPLIT_ROWS))  # splits of 64 rows
    assert pairs * plan.splits >= H100_SMS or plan.splits == most
    if 513 <= skv <= 543:               # the served decode steps
        assert pairs * plan.splits >= 2 * H100_SMS


def test_one_split_has_no_combine():
    plan = fa.decode_plan(64, 32, H100_SMS)
    assert plan == fa.DecodePlan(1, 64, False)
    assert fa.decode_plan(65, 32, H100_SMS).combine


def test_decode_rows_bound_the_decode_path():
    """qwen3-4b's decode (1 query x 4 heads a KV head) takes the decode
    path, its prefill the prefill kernels."""
    cfg = get_config("qwen3-4b")
    group = cfg.n_heads // cfg.n_kv_heads
    assert 1 * group <= fa.DECODE_ROWS < 37 * group


# rmsnorm widths: the serving rows (qwen3-4b / mamba2 2560, mamba2's gated
# norm 5120, internlm2-20b and nemotron-4-15b 6144), odd and ragged ones,
# and rows too wide for the registers
RMS_WIDTHS = [1032, 2048, 2560, 4100, 5120, 6144, 8192, 32768, 65536,
              131072, 262144]


@pytest.mark.parametrize("esize", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("N", RMS_WIDTHS)
def test_rmsnorm_plan_covers_each_vector_of_a_row_once(N, esize):
    """The one-pass kernel's thread ``t`` of a row holds vectors ``t + k *
    threads`` (k < ROW_VPT) below V: together every vector exactly once,
    in whole warps with none empty, within one block's 1,024 threads;
    rows it cannot cover take the scalar kernels."""
    threads = sfu.norm_plan(N, esize, aligned=True)
    V = N * esize // 16
    if threads == 0:
        assert N * esize % 16 or -(-V // sfu.ROW_VPT) > sfu.MAX_THREADS
        return
    assert threads % 32 == 0 and threads <= sfu.MAX_THREADS
    held = Counter(t + k * threads for t in range(threads)
                   for k in range(sfu.ROW_VPT) if t + k * threads < V)
    assert sorted(held) == list(range(V)) and set(held.values()) == {1}
    assert threads - 32 < -(-V // sfu.ROW_VPT)      # no empty warp


def test_rmsnorm_plan_at_the_serving_widths():
    """The one-pass kernel at every served width, in both dtypes: 5,120
    bf16 is 640 vectors, 320 threads of 2; the q/k-norm rows (128) and
    anything unaligned, ragged or wider than 2,048 vectors take the scalar
    kernels."""
    got = {(N, e): sfu.norm_plan(N, e, True)
           for N in (2560, 5120, 6144) for e in (2, 4)}
    assert got == {(2560, 2): 160, (2560, 4): 320, (5120, 2): 320,
                   (5120, 4): 640, (6144, 2): 384, (6144, 4): 768}
    assert sfu.norm_plan(128, 2, True) == 0
    assert sfu.norm_plan(1024, 4, True) == 0
    assert sfu.norm_plan(6144, 2, False) == 0
    assert sfu.norm_plan(6143, 2, True) == 0
    assert sfu.norm_plan(4100, 2, True) == 0
    assert sfu.norm_plan(1032, 2, True) == 96
    assert sfu.norm_plan(16384, 2, True) == 1024
    assert sfu.norm_plan(16392, 2, True) == 0


def _held_by_lanes(slots, units):
    """Units (16-byte vectors or elements) of a row of ``units`` that the
    warp kernels' lanes hold: lane l slots l + 32 s, s < slots."""
    return Counter(lane + 32 * s for lane in range(32) for s in range(slots)
                   if lane + 32 * s < units)


def _layernorm_path(N, esize, aligned):
    """The kernel ``layernorm_rows`` launches: ("one-pass", threads),
    ("warp", slots, vector) or ("block",)."""
    threads = sfu.norm_plan(N, esize, aligned)
    if threads:
        return ("one-pass", threads)
    slots, vector = sfu.warp_plan(N, esize, aligned)
    return ("warp", slots, vector) if slots else ("block",)


# layernorm widths: the DORA path's rows (768, 384, 256; DeiT's
# attention rows 197), nemotron-4-15b's 6144, the narrowest one-pass row
# (1032), and ragged ones
LN_WIDTHS = [768, 384, 256, 197, 1032, 6144, 17, 1000, 1024, 1025, 2561,
             6143, 16384, 16392]


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
@pytest.mark.parametrize("esize", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("N", LN_WIDTHS)
def test_layernorm_plan_covers_each_vector_or_element_once(N, esize, aligned):
    """Rows wider than 1,024 of whole aligned 16-byte vectors take the
    one-pass kernel (each vector held once, as rmsnorm's); rows of at most
    1,024 the warp kernel, holding each vector (aligned whole vectors) or
    else each element exactly once, at most 32 fp32 values a lane, in the
    fewest power-of-two slots that do; every other row the block kernel.
    An unaligned or ragged row never takes 16-byte loads."""
    path = _layernorm_path(N, esize, aligned)
    whole = aligned and N * esize % 16 == 0
    if N > sfu.WARP_ROW_MAX:
        V = N * esize // 16
        if whole and -(-V // sfu.ROW_VPT) <= sfu.MAX_THREADS:
            threads = path[1]
            assert path[0] == "one-pass" and threads % 32 == 0
            held = Counter(t + k * threads for t in range(threads)
                           for k in range(sfu.ROW_VPT) if t + k * threads < V)
            assert sorted(held) == list(range(V))
            assert set(held.values()) == {1}
        else:
            assert path == ("block",)
        return
    _, slots, vector = path
    assert path[0] == "warp" and vector == whole
    unit = 16 // esize if vector else 1
    units = N // unit
    held = _held_by_lanes(slots, units)
    assert sorted(held) == list(range(units)) and set(held.values()) == {1}
    assert slots & (slots - 1) == 0 and slots * unit <= sfu.LANE_MAX
    assert slots == 1 or 32 * (slots // 2) < units      # the fewest slots


def test_layernorm_plan_at_the_main_path_rows():
    """BERT-L's 768-wide and DeiT-S's 384-wide fp32 rows take 16-byte
    vectors, DeiT's 197-wide rows (788 bytes) scalar loads, nemotron-4-15b's
    6144-wide bf16 and fp32 rows the one-pass kernel, as rmsnorm's do."""
    assert _layernorm_path(768, 4, True) == ("warp", 8, True)
    assert _layernorm_path(384, 4, True) == ("warp", 4, True)
    assert _layernorm_path(256, 4, True) == ("warp", 2, True)
    assert _layernorm_path(768, 2, True) == ("warp", 4, True)
    assert _layernorm_path(197, 4, True) == ("warp", 8, False)
    assert _layernorm_path(768, 4, False) == ("warp", 32, False)
    assert _layernorm_path(6144, 2, True) == ("one-pass", 384)
    assert _layernorm_path(6144, 4, True) == ("one-pass", 768)
    assert _layernorm_path(6144, 2, False) == ("block",)
    assert _layernorm_path(6143, 2, True) == ("block",)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
@pytest.mark.parametrize("N,want", [
    (17, (1, False)), (128, (1, True)), (197, (8, False)), (300, (4, True)),
    (512, (4, True)), (1000, (8, True)), (1025, (0, False))])
def test_softmax_warp_plan_template_choice(N, want, aligned):
    """The softmax warp kernel's compile-time slots at widths from the
    reference's sweep and the DORA path: float4 slots where the fp32 row is
    a whole number of aligned 16-byte vectors, scalar ones otherwise (17,
    DeiT's 197, any offset view), each element held once, at most 32 a
    lane; rows past 1,024 take the block kernel."""
    slots, vector = sfu.warp_plan(N, 4, aligned)
    if aligned or N > sfu.WARP_ROW_MAX:
        assert (slots, vector) == want
    else:
        assert not vector and slots == 1 << (-(-N // 32) - 1).bit_length()
    if slots:
        unit = 4 if vector else 1
        held = _held_by_lanes(slots, N // unit)
        assert sorted(held) == list(range(N // unit))
        assert set(held.values()) == {1} and slots * unit <= sfu.LANE_MAX


# (B, S, H, P, N, chunk): mamba2-2.7b's prefill, a 2,048-token prompt (16
# chunks through the state pass), the SSM block's chunk min(128, max(16,
# S)) at the card tests' short lengths, the reference's sweep at chunk 32,
# a tail chunk, and an empty sequence
SSD_PLANS = [(4, 512, 80, 64, 128, 128), (1, 2048, 80, 64, 128, 128),
             (2, 37, 80, 64, 128, 37), (2, 77, 8, 32, 16, 77),
             (1, 100, 2, 8, 4, 100), (2, 48, 80, 64, 128, 48),
             (2, 256, 8, 32, 16, 32), (1, 100, 2, 8, 4, 64),
             (1, 16, 4, 8, 4, 128), (2, 0, 4, 8, 4, 128)]


@pytest.mark.parametrize("shape", SSD_PLANS)
def test_ssd_plan_covers_every_position_and_state_element_once(shape):
    B, S, H, P, N, chunk = shape
    plan = ssd.ssd_plan(B, S, H, P, N, chunk)
    assert 1 <= plan.chunk <= min(chunk, ssd.MAX_CHUNK) or S == 0
    starts = [c * plan.chunk for c in range(plan.chunks)]
    covered = [t for c0 in starts for t in range(c0, min(c0 + plan.chunk, S))]
    assert covered == list(range(S))
    assert all(c0 < S for c0 in starts)
    assert plan.grid == (plan.chunks, H, B)
    assert plan.scratch_bytes == 4 * B * plan.chunks * H * P * N
    blocks = plan.state_grid[0]
    assert plan.state_grid == (blocks, H, B)
    assert (blocks - 1) * ssd.STATE_COLS < N <= blocks * ssd.STATE_COLS


def test_ssd_plan_at_mamba2_prefill():
    """4 chunks of 128 a row: 1,280 blocks of the scan and of the state
    kernel (4 blocks of 32 state columns a row) against the 320 rows the
    kernel before the redesign ran one block each, and 42 MB of fp32
    states."""
    plan = ssd.ssd_plan(4, 512, 80, 64, 128, 128)
    assert plan == ssd.SsdPlan(chunk=128, chunks=4, grid=(4, 80, 4),
                               state_grid=(4, 80, 4),
                               scratch_bytes=41_943_040)
    assert plan.chunks * 80 * 4 == 1280
    assert ssd.ssd_plan(2, 37, 80, 64, 128, 37).chunk == 37
    assert ssd.ssd_plan(1, 2048, 80, 64, 128, 128).chunks == 16


# The reference's long shapes (src/repro/configs/shapes.py) as one card
# runs them: prefill_32k and decode_32k at a batch of 2 over a 32,800-row
# cache (16 (batch, KV head) pairs of qwen3-4b), long_500k's 524,288
# positions at mamba2-2.7b's widths, train_4k's 4,096.  A CUDA grid's x
# may reach 2^31 - 1 blocks, its y and z 65,535.
LONG_DECODE_LENGTHS = [32769, 32770, 32784, 32799, 32800]
GRID_X, GRID_YZ = 2**31 - 1, 65535


def _in_grid_limits(grid):
    x, *yz = grid
    return 1 <= x <= GRID_X and all(1 <= d <= GRID_YZ for d in yz)


@pytest.mark.parametrize("skv", LONG_DECODE_LENGTHS)
def test_decode_plan_covers_a_32k_cache_once_in_whole_chunks(skv):
    plan = fa.decode_plan(skv, 2 * 8, H100_SMS)
    assert plan.rows_per_split % fa.DECODE_CHUNK == 0
    assert (plan.splits - 1) * plan.rows_per_split < skv
    assert plan.splits * plan.rows_per_split >= skv
    assert plan.combine and 16 * plan.splits >= 2 * H100_SMS
    assert _in_grid_limits((plan.splits, 8, 2))


def test_ssd_plans_at_long_500k_and_train_4k_stay_in_the_grid():
    """4,096 chunks of 128 on the scan's x, 10 GiB of entering states,
    and the backward's grids at mamba2-2.7b's training shape."""
    plan = ssd.ssd_plan(1, 524_288, 80, 64, 128, 128)
    assert plan.chunks == 4096 and plan.grid == (4096, 80, 1)
    assert plan.scratch_bytes == 10_737_418_240
    assert _in_grid_limits(plan.grid) and _in_grid_limits(plan.state_grid)
    # the prompt plus one token: a tail chunk of one position
    assert ssd.ssd_plan(1, 524_289, 80, 64, 128, 128).chunks == 4097
    bwd = ssd.ssd_bwd_plan(1, 4096, 80, 64, 1, 128, 128, H100_SMS)
    assert bwd.chunks == 32
    for grid in (bwd.state_grid, bwd.grid, (*bwd.group_grid, 1)):
        assert _in_grid_limits(grid)


def test_prefill_grids_at_prefill_32k_stay_in_the_grid():
    """The prefill kernels' grids as csrc/flash_attention.cu launches them
    (a block per query head, batch and 64 query rows on the tensor cores;
    per 64 query rows, query head and batch on the FMA kernel), at a
    batch of 2 of qwen3-4b's 32 heads over 32,768 rows."""
    src = (Path(fa.__file__).parent / "csrc" / "flash_attention.cu"
           ).read_text()
    assert "constexpr int MMA_BQ = 64;" in src
    assert "dim3 grid(Hq, B, (Sq + MMA_BQ - 1) / MMA_BQ)" in src
    assert "launch_fma<D, 64, 32>" in src
    assert "dim3 grid((Sq + BQ - 1) / BQ, Hq, B)" in src
    B, Hq, Sq = 2, 32, 32768
    for grid in ((Hq, B, -(-Sq // 64)), (-(-Sq // 64), Hq, B)):
        assert _in_grid_limits(grid) and sorted(grid) == [2, 32, 512]


# prefill_32k and decode_32k of the other archs (LONG_* of chip_smoke.py):
# a batch of 2 prompts of 32,768 tokens, 65,536 rows a norm call, a cache of
# 32,800 rows; (arch, Hq, Hkv, D, causal) of each prefill's attention
LONG_ROWS = 2 * 32768
LONG_PREFILLS = [("whisper-medium", 16, 16, 64, False),
                 ("internlm2-20b", 48, 8, 128, True),
                 ("nemotron-4-15b", 48, 8, 128, True),
                 ("qwen1.5-4b", 20, 20, 128, True),
                 ("qwen2-vl-2b", 12, 2, 128, True)]
# (arch, (batch, KV head) pairs, KV rows) of each decode: whisper's
# cross-attention over 32,768 frames, the self-attention over the cache
LONG_DECODES = [("whisper-medium", 32, 32768), ("whisper-medium", 32, 32799),
                ("internlm2-20b", 16, 32800), ("nemotron-4-15b", 16, 32769),
                ("qwen1.5-4b", 40, 32769), ("qwen1.5-4b", 40, 32800),
                ("qwen2-vl-2b", 4, 32800)]


@pytest.mark.parametrize("arch,Hq,Hkv,D,causal", LONG_PREFILLS,
                         ids=[a for a, *_ in LONG_PREFILLS])
def test_prefill_grids_of_the_other_archs_at_32k_stay_in_the_grid(
        arch, Hq, Hkv, D, causal):
    """Each arch's heads as its config gives them, and both prefill
    kernels' grids (as csrc/flash_attention.cu launches them) within
    CUDA's limits at a batch of 2 over 32,768 rows."""
    cfg = get_config(arch)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (Hq, Hkv, D)
    assert D in fa.HEAD_DIMS and Hq % Hkv == 0
    # a prefill, not the decode path
    assert 32768 * (Hq // Hkv) > fa.DECODE_ROWS
    for grid in ((Hq, 2, -(-32768 // 64)), (-(-32768 // 64), Hq, 2)):
        assert _in_grid_limits(grid)


@pytest.mark.parametrize("arch,pairs,skv", LONG_DECODES,
                         ids=[f"{a}-{s}" for a, _, s in LONG_DECODES])
def test_decode_plan_of_the_other_archs_covers_32k_rows_once(arch, pairs,
                                                             skv):
    """The split-KV plan over each decode's rows: whole chunks covering
    them once, a block on every SM (two an SM but for the rounding of a
    split to whole chunks: qwen2-vl-2b's 4 pairs take 65 splits of 512,
    260 blocks), the grid within CUDA's limits, and the combine's blocks
    (one a (batch, query head))."""
    cfg = get_config(arch)
    assert pairs == 2 * cfg.n_kv_heads * cfg.kv_cache_repeat
    plan = fa.decode_plan(skv, pairs, H100_SMS)
    assert plan.rows_per_split % fa.DECODE_CHUNK == 0
    assert (plan.splits - 1) * plan.rows_per_split < skv
    assert plan.splits * plan.rows_per_split >= skv
    assert plan.combine and pairs * plan.splits > H100_SMS
    assert pairs * (plan.splits + 1) >= 2 * H100_SMS
    Hkv = pairs // 2
    group = cfg.n_heads // cfg.n_kv_heads
    assert _in_grid_limits((plan.splits, Hkv, 2))
    assert _in_grid_limits((2 * Hkv * group,))


@pytest.mark.parametrize("kind,N", [("layernorm", 6144), ("layernorm", 1024),
                                    ("rmsnorm", 6144), ("rmsnorm", 1536)])
@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "fp32"])
def test_norm_plans_at_65536_rows_stay_in_the_grid(kind, N, esize):
    """The norms on a 32k prefill's 65,536 rows (nemotron-4-15b's and
    whisper-medium's layernorm, internlm2-20b's and qwen2-vl-2b's rmsnorm):
    the one-pass kernel a block a row, or layernorm's warp kernel
    ROW_WARPS rows a block, its grid's x within CUDA's limit; each row's
    vectors or elements held once as the plans' tests above hold them."""
    src = (Path(sfu.__file__).parent / "csrc" / "sfu.cu").read_text()
    threads = sfu.norm_plan(N, esize, True)
    if N > sfu.WARP_ROW_MAX:
        assert threads == N * esize // 16 // sfu.ROW_VPT
        assert "norm_vec_kernel<T, true><<<R, threads" in src
        blocks = LONG_ROWS
    else:
        assert kind == "layernorm" and threads == 0
        slots, vector = sfu.warp_plan(N, esize, True)
        assert vector and 32 * slots >= N * esize // 16
        warps = int(src.split("constexpr int ROW_WARPS = ")[1].split(";")[0])
        assert "<<<warp_blocks(R), ROW_WARPS * 32" in src
        blocks = -(-LONG_ROWS // warps)
    assert _in_grid_limits((blocks,))


def test_long_offsets_are_64_bit():
    """At 32k the largest tensors a kernel call addresses hold up to
    402,653,184 elements (internlm2-20b's queries (2, 48, 32,768, 128), the
    65,536 x 6,144 norm rows) and 671,744,000 bytes (qwen1.5-4b's 20-head
    cache of 32,800 rows): every base offset of a row, a (batch, head) or a
    cache is computed in 64 bits (size_t) before it is scaled, as the
    kernels' sources write them."""
    fa_src = (Path(fa.__file__).parent / "csrc" / "flash_attention.cu"
              ).read_text()
    sfu_src = (Path(sfu.__file__).parent / "csrc" / "sfu.cu").read_text()
    for want in ("((size_t)b * Hq + h) * Sq * D",
                 "((size_t)b * Hkv + hk) * kv_stride * D",
                 "((size_t)b * Hkv + hk) * Skv * D",
                 "((size_t)b * Hq + h) * Sq + qi",
                 "const size_t rows0 = ((size_t)b * Hkv + hk) * G"):
        assert want in fa_src
    for want in ("x + (size_t)row * N", "x + (size_t)blockIdx.x * N",
                 "reinterpret_cast<const uint4*>(x) + (size_t)blockIdx.x * V"):
        assert want in sfu_src
    # no base pointer is offset by a product of 32-bit ints
    for src in (fa_src, sfu_src):
        for line in src.splitlines():
            if "* Sq * D" in line or "* kv_stride * D" in line:
                assert "(size_t)" in line, line
    assert 2 * 48 * 32768 * 128 == 65536 * 6144 == 402_653_184 < 2**31
    assert 2 * 20 * 32800 * 128 * 2 * 2 == 671_744_000


# prefill_32k and decode_32k of the MoE archs (LONG_MOE_CUTS of
# chip_smoke.py) and mamba2-2.7b: the same batch of 2 prompts of 32,768
# tokens; (arch, Hq, Hkv, D) of each attention, the rmsnorm widths of
# llama4-maverick (5,120), jamba-1.5-large (8,192 and its gated norm's
# 16,384) and the SSD heads of jamba (256) and mamba2-2.7b (80)
LONG_MOE_ATTENTION = [("dbrx-132b", 48, 8, 128),
                      ("llama4-maverick-400b-a17b", 40, 8, 128),
                      ("jamba-1.5-large-398b", 64, 8, 128)]


@pytest.mark.parametrize("arch,Hq,Hkv,D", LONG_MOE_ATTENTION,
                         ids=[a for a, *_ in LONG_MOE_ATTENTION])
def test_prefill_grids_of_the_moe_archs_at_32k_stay_in_the_grid(arch, Hq,
                                                               Hkv, D):
    """Both prefill kernels' grids at a batch of 2 over 32,768 rows, up to
    jamba's 64 query heads (536,870,912 query elements, under 2^31)."""
    cfg = get_config(arch)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == (Hq, Hkv, D)
    assert D in fa.HEAD_DIMS and Hq % Hkv == 0
    assert 32768 * (Hq // Hkv) > fa.DECODE_ROWS
    for grid in ((Hq, 2, -(-32768 // 64)), (-(-32768 // 64), Hq, 2)):
        assert _in_grid_limits(grid)
    assert 2 * Hq * 32768 * D <= 2 * 64 * 32768 * 128 == 2**29 < 2**31


@pytest.mark.parametrize("skv", [32769, 32800])
@pytest.mark.parametrize("arch", [a for a, *_ in LONG_MOE_ATTENTION])
def test_decode_plan_of_the_moe_archs_covers_32k_rows_once(arch, skv):
    """Their decode over a 32,800-row cache: 16 (batch, KV head) pairs, the
    splits' whole chunks covering the rows once with a block on every SM,
    the grid and the combine's blocks (2 x 64 at jamba) within CUDA's
    limits."""
    cfg = get_config(arch)
    pairs = 2 * cfg.n_kv_heads * cfg.kv_cache_repeat
    assert pairs == 16
    plan = fa.decode_plan(skv, pairs, H100_SMS)
    assert plan.rows_per_split % fa.DECODE_CHUNK == 0
    assert (plan.splits - 1) * plan.rows_per_split < skv
    assert plan.splits * plan.rows_per_split >= skv
    assert plan.combine and pairs * plan.splits >= 2 * H100_SMS
    assert _in_grid_limits((plan.splits, cfg.n_kv_heads, 2))
    assert _in_grid_limits((2 * cfg.n_heads,))


@pytest.mark.parametrize("N", [5120, 8192, 16384])
@pytest.mark.parametrize("esize", [2, 4], ids=["bf16", "fp32"])
def test_rmsnorm_plans_of_the_moe_archs_at_65536_rows_stay_in_the_grid(
        N, esize):
    """The rmsnorm kernel on 65,536 rows: the one-pass kernel a block a
    row (bf16's gated norm at 16,384 in 1,024 threads), or for fp32 at
    16,384 (2,048 threads of two vectors would pass a block's 1,024) the
    block kernel, a block a row; the grid's x within CUDA's limit and
    each row's base offset 64-bit (the gated rows hold 2^30 elements, 4
    GiB in fp32)."""
    src = (Path(sfu.__file__).parent / "csrc" / "sfu.cu").read_text()
    threads = sfu.norm_plan(N, esize, True)
    if (N, esize) == (16384, 4):
        assert threads == 0
        assert "rmsnorm_block_kernel<T><<<R, ROW_THREADS" in src
        assert "x + (size_t)blockIdx.x * N" in src
    else:
        assert threads == N * esize // 16 // sfu.ROW_VPT <= sfu.MAX_THREADS
        assert "norm_vec_kernel<T, false><<<R, threads" in src
        assert ("reinterpret_cast<const uint4*>(x) + (size_t)blockIdx.x * V"
                in src)
    assert _in_grid_limits((LONG_ROWS,))
    assert LONG_ROWS * 16384 == 2**30


@pytest.mark.parametrize("H", [256, 80], ids=["jamba", "mamba2"])
def test_ssd_plans_at_prefill_32k_stay_in_the_grid(H):
    """ssd over 2 x 32,768 positions at H heads of 64, state 128: 256
    chunks of 128 on the scan's x, the state kernel's blocks, and the
    states entering each chunk (4 GiB at jamba's 256 heads) addressed in
    64 bits, as are x's and y's rows (2^30 elements at 256 heads)."""
    plan = ssd.ssd_plan(2, 32768, H, 64, 128, 128)
    assert plan.chunks == 256 and plan.grid == (256, H, 2)
    assert plan.state_grid == (128 // ssd.STATE_COLS, H, 2)
    assert plan.scratch_bytes == 4 * 2 * 256 * H * 64 * 128
    assert _in_grid_limits(plan.grid) and _in_grid_limits(plan.state_grid)
    src = (Path(ssd.__file__).parent / "csrc" / "ssd.cu").read_text()
    for want in ("return ((size_t)bi * nc + ci) * H + h;",
                 "states + slot(bi, ci, h, nc, H) * P * N",
                 "row = ((size_t)bi * H + h) * PN",
                 "y + ((size_t)bi * S + c0 + t) * H * P + (size_t)h * P",
                 "x + bi * xsb + c0 * xss + (long long)h * P"):
        assert want in src
    if H == 256:
        assert plan.scratch_bytes == 2**32
        assert 2 * 32768 * H * 64 == 2**30
