"""The matmul kernels' tile and split-K plan (``_dequant_matmul.plan``).

Pure Python: the plan decides, for one call, the output tile and how K
is cut across the grid's z dimension. The CUDA kernels rely on it: each
split must be a whole number of the kernel's K steps (so a sub-block's
scales are never cut), the splits must cover K exactly once (so the
fixed-order sum of the splits takes every product once), and the tiles
must be the ones the kernels are instantiated for.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _dequant_matmul as dm  # noqa: E402

SMS = 132                       # an H100's SMs
BF16, F32 = torch.bfloat16, torch.float32

# (M, N, K): qwen3-0.6b's seven linears and its lm_head at the serve's
# M = 64 and at an 8 x 512 prefill, deepseek-v3's widest, ragged shapes,
# one row, and K = 0.
SHAPES = ([(m, n, k) for m in (64, 4096)
           for n, k in ((2048, 1024), (1024, 1024), (1024, 2048),
                        (3072, 1024), (1024, 3072))]
          + [(64, 151936, 1024), (64, 7168, 18432), (8, 1024, 3072),
             (3, 1000, 96), (3, 1000, 100), (5, 200, 104), (70, 300, 3072),
             (1, 64, 256), (64, 1024, 12288), (200, 384, 2048),
             (64, 1024, 0), (4096, 1024, 0)])


def _ranges(k, k_split, splits):
    return [(z * k_split, min(k, (z + 1) * k_split)) for z in range(splits)]


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("mnk", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_every_k_step_lands_in_exactly_one_split(mnk, dtype):
    m, n, k = mnk
    _, k_split, splits = dm.plan(m, n, k, SMS, dtype)
    assert splits >= 1 and k_split > 0
    ranges = _ranges(k, k_split, splits)
    covered = [0] * k
    for lo, hi in ranges:
        for i in range(lo, hi):
            covered[i] += 1
    assert all(c == 1 for c in covered)
    # No empty split, except the only one of K = 0.
    assert all(hi > lo for lo, hi in ranges) or (k == 0 and splits == 1)


@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
@pytest.mark.parametrize("mnk", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_splits_are_whole_k_steps(mnk, dtype):
    """A split starts on a K step of the kernel (64 for the tensor-core
    kernel, 32 for the CUDA-core one): whole 16-element sub-blocks and
    whole 32-element q8_0 blocks."""
    m, n, k = mnk
    _, k_split, _ = dm.plan(m, n, k, SMS, dtype)
    assert k_split % dm.K_STEP[dtype] == 0
    assert k_split % 32 == 0 and k_split % 16 == 0


@pytest.mark.parametrize("n,k", [(2048, 1024), (1024, 3072), (151936, 1024)])
def test_documented_tiles(n, k):
    """bf16 x: 64 x 64 tiles (one consumer warpgroup) up to M = 64, 128 x
    128 (two) above; f32 x: the CUDA-core kernel's 64 x 64."""
    assert dm.plan(64, n, k, SMS, BF16)[0] == 64
    assert dm.plan(8, n, k, SMS, BF16)[0] == 64
    assert dm.plan(65, n, k, SMS, BF16)[0] == 128
    assert dm.plan(4096, n, k, SMS, BF16)[0] == 128
    assert dm.plan(4096, n, k, SMS, F32)[0] == 64


def test_prefill_fills_the_card_without_splitting():
    """At M = 4,096 every qwen3 linear has at least 256 output tiles of
    128 x 128, so K is never split."""
    for n, k in ((2048, 1024), (1024, 1024), (1024, 2048), (3072, 1024),
                 (1024, 3072)):
        tile, k_split, splits = dm.plan(4096, n, k, SMS, BF16)
        assert (tile, splits) == (128, 1) and k_split >= k


def test_decode_splits_keep_whole_runs_of_steps():
    """At M = 64 a few output tiles split K, but each split keeps at
    least MIN_TC_STEPS K steps (its partial tile should not outweigh
    its planes), and never more blocks than two per SM."""
    for n, k in ((1024, 1024), (1024, 3072), (2048, 1024), (3072, 1024)):
        tile, k_split, splits = dm.plan(64, n, k, SMS, BF16)
        tiles = -(-n // tile)
        assert splits > 1
        assert k_split >= dm.MIN_TC_STEPS * dm.K_STEP[BF16] or splits == 1
        assert tiles * splits <= 2 * SMS + tiles


@pytest.mark.parametrize("mnk", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tensor_core_splits_fit_one_cluster(mnk):
    """The tensor-core kernel sums a tile's splits inside one thread-block
    cluster, so a bf16 plan never has more than MAX_TC_SPLITS (8)."""
    m, n, k = mnk
    _, _, splits = dm.plan(m, n, k, SMS, BF16)
    assert 1 <= splits <= dm.MAX_TC_SPLITS == 8


def test_ragged_k_tail_sits_in_the_last_split():
    """K not a multiple of the step (fp16's K = 100): the last split holds
    the ragged tail, every other split is full."""
    for dtype in (BF16, F32):
        _, k_split, splits = dm.plan(3, 1000, 100, SMS, dtype)
        ranges = _ranges(100, k_split, splits)
        assert ranges[-1][1] == 100
        assert all(hi - lo == k_split for lo, hi in ranges[:-1])


def test_k_zero_is_one_empty_split():
    for dtype in (BF16, F32):
        tile, k_split, splits = dm.plan(64, 1024, 0, SMS, dtype)
        assert splits == 1 and _ranges(0, k_split, splits) == [(0, 0)]
