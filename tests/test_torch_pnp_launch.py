"""K1's launch shape (polychase_tpu_torch.kernels.pnp_lm.launch_shape), a
pure function of the batch S and the point count N: its slices cover every
point exactly once, its cluster sizes are ones the kernel takes, small
solves run in one warp, and a batch stays within the card's SMs."""

import pytest

from polychase_tpu_torch.kernels import pnp_lm
from polychase_tpu_torch.kernels.pnp_lm import launch_shape

NS = [0, 1, 3, 8, 31, 32, 33, 1000, 8192, 16384, 16385, 200000]


@pytest.mark.parametrize("S", [1, 8, 64])
@pytest.mark.parametrize("N", NS)
def test_launch_shape(S, N):
    shape = launch_shape(S, N)
    assert shape.cluster in (1, 2, 4, 8, 16)
    assert shape.threads in (pnp_lm.WARP_THREADS, pnp_lm.BLOCK_THREADS)
    seen = []
    for r in range(shape.cluster):
        lo = r * shape.per_block
        seen.extend(range(lo, min(N, lo + shape.per_block)))
    assert seen == list(range(N))
    assert shape.staged == (shape.per_block <= pnp_lm.STAGE_MAX)
    if N <= pnp_lm.WARP_MAX:
        assert (shape.cluster, shape.threads) == (1, pnp_lm.WARP_THREADS)
    else:
        assert shape.threads == pnp_lm.BLOCK_THREADS
        assert S * shape.cluster <= max(pnp_lm.SMS, S)
        # The smallest cluster whose blocks hold about BLOCK_POINTS each,
        # unless the batch or the largest cluster caps it.
        if shape.cluster > 1:
            assert N > pnp_lm.BLOCK_POINTS * (shape.cluster // 2)
        if shape.per_block > pnp_lm.BLOCK_POINTS:
            assert (shape.cluster == pnp_lm.MAX_CLUSTER
                    or S * shape.cluster * 2 > pnp_lm.SMS)


@pytest.mark.parametrize("cap", [1, 2, 8])
def test_launch_shape_obeys_the_cluster_cap(cap):
    """A card that schedules smaller clusters only gets longer slices,
    streamed once they outgrow a block's shared memory."""
    for N in (8192, 16384, 200000):
        shape = launch_shape(1, N, max_cluster=cap)
        assert shape.cluster <= cap
        assert shape.cluster * shape.per_block >= N
        assert shape.staged == (shape.per_block <= pnp_lm.STAGE_MAX)
