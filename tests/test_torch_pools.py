"""repro_torch's paged pools and staged swap plane against the JAX
package's (CPU).  A copy is exact, so the host pool, the device pool and
the transfer counters must match the reference byte for byte."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache.paged import PagedPools as JaxPagedPools
from repro.cache.paged import PoolSpec as JaxPoolSpec
from repro_torch.cache.paged import PagedPools, PoolSpec
from repro_torch.kernels.block_copy import runs_to_indices
from torch_threads import one_torch_thread  # noqa: E402,F401

BS = 8
SPEC = dict(n_layers=2, n_kv_heads=2, head_dim=8, block_size=BS,
            num_gpu_blocks=16, num_cpu_blocks=24)


def _pair(stage_blocks=16, seed=7):
    """The two packages' pools holding the same random device bytes."""
    rng = np.random.default_rng(seed)
    j = JaxPagedPools(JaxPoolSpec(**SPEC), stage_blocks=stage_blocks)
    t = PagedPools(PoolSpec(**SPEC), device="cpu", stage_blocks=stage_blocks)
    bits = (rng.integers(0, 2 ** 16, tuple(j.gpu.shape), dtype=np.uint16)
            & 0xBFFF)                        # finite bf16 values
    j.gpu = jnp.asarray(bits.view(jnp.bfloat16))
    t.gpu = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    return j, t


def _gpu_bits(pools):
    if isinstance(pools, PagedPools):
        return pools.gpu.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(pools.gpu).view(np.uint16)


def _counters(p):
    return (p.d2h_transfers, p.h2d_transfers, p.staged_out_calls,
            p.staged_in_calls)


def test_host_pool_is_uint16_numpy():
    t = PagedPools(PoolSpec(**SPEC), device="cpu")
    assert isinstance(t.cpu, np.ndarray) and t.cpu.dtype == np.uint16
    assert t.cpu.shape == (2, 2, 24, BS, 2, 8)
    assert t.gpu.dtype == torch.bfloat16 and t.gpu.device.type == "cpu"
    assert PagedPools(PoolSpec(**SPEC), with_data=False).cpu is None


@pytest.mark.parametrize("stage_blocks", [16, 3, 0])
def test_staged_round_trip_matches_reference(stage_blocks):
    """Swap out scattered runs and a context ending mid-block, clobber the
    device pool, swap back in (split into sub-slabs when stage_blocks is
    3): host pool, device pool and counters byte-equal to the
    reference's after every step."""
    j, t = _pair(stage_blocks)
    runs = [(1, 3), (6, 2), (11, 2)]               # 7 blocks, 3 runs
    cpu_ids = [5, 0, 9, 2, 17, 21, 3]              # scattered on purpose
    for p in (j, t):
        p.copy_out_staged(runs, cpu_ids)
    np.testing.assert_array_equal(t.cpu, j.cpu)
    # a partial last block: tokens 2*BS+3 of a request on blocks 4, 9, 13
    n_tokens = 2 * BS + 3
    part = [(4, 1), (9, 1), (13, 1)]
    for p in (j, t):
        p.copy_out_staged(part, [10, 11, 12])
    np.testing.assert_array_equal(t.cpu, j.cpu)
    k0, v0 = t.read_tokens([4, 9, 13], n_tokens)
    j.gpu = jnp.zeros_like(j.gpu)
    t.gpu = torch.zeros_like(t.gpu)
    for p in (j, t):
        p.copy_in_staged(cpu_ids, runs)
        p.copy_in_staged([10, 11, 12], part)
    np.testing.assert_array_equal(_gpu_bits(t), _gpu_bits(j))
    assert _counters(t) == _counters(j)
    k1, v1 = t.read_tokens([4, 9, 13], n_tokens)
    assert torch.equal(k0, k1) and torch.equal(v0, v1)
    blocks = runs_to_indices(runs) + [4, 9, 13]
    other = [b for b in range(16) if b not in blocks]
    assert not _gpu_bits(t)[:, :, other].any(), "scatter leaked"


def test_multi_turn_increments_match_reference():
    """Reuse increments across turns, then one swap-in of the whole
    context: the same host and device bytes as the reference."""
    j, t = _pair(seed=3)
    gpu_ids = [3, 4, 5, 8, 9, 10]
    cpu_ids = [0, 1, 2, 3, 4, 5]
    for lo, hi in ((0, 3), (3, 5), (5, 6)):
        runs = [(s, 1) for s in gpu_ids[lo:hi]]
        for p in (j, t):
            p.copy_out_staged(runs, cpu_ids[lo:hi])
    np.testing.assert_array_equal(t.cpu, j.cpu)
    for p in (j, t):
        p.copy_in_staged(cpu_ids, [(12, 3), (0, 3)])
    np.testing.assert_array_equal(_gpu_bits(t), _gpu_bits(j))
    assert _counters(t) == _counters(j)


def test_mismatched_block_counts_raise():
    _, t = _pair()
    with pytest.raises(ValueError):
        t.copy_out_staged([(0, 2)], [1])
    with pytest.raises(ValueError):
        t.copy_in_staged([1, 2, 3], [(0, 2)])
