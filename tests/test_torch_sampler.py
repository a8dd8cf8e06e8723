"""The port's threefry streams and fused sampler against ``jax.random`` and
the reference's ``sample_tokens`` (CPU).

  * ``models/prng.py``: key data, ``fold_in`` (data of 2^31 and above),
    32-bit random bits (an odd size, qwen2's vocabulary of 151936, a 2-D
    shape, a batch of keys) and uniform floats equal jax's bit for bit;
    Gumbel noise within ``GUMBEL_ULPS`` (the two packages' logs round
    differently).
  * ``models/paged.py::sample_tokens``: on the same logits, keys and
    positions as the reference (B 8, V 1024, rows greedy, temperature
    only, top-k, top-p and both), greedy rows are equal and sampled rows
    equal except at a stated Gumbel near-tie or nucleus boundary, which
    are counted; the reference's statistical checks
    (tests/test_decode_consistency.py) hold for the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.paged import sample_tokens as jax_sample_tokens
from repro_torch.models import prng
from repro_torch.models.paged import sample_tokens
from torch_threads import one_torch_thread  # noqa: E402,F401

# Gumbel noise is -log(-log(u)) on both sides: XLA's float32 logs put the
# reference's within about an ulp of the exact value, the port's float64
# logs within half an ulp, so they may differ by 2 ulps of max(|g|, 1)
# (|g| < 17 for float32 u in [tiny, 1)).  (torch's float32 CPU log was
# seen 1e-4 off on one element in some multi-process runs: the port takes
# its logs in float64.)
GUMBEL_ULPS = 2
# on the same logits, a sampled token may differ only where the two
# largest of (masked + g) lie closer than the Gumbel bound above (2 ulps
# at |g| < 16 is < 1e-5), or where a token's nucleus mass before it
# (cum - probs) lies this close to top_p: the two softmax and cumsum
# implementations sum in other orders (1024 float32 terms)
GUMBEL_TIE = 1e-5
NUCLEUS_EPS = 1e-5

SEEDS = [0, 1, 3, 12345, 2 ** 31 - 1, 2 ** 32 - 1]


def _jax_words(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_words_equal_jax(seed):
    assert np.array_equal(prng.prng_key(seed).numpy(),
                          _jax_words(jax.random.PRNGKey(seed)))
    for data in (0, 5, 2 ** 31 - 1, 2 ** 31, 2 ** 31 + 7, 2 ** 32 - 1):
        want = _jax_words(jax.random.fold_in(jax.random.PRNGKey(seed), data))
        assert np.array_equal(prng.fold_in(prng.prng_key(seed), data).numpy(),
                              want), data
        # the host path the runner folds its row keys with
        assert prng.fold_in_words(prng.key_words(seed), data) == \
            tuple(want.tolist()), data


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_and_uniform_equal_jax(seed):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 77)
    tkey = prng.fold_in(prng.prng_key(seed), 77)
    for shape in ((1,), (7,), (1024,), (151936,), (3, 5)):
        want = np.asarray(jax.random.bits(key, shape, jnp.uint32))
        got = prng.random_bits(tkey, shape).numpy()
        assert np.array_equal(got, want.astype(np.int64)), shape
    tiny = float(np.finfo(np.float32).tiny)
    for lo, hi in ((0.0, 1.0), (tiny, 1.0), (-2.0, 3.0)):
        want = np.asarray(jax.random.uniform(key, (151936,), jnp.float32,
                                             minval=lo, maxval=hi))
        got = prng.uniform(tkey, (151936,), lo, hi).numpy()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_ulps_of_jax(seed):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 2 ** 31 + seed % 97)
    tkey = prng.fold_in(prng.prng_key(seed), 2 ** 31 + seed % 97)
    want = np.asarray(jax.random.gumbel(key, (151936,), jnp.float32))
    got = prng.gumbel(tkey, (151936,)).numpy()
    ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    excess = np.abs(got - want) / ulp
    i = int(excess.argmax())
    assert excess[i] <= GUMBEL_ULPS, (i, got[i], want[i])


def test_batched_keys_fold_positions_per_row():
    """A (B, 2) batch of row keys folded with a (B,) batch of positions
    gives each row jax's words for its own (rid, position)."""
    base = prng.prng_key(0)
    keys = torch.stack([prng.fold_in(base, r) for r in range(4)])
    pos = [3, 9, 2 ** 31, 0]
    got = prng.random_bits(prng.fold_in(keys, torch.tensor(pos)),
                           (11,)).numpy()
    for r, c in enumerate(pos):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(0), r), c)
        want = np.asarray(jax.random.bits(k, (11,), jnp.uint32))
        assert np.array_equal(got[r], want.astype(np.int64)), r


# ---------------------------------------------------------------------------
# sample_tokens against the reference
# ---------------------------------------------------------------------------

# greedy, temperature only, top-k, top-p, both, greedy, both (tight), hot
MIXED = np.asarray([(0.0, 0, 1.0), (0.8, 0, 1.0), (1.0, 50, 1.0),
                    (0.7, 0, 0.9), (1.2, 40, 0.8), (0.0, 7, 0.5),
                    (0.5, 5, 0.5), (1.5, 0, 1.0)], np.float32)


def _explained(logits, keys, ctx, smp, row, a, b) -> str:
    """Why two samplers on the same row may pick tokens a != b: 'tie' if
    (masked + g) of a and b lie within GUMBEL_TIE, 'nucleus' if either
    token's mass before it lies within NUCLEUS_EPS of top_p; else ''."""
    t, _, p = (float(v) for v in smp[row])
    scaled = torch.from_numpy(logits[row]) / max(t, 1e-6)
    g = prng.gumbel(prng.fold_in(torch.from_numpy(keys[row]),
                                 int(ctx[row])), (logits.shape[1],))
    if abs(float((scaled + g)[a] - (scaled + g)[b])) < GUMBEL_TIE:
        return "tie"
    order = torch.argsort(scaled, descending=True)
    probs = torch.softmax(scaled[order].double(), dim=-1)
    before = torch.cumsum(probs, 0) - probs
    rank = {int(tok): i for i, tok in enumerate(order[:4096])}
    if any(abs(float(before[rank[x]]) - p) < NUCLEUS_EPS
           for x in (a, b) if x in rank):
        return "nucleus"
    return ""


def test_sample_tokens_matches_the_reference():
    rng = np.random.default_rng(0)
    B, V = MIXED.shape[0], 1024
    excluded, drawn = [], 0
    for trial in range(40):
        logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
        keys = rng.integers(0, 2 ** 32, (B, 2), dtype=np.uint64)
        ctx = rng.integers(0, 2 ** 31, (B,)).astype(np.int32)
        want = np.asarray(jax_sample_tokens(
            jnp.asarray(logits), jnp.asarray(keys.astype(np.uint32)),
            jnp.asarray(ctx), jnp.asarray(MIXED)))
        got = sample_tokens(torch.from_numpy(logits),
                            torch.from_numpy(keys.astype(np.int64)),
                            torch.from_numpy(ctx),
                            torch.from_numpy(MIXED)).numpy()
        greedy = MIXED[:, 0] <= 0
        assert np.array_equal(got[greedy], logits[greedy].argmax(-1))
        assert np.array_equal(got[greedy], want[greedy])
        drawn += int((~greedy).sum())
        for row in np.flatnonzero(got != want):
            why = _explained(logits, keys.astype(np.int64), ctx, MIXED, row,
                             int(got[row]), int(want[row]))
            assert why, (trial, row, got[row], want[row])
            excluded.append(why)
    assert len(excluded) <= drawn // 100, (excluded, drawn)


def test_argmax_only_variant_is_the_greedy_rows():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((8, 512)).astype(
        np.float32))
    logits[3, 7] = logits[3, 9] = logits[3].max() + 1.0   # a tie: first wins
    greedy = torch.zeros((8, 3))
    full = sample_tokens(logits, torch.zeros((8, 2), dtype=torch.int64),
                         torch.zeros(8, dtype=torch.int32), greedy)
    fast = sample_tokens(logits, None, None, None, sampled=False)
    assert torch.equal(full, fast) and fast.dtype == torch.int32
    assert int(fast[3]) == 7
    assert torch.equal(fast, torch.from_numpy(np.asarray(
        jnp.argmax(jnp.asarray(logits.numpy()), axis=-1))).int())


# ---------------------------------------------------------------------------
# the reference's statistical checks, for the port
# (tests/test_decode_consistency.py)
# ---------------------------------------------------------------------------


def _fixed_logits(B, V, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(B, V)
                            .astype(np.float32))


def _keys(B, seed=1):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 2 ** 31, (B, 2)).astype(np.int64))


def _ctx(B, val=0):
    return torch.full((B,), val, dtype=torch.int32)


def _smp(B, temp, k, p):
    return torch.tensor([[temp, float(k), p]]).repeat(B, 1)


@pytest.mark.parametrize("temp,k,p", [(0.0, 0, 1.0), (1.0, 1, 1.0),
                                      (1.0, 0, 1e-6)])
def test_sample_tokens_greedy_paths_are_argmax(temp, k, p):
    logits, keys = _fixed_logits(8, 32), _keys(8)
    toks = sample_tokens(logits, keys, _ctx(8), _smp(8, temp, k, p))
    assert torch.equal(toks.long(), logits.argmax(-1))


def test_sample_tokens_pure_function_of_key_and_position():
    logits, keys = _fixed_logits(16, 64), _keys(16)
    smp = _smp(16, 1.0, 0, 1.0)
    t1 = sample_tokens(logits, keys, _ctx(16, 5), smp)
    t2 = sample_tokens(logits, keys, _ctx(16, 5), smp)
    assert torch.equal(t1, t2)
    t3 = sample_tokens(logits, keys, _ctx(16, 6), smp)
    assert not torch.equal(t3, t1)


def test_sample_tokens_statistics_match_softmax():
    """Temperature-1 sampling over B copies of one row reproduces the
    softmax distribution, within the reference test's 0.035."""
    V, B = 8, 4000
    row = np.random.RandomState(3).randn(V).astype(np.float32)
    logits = torch.from_numpy(np.tile(row, (B, 1)))
    toks = sample_tokens(logits, _keys(B, seed=5), _ctx(B),
                         _smp(B, 1.0, 0, 1.0))
    freq = np.bincount(toks.numpy(), minlength=V) / B
    probs = np.exp(row - row.max())
    probs /= probs.sum()
    np.testing.assert_allclose(freq, probs, atol=0.035)


def test_sample_tokens_top_k_top_p_restrict_support():
    V, B = 16, 800
    row = np.random.RandomState(4).randn(V).astype(np.float32)
    logits = torch.from_numpy(np.tile(row, (B, 1)))
    toks = sample_tokens(logits, _keys(B, seed=6), _ctx(B),
                         _smp(B, 1.0, 3, 1.0))
    assert set(toks.tolist()) <= set(np.argsort(row)[-3:].tolist())
    probs = np.exp(row - row.max())
    probs /= probs.sum()
    order = np.argsort(-row)
    cum = np.cumsum(probs[order])
    p = 0.5
    nucleus = set(order[:int(np.searchsorted(cum, p) + 1)].tolist())
    toks = sample_tokens(logits, _keys(B, seed=7), _ctx(B),
                         _smp(B, 1.0, 0, p))
    assert set(toks.tolist()) <= nucleus
