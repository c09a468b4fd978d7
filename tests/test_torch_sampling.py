"""The port's per-request sampler (``serve/sampling.py``) against the
reference's ``repro.serve.sampling.sample_tokens`` and ``jax.random``.

Bitwise: the keys (``PRNGKey(seed)`` then ``fold_in``), the 32-bit random
bits and the uniform on [tiny, 1): integer arithmetic and one exact f32
subtraction, scale and add.  The Gumbel values ``-log(-log(u))`` within
GUMBEL_ULP_BOUND ULPs of max(|g|, 1): XLA's and PyTorch's ``log`` differ by
an ULP (measured at most 2, about 1 value in 4 differing at all), which
the outer ``log`` turns into an absolute error that near g = 0 is many ULPs
of g itself.  Tokens equal, on a grid whose every sampled row's winning
margin is asserted above the Gumbel bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve.sampling import sample_tokens as ref_sample_tokens
from repro_torch.serve import sample_tokens
from repro_torch.serve import sampling as S

SEEDS = [0, 1, 2 ** 31 - 1, -7]
POSITIONS = [0, 5, 1000, 2 ** 31 - 1]
V = 4096
GUMBEL_ULP_BOUND = 4


def _keys(seed, pos):
    """(the reference's key words, the port's key) for (seed, pos)."""
    key = jax.random.fold_in(jax.random.PRNGKey(np.int32(seed)),
                             np.int32(pos))
    port = S.fold_in(S.prng_key(torch.tensor([seed], dtype=torch.int32)),
                     torch.tensor([pos], dtype=torch.int32))
    return key, port


def test_gumbel_mode_is_jax_default():
    assert not jax.config.jax_high_dynamic_range_gumbel
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_match_jax(seed):
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(np.int32(seed))))
    got = S.prng_key(torch.tensor([seed], dtype=torch.int32))
    assert [int(got[0][0]), int(got[1][0])] == want.tolist()
    for pos in POSITIONS:
        key, port = _keys(seed, pos)
        want = np.asarray(jax.random.key_data(key))
        assert [int(port[0][0]), int(port[1][0])] == want.tolist(), pos


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_match_jax_bitwise(seed):
    tiny = np.finfo(np.float32).tiny
    for pos in POSITIONS:
        key, port = _keys(seed, pos)
        bits = S.random_bits(port, V)[0].numpy()
        want = np.asarray(jax.random.bits(key, (V,), jnp.uint32))
        np.testing.assert_array_equal(bits, want.astype(np.int64))
        u = S.uniform(S.random_bits(port, V))[0].numpy()
        want = np.asarray(jax.random.uniform(key, (V,), jnp.float32,
                                             minval=tiny, maxval=1.0))
        np.testing.assert_array_equal(u.view(np.int32), want.view(np.int32))


def _gumbel_ulps(got, want):
    ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
    return float((np.abs(got - want) / ulp).max())


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_matches_jax_within_ulps(seed):
    for pos in POSITIONS:
        key, port = _keys(seed, pos)
        got = S.gumbel(port, V)[0].numpy()
        want = np.asarray(jax.random.gumbel(key, (V,), jnp.float32))
        assert _gumbel_ulps(got, want) <= GUMBEL_ULP_BOUND, pos


def test_keys_per_row_match_one_row_at_a_time():
    seeds = torch.tensor(SEEDS, dtype=torch.int32)
    pos = torch.tensor(POSITIONS, dtype=torch.int32)
    g = S.gumbel(S.fold_in(S.prng_key(seeds), pos), 64)
    for i in range(len(SEEDS)):
        alone = S.gumbel(S.fold_in(S.prng_key(seeds[i:i + 1]),
                                   pos[i:i + 1]), 64)
        assert torch.equal(g[i], alone[0])


def _grid(rng):
    """(8, V) logits and per-row (positions, seeds, temperatures, top_ks):
    greedy rows, temperature 0.7, top-k 0, 1 and 5, rows with ties at the
    5th value, and the same seed at two positions."""
    logits = rng.standard_normal((8, V)).astype(np.float32) * 3
    # rows 5 and 6: the 3rd to 7th largest values equal, so top-k 5 keeps 7
    for r in (5, 6):
        order = np.argsort(-logits[r])
        logits[r, order[2:7]] = logits[r, order[2]]
    positions = np.array([3, 17, 17, 40, 2 ** 31 - 1, 9, 9, 0], np.int32)
    seeds = np.array([11, 11, 12, -3, 7, 2 ** 31 - 1, 5, 0], np.int32)
    temps = np.array([0.0, 0.7, 0.7, 1.0, 0.7, 0.7, 1.3, 0.0], np.float32)
    top_ks = np.array([0, 0, 5, 1, 0, 5, 5, 5], np.int32)
    return logits, positions, seeds, temps, top_ks


@pytest.mark.parametrize("case", range(3))
def test_sample_tokens_matches_reference(case):
    rng = np.random.default_rng(case)
    logits, positions, seeds, temps, top_ks = _grid(rng)
    if case == 2:                      # every row greedy, then every row top-1
        temps[:] = 0.0
    want = np.asarray(jax.jit(ref_sample_tokens)(
        jnp.asarray(logits), jnp.asarray(positions), jnp.asarray(seeds),
        jnp.asarray(temps), jnp.asarray(top_ks)))
    got = sample_tokens(torch.from_numpy(logits), torch.from_numpy(positions),
                        torch.from_numpy(seeds), torch.from_numpy(temps),
                        torch.from_numpy(top_ks))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the winner of every sampled row beats the runner-up by more than the
    # Gumbel bound can move two values, so equal tokens are not luck
    lt = torch.from_numpy(logits) / torch.from_numpy(temps).clamp_min(
        1e-6)[:, None]
    g = S.gumbel(S.fold_in(S.prng_key(torch.from_numpy(seeds)),
                           torch.from_numpy(positions)), V)
    for r in np.flatnonzero(temps > 0):
        k = int(top_ks[r]) or V
        kth = torch.sort(lt[r], descending=True).values[k - 1]
        z = torch.where(lt[r] >= kth, lt[r] + g[r], -torch.inf)
        top2 = torch.topk(z, 2).values
        slack = 2 * GUMBEL_ULP_BOUND * float(np.spacing(
            np.float32(max(float(top2[0].abs()), 1.0))))
        assert float(top2[0] - top2[1]) > slack, r
    if case == 2:                      # top-k 1 samples the greedy token
        temps[:] = 0.7
        top_ks[:] = 1
        one = sample_tokens(torch.from_numpy(logits),
                            torch.from_numpy(positions),
                            torch.from_numpy(seeds), torch.from_numpy(temps),
                            torch.from_numpy(top_ks))
        np.testing.assert_array_equal(one.numpy(), want)


def test_top_k_keeps_ties_at_the_kth_value():
    """Ties at the k-th value all stay in the draw (``scaled >= kth``), as
    in the reference, where ``torch.topk`` would keep exactly k."""
    logits = torch.full((1, 16), -10.0)
    logits[0, 3:9] = 2.0                    # six tied at the top
    seen = set()
    for pos in range(64):
        seen.add(int(sample_tokens(logits, [pos], [1], [1.0], [2])[0]))
    assert seen == set(range(3, 9))
