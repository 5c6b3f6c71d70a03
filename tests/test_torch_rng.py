"""repro_torch.core.rng against repro.core.rng: bit-identical draws.

Every generated edge depends on the threefry stream, so the port's RNG is
held to jax.random exactly (tolerance 0) over seeds, every stream id,
ranks 0..63, sizes 1..10^5 and (levels, m) shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rng as jrng
from repro_torch.core import rng as trng

SEEDS = (0, 7, 2**31 - 1)
STREAMS = tuple(getattr(jrng, n) for n in dir(jrng) if n.startswith("STREAM_"))
SIZES = (1, 17, 4097)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several workers per machine; torch's intra-op thread
    pool then oversubscribes the cores (a 10^5-word draw went from 0.3 s
    to 30 s). One thread per worker keeps the CPU path's time stable."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jbits(key, shape):
    return np.asarray(jax.random.bits(key, shape, dtype=jnp.uint32)
                      ).astype(np.int64)


def test_threefry_layout_flag_is_partitionable():
    """The port reproduces the partitionable layout; a flag flip in the
    reference must fail here, not pass off as a port fault."""
    assert jax.config.jax_threefry_partitionable is True


def test_stream_ids_match():
    for name in dir(jrng):
        if name.startswith("STREAM_"):
            assert getattr(trng, name) == getattr(jrng, name), name


@pytest.mark.parametrize("seed", SEEDS)
def test_device_keys_every_stream_and_rank(seed):
    for stream in STREAMS:
        for rank in range(64):
            kd = jax.random.key_data(jrng.device_key(seed, stream, rank))
            assert (int(kd[0]), int(kd[1])) == \
                trng.device_key(seed, stream, rank), (stream, rank)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", SIZES)
def test_bits_and_draws(seed, n):
    rank = (seed + n) % 64
    for stream in (trng.STREAM_PBA_URN, trng.STREAM_PBA_PHASE2_URN,
                   trng.STREAM_CFREE_ER_V):
        kj = jrng.device_key(seed, stream, rank)
        kt = trng.device_key(seed, stream, rank)
        np.testing.assert_array_equal(trng.bits(kt, n).numpy(),
                                      _jbits(kj, (n,)))
        np.testing.assert_array_equal(trng.uniform(kt, n).numpy(),
                                      np.asarray(jax.random.uniform(kj, (n,))))
    kj = jrng.device_key(seed, trng.STREAM_PBA_URN, rank)
    kt = trng.device_key(seed, trng.STREAM_PBA_URN, rank)
    bounds = np.maximum(np.arange(n), 1).astype(np.int32)
    np.testing.assert_array_equal(
        trng.uniform_slots(kt, n, torch.from_numpy(bounds)).numpy(),
        np.asarray(jrng.uniform_slots(kj, n, jnp.asarray(bounds))))
    for prob in (0.05, 0.5, 1e-3):
        np.testing.assert_array_equal(trng.coin(kt, n, prob).numpy(),
                                      np.asarray(jrng.coin(kj, n, prob)))
    for upper in (1, 64, 1000, 2**31 - 1):
        np.testing.assert_array_equal(
            trng.uniform_ints(kt, n, upper).numpy(),
            np.asarray(jrng.uniform_ints(kj, n, upper)))


def test_largest_size_draws():
    """n = 10^5, one key per draw kind: the counter's high bits stay zero
    but every word of a large draw must match."""
    n = 100_000
    kj = jrng.device_key(7, trng.STREAM_PBA_PHASE2_URN, 63)
    kt = trng.device_key(7, trng.STREAM_PBA_PHASE2_URN, 63)
    np.testing.assert_array_equal(trng.bits(kt, n).numpy(), _jbits(kj, (n,)))
    bounds = np.maximum(np.arange(n), 1).astype(np.int32)
    np.testing.assert_array_equal(
        trng.uniform_slots(kt, n, torch.from_numpy(bounds)).numpy(),
        np.asarray(jrng.uniform_slots(kj, n, jnp.asarray(bounds))))
    np.testing.assert_array_equal(trng.coin(kt, n, 0.05).numpy(),
                                  np.asarray(jrng.coin(kj, n, 0.05)))
    np.testing.assert_array_equal(trng.uniform_ints(kt, n, 64).numpy(),
                                  np.asarray(jrng.uniform_ints(kj, n, 64)))


@pytest.mark.parametrize("levels,m", [(1, 5), (4, 3000), (10, 1031)])
def test_two_d_shapes(levels, m):
    kj = jrng.device_key(3, trng.STREAM_PK_NOISE_DIGIT, 5)
    kt = trng.device_key(3, trng.STREAM_PK_NOISE_DIGIT, 5)
    np.testing.assert_array_equal(trng.bits(kt, (levels, m)).numpy(),
                                  _jbits(kj, (levels, m)))
    np.testing.assert_array_equal(
        trng.uniform(kt, (levels, m)).numpy(),
        np.asarray(jax.random.uniform(kj, (levels, m))))


def test_prefixes_stable_across_sizes():
    kt = trng.device_key(7, trng.STREAM_PBA_PHASE2_URN, 1)
    np.testing.assert_array_equal(trng.bits(kt, 5).numpy(),
                                  trng.bits(kt, 8).numpy()[:5])


def test_key_rejects_out_of_range_seed():
    with pytest.raises(ValueError):
        trng.key(-1)
    with pytest.raises(ValueError):
        trng.key(2**31)
