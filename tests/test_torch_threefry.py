"""The port's ``jax.random`` stream (``utils.threefry``) against jax 0.9 on the
CPU: the hash, keys, ``fold_in``, ``split``, bits, uniforms and ``randint``
bit for bit; normals and Gumbels within 1e-6 where |z| ≤ 5.5 (the measured
largest differences, from ``log1p``/``log`` rounding, are 4.8e-7 for both
normals and Gumbels over 2²⁰ draws); categorical ids equal wherever the top
two perturbed logits are further apart than that error; the batched forms
against ``jax.vmap``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from hyperscalees_t2i_tpu_torch.utils import threefry as tf

torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2**31 - 1, 2**32 - 1]
DATA = [0, 1, 17, 2**31 - 1, 2**32 - 1]
# |torch − jax| for normals and Gumbels where |z| ≤ 5.5: measured 4.8e-7
NORMAL_ATOL = 1e-6


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _np(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("key,count,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry2x32_known_answers(key, count, want):
    got = tf.threefry2x32(*key, *count)
    assert tuple(int(x) for x in got) == want
    j = jprng.threefry_2x32(jnp.array(key, jnp.uint32), jnp.array(count, jnp.uint32))
    assert tuple(int(x) for x in np.asarray(j)) == want


@pytest.mark.parametrize("seed", SEEDS + [-1, -2**31, 2**32])
def test_prng_key_matches_jax(seed):
    assert np.array_equal(tf.prng_key(seed, "cpu").numpy(), _np(_jkey(seed)))


def test_keys_default_to_the_card(monkeypatch):
    """A key is made on the card unless the caller asks for the CPU: without
    a card the default raises instead of drawing on the host."""
    from hyperscalees_t2i_tpu_torch.es.sampling import epoch_key

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tf.prng_key(0)
    with pytest.raises(RuntimeError):
        epoch_key(0, 1)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", DATA)
def test_fold_in_matches_jax(seed, data):
    assert np.array_equal(tf.fold_in(tf.prng_key(seed, "cpu"), data).numpy(), _np(jax.random.fold_in(_jkey(seed), data)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [1, 2, 3, 20])
def test_split_matches_jax_and_fold_in(seed, num):
    got = tf.split(tf.prng_key(seed, "cpu"), num)
    assert np.array_equal(got.numpy(), _np(jax.random.split(_jkey(seed), num)))
    for i in range(num):
        assert torch.equal(got[i], tf.fold_in(tf.prng_key(seed, "cpu"), i))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (2, 3, 4, 5), (1 << 20,)])
def test_bits_and_uniform_bitwise(seed, shape):
    k, kt = _jkey(seed), tf.prng_key(seed, "cpu")
    assert np.array_equal(tf.random_bits(kt, shape).numpy(), np.asarray(jax.random.bits(k, shape)).astype(np.int64))
    assert np.array_equal(tf.uniform(kt, shape).numpy(), np.asarray(jax.random.uniform(k, shape)))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.0, 3.5), (1e-3, 1e-2)])
def test_uniform_range_bitwise(lo, hi):
    k, kt = _jkey(5), tf.prng_key(5, "cpu")
    assert np.array_equal(tf.uniform(kt, (4096,), lo, hi).numpy(),
                          np.asarray(jax.random.uniform(k, (4096,), minval=lo, maxval=hi)))


@pytest.mark.parametrize("n", [tf.CHUNK - 1, tf.CHUNK + 3])
def test_chunked_draw_is_the_whole_draw(monkeypatch, n):
    """Chunk boundaries change nothing: a draw in chunks of 1000 equals jax's
    whole draw, and ``flat_bits`` of a flat sub-range equals those elements
    of it."""
    monkeypatch.setattr(tf, "CHUNK", 1000)
    k, kt = _jkey(3), tf.prng_key(3, "cpu")
    n = n % 5000 + 2000  # several small chunks, a ragged last one
    want = np.asarray(jax.random.bits(k, (n,))).astype(np.int64)
    assert np.array_equal(tf.random_bits(kt, (n,)).numpy(), want)
    assert np.array_equal(tf.flat_bits(kt, torch.arange(999, n - 1))[0].numpy(), want[999:n - 1])
    keys = tf.split(kt, 3)  # a batch of keys: 333 elements a chunk each
    want_b = np.stack([np.asarray(jax.random.bits(kj, (n,))).astype(np.int64) for kj in jax.random.split(k, 3)])
    assert np.array_equal(tf.random_bits(keys, (n,)).numpy(), want_b)


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_normal_within_tolerance(seed):
    z, zj = tf.normal(tf.prng_key(seed, "cpu"), (1 << 20,)).numpy(), np.asarray(jax.random.normal(_jkey(seed), (1 << 20,)))
    keep = np.abs(zj) <= 5.5
    err = float(np.abs(z - zj)[keep].max())
    assert err <= NORMAL_ATOL, err
    assert np.isfinite(z).all()


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
def test_gumbel_within_tolerance(seed):
    g, gj = tf.gumbel(tf.prng_key(seed, "cpu"), (1 << 20,)).numpy(), np.asarray(jax.random.gumbel(_jkey(seed), (1 << 20,)))
    keep = np.abs(gj) <= 5.5
    err = float(np.abs(g - gj)[keep].max())
    assert err <= NORMAL_ATOL, err
    assert np.isfinite(g).all()


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, tf.NORMAL_LO])
    got = tf.erf_inv(x)
    assert got[0] == -float("inf") and got[1] == float("inf") and got[2] == 0.0
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x.numpy())))
    assert np.allclose(got.numpy()[3], want[3], rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 11])
def test_categorical_ids_equal_under_margin(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((512, 100)).astype(np.float32) * 3.0
    k, kt = _jkey(seed), tf.prng_key(seed, "cpu")
    got = tf.categorical(kt, torch.from_numpy(logits)).numpy()
    want = np.asarray(jax.random.categorical(k, jnp.asarray(logits)))
    pert = logits + np.asarray(jax.random.gumbel(k, logits.shape))
    top2 = np.sort(pert, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > 2 * NORMAL_ATOL
    assert clear.mean() > 0.99
    assert np.array_equal(got[clear], want[clear])


@pytest.mark.parametrize("lo,hi", [(0, 49408), (0, 64), (-7, 9), (0, 2**17 + 3), (-5, 2**31 - 1)])
def test_randint_bitwise(lo, hi):
    k, kt = _jkey(1), tf.prng_key(1, "cpu")
    got = tf.randint(kt, (10, 8), lo, hi).numpy()
    assert np.array_equal(got, np.asarray(jax.random.randint(k, (10, 8), lo, hi)).astype(np.int64))
    assert got.min() >= lo and got.max() < hi


def test_batched_fold_in_normal_gumbel_split_match_vmap():
    k, kt = _jkey(9), tf.prng_key(9, "cpu")
    idx = np.array([0, 3, 5, 2**31 - 1, 2**32 - 1], np.int64)
    keys = tf.fold_in(kt, torch.from_numpy(idx))
    jkeys = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.asarray(idx.astype(np.uint32)))
    assert np.array_equal(keys.numpy(), _np(jkeys))
    z = tf.normal(keys, (6, 7)).numpy()
    zj = np.asarray(jax.vmap(lambda kk: jax.random.normal(kk, (6, 7)))(jkeys))
    assert np.abs(z - zj).max() <= NORMAL_ATOL
    g = tf.gumbel(keys, (6, 7)).numpy()
    gj = np.asarray(jax.vmap(lambda kk: jax.random.gumbel(kk, (6, 7)))(jkeys))
    assert np.abs(g - gj).max() <= NORMAL_ATOL
    s = tf.split(keys, 3)
    assert np.array_equal(s.numpy(), _np(jax.vmap(lambda kk: jax.random.split(kk, 3))(jkeys)))
    # a key batch folded with a data batch, element by element
    two = tf.fold_in(keys[:2], torch.tensor([4, 6]))
    assert torch.equal(two[1], tf.fold_in(keys[1], 6))


def test_rejects_bad_ranges():
    with pytest.raises(ValueError):
        tf.randint(tf.prng_key(0, "cpu"), (3,), 5, 5)
    with pytest.raises(ValueError):
        tf.randint(tf.prng_key(0, "cpu"), (3,), 0, 2**31)


# |port init − JAX init| of every leaf, from the same key (normals × std ≤ 1)
INIT_ATOL = 1e-6


def _jax_path(path):
    return "/".join(str(p.key) if hasattr(p, "key") else str(p.idx) for p in path)


def assert_tree_matches_jax(jtree, ttree, atol=INIT_ATOL):
    """Leaf by leaf, in flattening order: the same paths, shapes and dtypes,
    and values within ``atol``. Returns the largest difference."""
    from hyperscalees_t2i_tpu_torch.utils.pytree import tree_leaves_with_path

    jl = [(_jax_path(p), np.asarray(v)) for p, v in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    tl = [(p, v.detach().cpu().numpy()) for p, v in tree_leaves_with_path(ttree)]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    worst = 0.0
    for (path, j), (_, t) in zip(jl, tl):
        assert j.shape == t.shape and j.dtype == t.dtype, (path, j.shape, t.shape, j.dtype, t.dtype)
        err = float(np.abs(j.astype(np.float64) - t.astype(np.float64)).max()) if j.size else 0.0
        assert err <= atol, (path, err)
        worst = max(worst, err)
    return worst
