"""The port's bitvector layout and predicates against the JAX package.

Packed bitvectors are little-endian ``uint32`` words (record ``r`` at word
``r // 32``, bit ``r % 32``) in every flavour: the port's numpy copy, its
torch flavour (built through int64 because torch has no uint32 shifts on
the CPU) and the JAX package's numpy and jnp flavours must agree bit for
bit.  Exact comparison throughout: all values are integers.

Also here, the reference's ``tests/test_bitvector.py`` on the port (its
roundtrip, reductions and popcount fallback sweeps, each value held
against the JAX package's on the same bits); its ``test_jnp_parity``
becomes the torch flavour's parity with the jnp flavour.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import bitvector as jbv  # noqa: E402
from repro.core import predicates as jpred  # noqa: E402
from repro_torch.core import bitvector as tbv  # noqa: E402
from repro_torch.core import predicates as tpred  # noqa: E402

SHAPES = [(1, 1), (1, 31), (2, 32), (3, 33), (4, 77), (2, 256), (5, 1000)]


def _bits(shape, seed, p=0.5):
    return np.random.default_rng(seed).random(shape) < p


@pytest.mark.parametrize("shape", SHAPES)
def test_pack_unpack_match_jax(shape):
    bits = _bits(shape, sum(shape))
    want = jbv.pack(bits)
    assert np.array_equal(np.asarray(jbv.jnp_pack(jnp.asarray(bits))), want)
    assert np.array_equal(tbv.pack(bits), want)
    words = tbv.torch_pack(torch.from_numpy(bits))
    assert words.dtype == torch.uint32
    assert np.array_equal(words.numpy(), want)
    assert np.array_equal(tbv.torch_unpack(words, shape[1]).numpy(), bits)
    assert np.array_equal(tbv.unpack(want, shape[1]), bits)


@pytest.mark.parametrize("shape", SHAPES)
def test_reductions_match_jax(shape):
    bits = _bits(shape, 7 + shape[1], p=0.8)
    words = jbv.pack(bits)
    tw = torch.from_numpy(words)
    assert tbv.torch_popcount(tw) == jbv.popcount(words) == \
        int(jbv.jnp_popcount(jnp.asarray(words)))
    assert np.array_equal(tbv.torch_and_many(tw).numpy(),
                          np.asarray(jbv.jnp_and_many(jnp.asarray(words))))
    assert np.array_equal(tbv.torch_or_many(tw).numpy(),
                          jbv.bv_or_many(words))
    assert np.array_equal(tbv.bv_and_many(words), jbv.bv_and_many(words))
    assert np.array_equal(tbv.popcount_rows(words), jbv.popcount_rows(words))


def test_high_bit_words_survive_torch_roundtrip():
    """Bit 31 set: the int64 detour must not sign-extend or truncate."""
    words = np.array([[0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 1]], np.uint32)
    bits = jbv.unpack(words, 128)
    tw = tbv.torch_pack(torch.from_numpy(bits))
    assert np.array_equal(tw.numpy(), words)
    assert tbv.torch_popcount(tw) == jbv.popcount(words)


def test_chunk_bitvectors_from_bits_match_jax():
    bits = _bits((4, 70), 3)
    a = tbv.ChunkBitvectors.from_bits(bits)
    b = jbv.ChunkBitvectors.from_bits(bits)
    assert np.array_equal(a.words, b.words)
    assert np.array_equal(a.or_words, b.or_words)
    assert np.array_equal(a.counts, b.counts)


@pytest.mark.parametrize("values", [(10, 10.0), (10, "10"), (1, True),
                                    (0, False), (None, "null")])
def test_predicates_type_strict_like_jax(values):
    """``10``, ``10.0``, ``"10"`` and ``True`` never alias, in both."""
    a, b = values
    for mod in (tpred, jpred):
        pa, pb = mod.key_value("k", a), mod.key_value("k", b)
        assert pa != pb and hash(pa) == hash(pa)
        assert len({pa, pb}) == 2
    obj = tpred.clause_to_obj(tpred.clause(tpred.key_value("k", a)))
    back = jpred.clause_from_obj(obj)
    assert back == jpred.clause(jpred.key_value("k", a))
    assert tpred.clause_to_obj(
        tpred.clause_from_obj(jpred.clause_to_obj(back))) == obj


# ---- tests/test_bitvector.py ------------------------------------------------

@given(st.lists(st.booleans(), min_size=0, max_size=300))
@settings(max_examples=100, deadline=None)
def test_pack_unpack_roundtrip(bits):
    arr = np.array(bits, dtype=bool)
    words = tbv.pack(arr)
    assert words.dtype == np.uint32
    assert np.array_equal(words, jbv.pack(arr))
    out = tbv.unpack(words, len(bits))
    assert np.array_equal(out, arr)


@given(st.integers(1, 5), st.integers(1, 200), st.integers(0, 2**31))
@settings(max_examples=60, deadline=None)
def test_reductions_match_unpacked(p, r, seed):
    rng = np.random.default_rng(seed)
    bits = rng.random((p, r)) < 0.4
    words = tbv.pack(bits)
    assert np.array_equal(tbv.unpack(tbv.bv_and_many(words), r),
                          bits.all(axis=0))
    assert np.array_equal(tbv.unpack(tbv.bv_or_many(words), r),
                          bits.any(axis=0))
    assert np.array_equal(tbv.bv_and_many(words), jbv.bv_and_many(words))
    assert np.array_equal(tbv.bv_or_many(words), jbv.bv_or_many(words))
    row = tbv.pack(bits[0])
    assert tbv.popcount(row) == jbv.popcount(row) == int(bits[0].sum())
    idx = tbv.select_indices(row, r)
    assert np.array_equal(idx, np.nonzero(bits[0])[0])
    assert np.array_equal(idx, jbv.select_indices(row, r))


def test_torch_parity_with_jnp():
    """tests/test_bitvector.py's ``test_jnp_parity``: the port's device
    flavour is torch, held against the JAX package's jnp flavour on the
    same bits."""
    rng = np.random.default_rng(0)
    bits = rng.random((3, 130)) < 0.5
    words = tbv.pack(bits)
    jwords = jbv.jnp_pack(jnp.asarray(bits))
    twords = tbv.torch_pack(torch.from_numpy(bits))
    assert np.array_equal(twords.numpy(), np.asarray(jwords))
    assert np.array_equal(twords.numpy(), words)
    assert np.array_equal(
        tbv.torch_unpack(twords, 130).numpy(),
        np.asarray(jbv.jnp_unpack(jnp.asarray(words), 130)))
    assert tbv.torch_popcount(twords) == \
        int(jbv.jnp_popcount(jnp.asarray(words))) == int(bits.sum())
    assert np.array_equal(
        tbv.torch_and_many(twords).numpy(),
        np.asarray(jbv.jnp_and_many(jnp.asarray(words))))


@given(st.integers(0, 2**31), st.integers(0, 400))
@settings(max_examples=60, deadline=None)
def test_popcount_fallback_matches(seed, r):
    """numpy<2 path: the unpackbits fallback == np.bitwise_count path, in
    the port and in the JAX package, on arbitrary shapes (including empty
    and non-contiguous inputs)."""
    rng = np.random.default_rng(seed)
    bits = rng.random(r) < 0.3
    words = tbv.pack(bits)
    expected = int(bits.sum())
    assert tbv.popcount(words) == expected
    assert tbv._popcount_unpack(words) == expected == \
        jbv._popcount_unpack(words)
    # non-contiguous view (fallback must not assume contiguity)
    two = np.stack([words, words])
    assert tbv._popcount_unpack(two.T) == 2 * expected == \
        jbv._popcount_unpack(two.T)
