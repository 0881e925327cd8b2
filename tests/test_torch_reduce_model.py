"""Kernel C (``csrc/bitvector_reduce.cu``) as a numpy model, held to the
JAX package and to the port's plain version, bit for bit.

The CUDA kernel cannot run here.  Its algorithm is modelled word by word
in numpy instead, on a flat uint32 "device memory" whose word 0 is
16-byte aligned and whose rows start at word ``base`` (0-3):

* the route: 16-byte loads when every row shares the base's alignment
  (P == 1 or W % 4 == 0), each uint4 load asserted aligned, after a
  scalar head of 0-3 words up to row 0's first 16-byte boundary and
  before a scalar tail of 0-3 words (block 0's threads 0-3 and 4-7);
  otherwise four scalar words a thread, a block's width apart;
* the grid: the wrapper's block size (the kernel reads it from its
  launch), grid-stride steps, a block's count as warp sums then one sum,
  stored once; one block stores the count
  itself, several store one partial each after the count word and a
  second launch sums them;
* the output: one ``uint32[2W + 1]`` buffer [AND | OR | count] (partials
  after it), every word written exactly once, every load inside the
  rows.

The model, the port's plain versions (``bitvector_ops`` on a CPU tensor,
``ops.reduce_bitvectors(..., backend="torch")``, given the row slice at
that base) and the JAX package (``reduce_bitvectors`` under
``pallas_interpret`` and ``xla``) must agree exactly: they are bits and
integers.  The CUDA kernel is held against the plain version on the card
by ``chip_smoke.py`` at the same kinds of shapes.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so parallel test workers share cores
torch.set_num_threads(1)

from repro.kernels import ops as j_ops  # noqa: E402
from repro_torch.kernels import bitvector_ops, ops  # noqa: E402

H100_SMS = 132
ONE = bitvector_ops.ONE_BLOCK_WORDS
WIDTHS = (1, 3, 4, 5, 127, 128, 129, 256, 257, ONE - 1, ONE, ONE + 1,
          100_003)


def model_reduce(mem: np.ndarray, base: int, P: int, W: int, blocks: int,
                 threads: int = bitvector_ops.THREADS) -> np.ndarray:
    """The kernel's output buffer for rows ``mem[base:base + P*W]``
    (row-major ``uint32[P, W]``) under a grid of ``blocks`` blocks of
    ``threads`` threads."""
    vec = P == 1 or W % 4 == 0
    head = min((-base) % 4, W) if vec else 0
    out = np.zeros(2 * W + 1 + (blocks if blocks > 1 else 0), np.uint32)
    writes = np.zeros(out.shape, np.int64)
    bits = np.zeros((blocks, threads), np.uint64)
    t = np.arange(threads)

    def load(idx):
        assert np.all((idx >= base) & (idx < base + P * W)), "read past rows"
        return mem[idx]

    def store(idx, v):
        out[idx] = v
        np.add.at(writes, idx, 1)

    def reduce(idx):              # idx: word index in row 0 (any shape)
        v = np.stack([load(idx + p * W) for p in range(P)])
        return np.bitwise_and.reduce(v, 0), np.bitwise_or.reduce(v, 0)

    for b in range(blocks):
        if vec:
            nvec = (W - head) >> 2
            c = b * threads + t
            while np.any(c < nvec):
                live = c < nvec
                w0 = head + 4 * c[live]               # first word of the uint4
                for p in range(P):                    # 16-byte aligned loads
                    assert np.all((base + p * W + w0) % 4 == 0)
                a, o = reduce(base + w0[:, None] + np.arange(4))
                store(w0[:, None] + np.arange(4), a)
                store(W + w0[:, None] + np.arange(4), o)
                bits[b, t[live]] += np.bitwise_count(a).sum(1)
                c = c + blocks * threads
            if b == 0:                                # head, then tail
                tail = head + 4 * nvec
                for lane, w in [(i, i) for i in range(head)] + \
                        [(4 + i, tail + i) for i in range(W - tail)]:
                    assert lane < 8
                    a, o = reduce(np.array([base + w]))
                    store(np.array([w]), a)
                    store(np.array([W + w]), o)
                    bits[0, lane] += np.bitwise_count(a).sum()
        else:
            s = b * 4 * threads
            while s < W:
                for j in range(4):
                    w = s + t + j * threads
                    live = w < W
                    a, o = reduce(base + w[live])
                    store(w[live], a)
                    store(W + w[live], o)
                    bits[b, t[live]] += np.bitwise_count(a)
                s += blocks * 4 * threads
        warp = bits[b].reshape(threads // 32, 32).sum(1) % 2**32
        store(np.array([2 * W + (1 + b if blocks > 1 else 0)]),
              warp.sum() % 2**32)
    if blocks > 1:                                    # the second launch
        store(np.array([2 * W]), out[2 * W + 1:].astype(np.uint64).sum()
              % 2**32)
    assert np.all(writes == 1), "an output word written other than once"
    return out


def _memory(rng, base, P, W, fill=None):
    """Device memory: ``base`` junk words, the rows, 5 junk words."""
    mem = rng.integers(0, 2**32, base + P * W + 5,
                       dtype=np.uint64).astype(np.uint32)
    if fill is not None:
        mem[base:base + P * W] = fill
    return mem


@functools.cache
def _jax(P, W, fill):
    """The JAX package's results under both backends, per input."""
    mem = _memory(np.random.default_rng(P * 1_000_003 + W), 0, P, W, fill)
    rows = mem[:P * W].reshape(P, W)
    return rows, [j_ops.reduce_bitvectors(rows, backend=b)
                  for b in ("xla", "pallas_interpret")]


def _hold(rows, base, wants):
    """Model (one block where the wrapper launches one, the H100's grid,
    three blocks) and the plain versions at ``base`` against the JAX
    package's results."""
    P, W = rows.shape
    mem = _memory(np.random.default_rng(base), base, P, W)
    mem[base:base + P * W] = rows.reshape(-1)
    grids = {bitvector_ops.grid_blocks(W, H100_SMS), 3}
    t = torch.from_numpy(mem)[base:base + P * W].view(P, W)  # a row slice
    assert t.data_ptr() % 16 == 4 * base
    plain = bitvector_ops.bitvector_reduce_buffer(t).numpy()
    got = [bitvector_ops.split(model_reduce(mem, base, P, W, g), W)
           for g in grids]
    got += [bitvector_ops.split(plain, W),
            ops.reduce_bitvectors(t, backend="torch")]
    for a, o, c in got:
        for wa, wo, wc in wants:
            assert np.array_equal(a, wa) and np.array_equal(o, wo)
            assert c == wc


@pytest.mark.parametrize("base", range(4))
@pytest.mark.parametrize("W", WIDTHS)
@pytest.mark.parametrize("P", (1, 2, 12))
def test_model_and_plain_match_jax(P, W, base):
    rows, wants = _jax(P, W, None)
    _hold(rows, base, wants)


@pytest.mark.parametrize("W", (1, 129, ONE + 1, 100_003))
@pytest.mark.parametrize("fill", (0, 0xFFFFFFFF))
def test_uniform_rows_match_jax(fill, W):
    for P, base in ((1, 3), (2, 1), (12, 2)):
        rows, wants = _jax(P, W, fill)
        _hold(rows, base, wants)
        assert wants[0][2] == (W * 32 if fill else 0)


def test_routes_cover_the_cases():
    """Each route of the model is taken: the vector body with head and
    tail, the scalar route, one block and the grid of blocks."""
    assert bitvector_ops.grid_blocks(ONE, H100_SMS) == 1
    assert bitvector_ops.grid_blocks(ONE + 1, H100_SMS) == 9
    assert bitvector_ops.grid_blocks(100_003, H100_SMS) == 98
    assert bitvector_ops.grid_blocks(2_097_152, H100_SMS) == 2 * H100_SMS
    # P == 1 at an odd W and base 3: 1 head word, the body, 2 tail words
    mem = _memory(np.random.default_rng(0), 3, 1, 11)
    out = model_reduce(mem, 3, 1, 11, 1)
    rows = mem[3:14]
    assert np.array_equal(out[:11], rows) and np.array_equal(out[11:22], rows)
    assert out[22] == np.bitwise_count(rows).sum()


def test_buffer_layout_and_wrapper_on_the_cpu():
    """[AND | OR | count] on the CPU: the plain version packed as the
    kernel lays it out, split into views; the count is int32 bits."""
    rows = np.array([[0xFFFFFFFF, 0x0F0F0F0F, 1], [0xFFFFFFFF, 0xFF, 3]],
                    np.uint32)
    buf = bitvector_ops.bitvector_reduce_buffer(torch.from_numpy(rows))
    assert buf.dtype == torch.uint32 and buf.shape == (7,)
    want = [0xFFFFFFFF, 0x0F, 1, 0xFFFFFFFF, 0x0F0F0FFF, 3, 32 + 4 + 1]
    assert buf.numpy().tolist() == want
    a, o, c = bitvector_ops.split(buf, 3)
    assert c.dtype == torch.int32 and c.dim() == 0 and int(c) == 37
    assert a.numpy().tolist() == want[:3] and o.numpy().tolist() == want[3:6]
    a, o, c = bitvector_ops.split(buf.numpy(), 3)
    assert isinstance(c, int) and c == 37 and o.tolist() == want[3:6]
    before = bitvector_ops.launches
    for fn in (bitvector_ops.bitvector_reduce,
               bitvector_ops.bitvector_reduce_buffer):
        with pytest.raises(ValueError):
            fn(torch.zeros((0, 3), dtype=torch.uint32))
        with pytest.raises(ValueError):
            fn(torch.zeros((3,), dtype=torch.uint32))
    assert bitvector_ops.launches == before
    empty = bitvector_ops.bitvector_reduce_buffer(
        torch.zeros((2, 0), dtype=torch.uint32))
    assert empty.numpy().tolist() == [0]


@pytest.mark.parametrize("threads", (32, 128))
def test_model_at_other_block_sizes(threads):
    """The kernel takes its block size from the launch (whole warps, at
    most 256): at other sizes it still reduces every word once."""
    for P, W, base in ((1, 11, 3), (2, 257, 1), (12, 4 * threads + 5, 2)):
        rows, wants = _jax(P, W, None)
        mem = _memory(np.random.default_rng(base), base, P, W)
        mem[base:base + P * W] = rows.reshape(-1)
        for blocks in (1, 3):
            a, o, c = bitvector_ops.split(
                model_reduce(mem, base, P, W, blocks, threads), W)
            for wa, wo, wc in wants:
                assert np.array_equal(a, wa) and np.array_equal(o, wo)
                assert c == wc
