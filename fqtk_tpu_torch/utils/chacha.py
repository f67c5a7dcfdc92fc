"""ChaCha8 keystream RNG reproducing Rust's ``rand_chacha::ChaCha8Rng``.

The port's own copy of ``fqtk_tpu/utils/chacha.py`` (host code, no device library):
the two packages share no Python module.

The reference's ``subsample`` draws one ``f64`` per record set from
``ChaCha8Rng::seed_from_u64(seed)`` (``src/bin/commands/subsample.rs:200,232``).
To reproduce its keep/drop mask bit-for-bit when ``--seed`` is given, this
module implements:

- ``seed_from_u64``: rand_core's documented default — a PCG32 stream
  (MUL=6364136223846793005, INC=11634580027462260723, XSH-RR output) filling
  the 32-byte seed 4 bytes at a time, little-endian.
- ChaCha8 block function with rand_chacha's layout: constants | key(8 words) |
  64-bit block counter (words 12-13) | 64-bit stream id (words 14-15, zero
  for ``seed_from_u64``); 8 rounds; output = state + input, little-endian.
- ``next_u64`` = two consecutive u32 keystream words (lo | hi << 32).
- ``rand``'s ``StandardUniform`` f64: ``(next_u64 >> 11) * 2^-53``.

Everything is vectorized with NumPy: blocks are generated in large batches
(the column-parallel quarter-round maps well onto SIMD), so generating tens
of millions of draws is cheap on host.
"""

from __future__ import annotations

import numpy as np

_PCG_MUL = np.uint64(6364136223846793005)
_PCG_INC = np.uint64(11634580027462260723)
_U64_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)


def seed_from_u64(state: int) -> np.ndarray:
    """Expand a u64 into a 32-byte ChaCha seed (rand_core default impl):
    PCG32 (XSH-RR) outputs written 4 bytes at a time, little-endian."""
    s = state & 0xFFFFFFFFFFFFFFFF
    out = np.zeros(8, dtype=np.uint32)
    for i in range(8):
        s = (s * int(_PCG_MUL) + int(_PCG_INC)) & 0xFFFFFFFFFFFFFFFF
        xorshifted = (((s >> 18) ^ s) >> 27) & 0xFFFFFFFF
        rot = s >> 59
        x = ((xorshifted >> rot) | (xorshifted << (32 - rot))) & 0xFFFFFFFF if rot else xorshifted
        out[i] = x
    return out


def _rotl(x: np.ndarray, n: int) -> np.ndarray:
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def _quarter_round(s, a, b, c, d):
    s[a] += s[b]
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] += s[d]
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] += s[b]
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] += s[d]
    s[b] = _rotl(s[b] ^ s[c], 7)


def chacha_blocks(
    key_words: np.ndarray, counter0: int, n_blocks: int, rounds: int = 8, stream: int = 0
) -> np.ndarray:
    """Generate ``n_blocks`` consecutive 64-byte blocks as a [n_blocks, 16]
    uint32 array (keystream words in output order)."""
    const = np.array(
        [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32
    )
    counters = counter0 + np.arange(n_blocks, dtype=np.uint64)
    state = np.zeros((16, n_blocks), dtype=np.uint32)
    for i in range(4):
        state[i] = const[i]
    for i in range(8):
        state[4 + i] = key_words[i]
    state[12] = (counters & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    state[13] = (counters >> np.uint64(32)).astype(np.uint32)
    state[14] = np.uint32(stream & 0xFFFFFFFF)
    state[15] = np.uint32((stream >> 32) & 0xFFFFFFFF)

    working = state.copy()
    with np.errstate(over="ignore"):
        for _ in range(rounds // 2):
            _quarter_round(working, 0, 4, 8, 12)
            _quarter_round(working, 1, 5, 9, 13)
            _quarter_round(working, 2, 6, 10, 14)
            _quarter_round(working, 3, 7, 11, 15)
            _quarter_round(working, 0, 5, 10, 15)
            _quarter_round(working, 1, 6, 11, 12)
            _quarter_round(working, 2, 7, 8, 13)
            _quarter_round(working, 3, 4, 9, 14)
        working += state
    return working.T  # [n_blocks, 16]


class ChaCha8Rng:
    """Sequential u64 / f64 stream identical to ``rand_chacha::ChaCha8Rng``
    seeded via ``seed_from_u64`` (stream id 0)."""

    BATCH_BLOCKS = 4096  # words generated per refill (256 KiB)

    def __init__(self, seed: int):
        self._key = seed_from_u64(seed)
        self._counter = 0
        self._words: np.ndarray = np.empty(0, dtype=np.uint32)
        self._pos = 0

    def _refill(self) -> None:
        blocks = chacha_blocks(self._key, self._counter, self.BATCH_BLOCKS)
        self._counter += self.BATCH_BLOCKS
        self._words = blocks.reshape(-1)
        self._pos = 0

    def next_u64_batch(self, n: int) -> np.ndarray:
        """Return the next ``n`` u64 values as an array."""
        out = np.empty(n, dtype=np.uint64)
        filled = 0
        while filled < n:
            if self._pos >= len(self._words):
                self._refill()
            avail_words = len(self._words) - self._pos
            take = min(n - filled, avail_words // 2)
            if take == 0:
                # buffer exhausted (word counts are always even here, matching
                # rand's 64-word BlockRng buffer consumed in u64 pairs)
                self._refill()
                continue
            w = self._words[self._pos : self._pos + 2 * take]
            lo = w[0::2].astype(np.uint64)
            hi = w[1::2].astype(np.uint64)
            out[filled : filled + take] = lo | (hi << np.uint64(32))
            self._pos += 2 * take
            filled += take
        return out

    def next_u64(self) -> int:
        return int(self.next_u64_batch(1)[0])

    def random_f64_batch(self, n: int) -> np.ndarray:
        """rand 0.9 StandardUniform f64 samples: 53-bit multiply method."""
        u = self.next_u64_batch(n)
        return (u >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))

    def random_f64(self) -> float:
        return float(self.random_f64_batch(1)[0])
