"""Cross-platform reproducible RNG matching the reference exactly.

reference: src/utils/random.{hpp,cpp} — SplitMix64, std::mt19937_64 (the
standard-specified 64-bit Mersenne twister), Lemire's random_bounded, and a
portable Fisher-Yates shuffle.  Bit-identical sequences for a given
--randseed are part of the output-parity contract (shuffle/subsample/sintax).
"""

from __future__ import annotations

import os
from typing import List

MASK64 = (1 << 64) - 1


class SplitMix64:
    """reference: random.cpp:69-76"""

    def __init__(self, seed: int) -> None:
        self.state = seed & MASK64

    def next(self) -> int:
        self.state = (self.state + 0x9E3779B97F4A7C15) & MASK64
        z = self.state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & MASK64
        return (z ^ (z >> 31)) & MASK64

    __call__ = next

    def next_block(self, k: int):
        """k draws at once (bit-identical to k next() calls); the mix is
        stateless over state + i*GOLDEN so it vectorizes exactly."""
        import numpy as np
        i = np.arange(1, k + 1, dtype=np.uint64)
        with np.errstate(over="ignore"):
            z = (np.uint64(self.state)
                 + i * np.uint64(0x9E3779B97F4A7C15))
            self.state = int(z[-1])
            z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
            z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
            return z ^ (z >> np.uint64(31))


class MT19937_64:
    """std::mt19937_64 with the standard seeding and sequence."""

    N = 312
    M = 156
    MATRIX_A = 0xB5026F5AA96619E9
    UPPER = 0xFFFFFFFF80000000
    LOWER = 0x7FFFFFFF

    def __init__(self, seed: int) -> None:
        mt = [0] * self.N
        mt[0] = seed & MASK64
        for i in range(1, self.N):
            mt[i] = (6364136223846793005 * (mt[i - 1] ^ (mt[i - 1] >> 62))
                     + i) & MASK64
        self.mt = mt
        self.index = self.N

    def _twist(self) -> None:
        mt = self.mt
        for i in range(self.N):
            x = (mt[i] & self.UPPER) | (mt[(i + 1) % self.N] & self.LOWER)
            xa = x >> 1
            if x & 1:
                xa ^= self.MATRIX_A
            mt[i] = mt[(i + self.M) % self.N] ^ xa
        self.index = 0

    def next(self) -> int:
        if self.index >= self.N:
            self._twist()
        x = self.mt[self.index]
        self.index += 1
        x ^= (x >> 29) & 0x5555555555555555
        x ^= (x << 17) & 0x71D67FFFEDA60000
        x ^= (x << 37) & 0xFFF7EEE000000000
        x ^= x >> 43
        return x & MASK64

    __call__ = next


def random_substream_seed(base: int, index: int) -> int:
    """reference: random.cpp:85-91"""
    return SplitMix64((base ^ (index * 0x9E3779B97F4A7C15)) & MASK64).next()


def random_base_seed(params) -> int:
    """reference: random.cpp random_init (:94-108)."""
    if params.opt_randseed != 0:
        return params.opt_randseed & MASK64
    return int.from_bytes(os.urandom(8), "little")


def random_bounded(generator, range_: int) -> int:
    """Lemire multiply-shift with rejection (random.hpp:113-137)."""
    if range_ == 0:
        raise ValueError("random_bounded() called with range 0")
    product = generator() * range_
    low = product & MASK64
    if low < range_:
        threshold = ((1 << 64) - range_) % range_
        while low < threshold:
            product = generator() * range_
            low = product & MASK64
    return product >> 64


def random_bounded_block(rng: "SplitMix64", k: int, range_: int):
    """k sequential random_bounded(rng, range_) draws, vectorized.

    Bit-identical to the scalar sequence: Lemire rejections are detected
    (probability range_/2**64 per draw) and the whole block replays
    scalar from the saved state in that case."""
    import numpy as np
    if range_ <= 0 or range_ > 0xFFFFFFFF:
        return np.array([random_bounded(rng, range_) for _ in range(k)],
                        dtype=np.int64)
    state0 = rng.state
    x = rng.next_block(k)
    n = np.uint64(range_)
    with np.errstate(over="ignore"):
        low = x * n                       # (x * n) mod 2**64
        if bool((low < n).any()):         # rejection path: replay scalar
            rng.state = state0
            return np.array([random_bounded(rng, range_)
                             for _ in range(k)], dtype=np.int64)
        # mulhi64(x, n) with n < 2**32
        x_hi = x >> np.uint64(32)
        x_lo = x & np.uint64(0xFFFFFFFF)
        hi = (x_hi * n + ((x_lo * n) >> np.uint64(32))) >> np.uint64(32)
    return hi.astype(np.int64)


def random_shuffle(data: List, generator) -> None:
    """Portable Fisher-Yates (random.hpp:140-149)."""
    for i in range(len(data), 1, -1):
        j = random_bounded(generator, i)
        data[i - 1], data[j] = data[j], data[i - 1]
