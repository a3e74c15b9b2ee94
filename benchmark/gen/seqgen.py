"""Seeded nucleotide generators, vectorised with numpy.

Every generator takes a ``numpy.random.Generator`` and returns base codes
(uint8, 0..3 for A, C, G, T) so that the plain reference works on exactly
what the program is given; ``write_fasta`` turns codes into the file the
program reads.  The same seed gives the same codes, whatever the machine.

``gen_fasta`` and ``gen_amp_families`` are vectorised copies of the
generators of ``tools/bench_scale.py`` (uniform random sequences; amplicon
families of one base sequence and point variants); no cell uses them yet.
``taxon_tree`` builds the allpairs cell's sets of related amplicons.
``genus_reference`` and ``genus_reads`` build the search entry's
reference of genera and its samples of known and novel reads.
"""

from __future__ import annotations

import pathlib
from typing import Sequence, Tuple

import numpy as np

ALPHABET = np.frombuffer(b"ACGT", dtype=np.uint8)


def rng_for(seed: int, *salt: int) -> np.random.Generator:
    """A generator for one stream of one run: the run's seed (any whole
    number) and the stream's salt."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2 ** 64] + [int(s) for s in salt]))


def uniform(rng: np.random.Generator, n: int, length: int) -> np.ndarray:
    """n sequences of one length, each base uniform and independent."""
    return rng.integers(0, 4, size=(n, length), dtype=np.uint8)


def substitute(rng: np.random.Generator, codes: np.ndarray,
               count: int) -> np.ndarray:
    """A copy of codes (n, L) in which exactly ``count`` distinct positions
    of each row hold another base."""
    out = codes.copy()
    if count <= 0:
        return out
    n, length = out.shape
    keys = rng.random((n, length), dtype=np.float32)
    pos = np.argpartition(keys, count - 1, axis=1)[:, :count]
    rows = np.repeat(np.arange(n), count).reshape(n, count)
    shift = rng.integers(1, 4, size=(n, count), dtype=np.uint8)
    out[rows, pos] = (out[rows, pos] + shift) % 4
    return out


def gen_fasta(rng: np.random.Generator, n: int, length: int) -> np.ndarray:
    """tools/bench_scale.py gen_fasta: n uniform random sequences."""
    return uniform(rng, n, length)


def gen_amp_families(rng: np.random.Generator, nfam: int, per: int,
                     length: int) -> np.ndarray:
    """tools/bench_scale.py gen_amp_families: nfam random base sequences,
    each followed by ``per`` members; member 0 is the base, member m > 0
    has up to 9 positions (drawn with replacement) set to a random base.
    Returns (nfam * per, length)."""
    base = uniform(rng, nfam, length)
    out = np.repeat(base, per, axis=0)
    nsites = rng.integers(0, 10, size=nfam * per)
    nsites[::per] = 0
    pos = rng.integers(0, length, size=(nfam * per, 9))
    new = rng.integers(0, 4, size=(nfam * per, 9), dtype=np.uint8)
    live = np.arange(9)[None, :] < nsites[:, None]
    rows = np.broadcast_to(np.arange(nfam * per)[:, None], pos.shape)
    out[rows[live], pos[live]] = new[live]
    return out


def genus_reference(rng: np.random.Generator, genera: int, members: int,
                    length: int, member_subs: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(ancestors (genera, L), reference (genera * members, L)): each
    reference sequence is its genus ancestor with ``member_subs``
    substitutions; sequence g * members + k is member k of genus g."""
    ancestors = uniform(rng, genera, length)
    ref = substitute(rng, np.repeat(ancestors, members, axis=0), member_subs)
    return ancestors, ref


def genus_reads(rng: np.random.Generator, ancestors: np.ndarray,
                reference: np.ndarray, n_reads: int, novel: int,
                member_subs: int, read_subs: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(reads (n_reads, L), source (n_reads,)) in a random order.

    ``n_reads - novel`` known reads: a reference sequence, drawn uniformly,
    with ``read_subs`` substitutions; source is its index.  ``novel``
    novel reads: a new member of a genus drawn uniformly (its ancestor with
    ``member_subs`` substitutions, absent from the reference), with
    ``read_subs`` substitutions more; source is -1 - genus."""
    known = n_reads - novel
    src_known = rng.integers(0, reference.shape[0], size=known)
    genus = rng.integers(0, ancestors.shape[0], size=novel)
    fresh = substitute(rng, ancestors[genus], member_subs)
    reads = np.concatenate([reference[src_known], fresh])
    reads = substitute(rng, reads, read_subs)
    source = np.concatenate([src_known, -1 - genus])
    order = rng.permutation(n_reads)
    return reads[order], source[order]


def taxon_tree(rng: np.random.Generator, branching: Sequence[int],
               subs: Sequence[int], indels: Sequence[int], length: int,
               margin: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """(codes (n, length), clades (n, levels)) of the leaves of a tree, in
    a random order; n is the product of ``branching``.

    The root is ``length + margin`` uniform bases.  Going down a level,
    each node has ``branching[l]`` children; a child is its parent with a
    Poisson number, of mean ``subs[l]``, of substitutions at distinct
    positions, and then ``indels[l]`` indels, each an insertion or a
    deletion (even odds) of 1 to 3 bases at a uniform position.  A leaf is
    cut to its first ``length`` bases, as reads are cut to a fixed length;
    ``margin`` has to exceed 3 x sum(indels).  ``clades[i, l]`` numbers leaf
    i's node at level l, so two leaves share their clades down to the
    level of their last common ancestor."""
    if margin <= 3 * sum(int(d) for d in indels):
        raise ValueError("margin too small for the indels")
    nodes = [uniform(rng, 1, length + margin)[0]]
    for b, s, d in zip(branching, subs, indels):
        children = []
        for parent in nodes:
            for _ in range(int(b)):
                c = substitute(rng, parent[None, :],
                               min(int(rng.poisson(s)), parent.size))[0]
                for _ in range(int(d)):
                    at = int(rng.integers(0, c.size))
                    n = int(rng.integers(1, 4))
                    if rng.random() < 0.5:
                        c = np.delete(c, np.arange(at, min(at + n, c.size)))
                    else:
                        c = np.insert(c, at, rng.integers(
                            0, 4, size=n, dtype=np.uint8))
                children.append(c)
        nodes = children
    codes = np.stack([c[:length] for c in nodes])
    n = codes.shape[0]
    widths = np.cumprod(np.asarray(branching, dtype=np.int64))
    clades = np.arange(n)[:, None] // (n // widths)[None, :]
    order = rng.permutation(n)
    return codes[order], clades[order]


def fasta_bytes(labels: Sequence[bytes], codes: np.ndarray) -> bytes:
    """FASTA text, one line of sequence a record."""
    letters = ALPHABET[codes]
    return b"".join(b">%s\n%s\n" % (label, row.tobytes())
                    for label, row in zip(labels, letters))


def write_fasta(path: pathlib.Path, prefix: str, codes: np.ndarray) -> None:
    """Write codes as FASTA records labelled prefix0, prefix1, ..."""
    pre = prefix.encode()
    labels = [pre + b"%d" % i for i in range(codes.shape[0])]
    pathlib.Path(path).write_bytes(fasta_bytes(labels, codes))
