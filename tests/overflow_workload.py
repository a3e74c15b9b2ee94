"""A seeded workload for the scoring scheme --match 1 --mismatch 100,
whose alignments of 400 nt and more pass the 16-bit engine's SHRT_MAX:
tests/test_torch_overflow.py runs it through both packages on the CPU,
chip_smoke.py's phase 3 through the port on cuda and on cpu, both with
count_overflow's counters.  Imports neither jax nor vsearch_tpu.

Three families, each a random ancestor of 440-520 nt, two copies at about
3 % substitutions and the ancestor's complete substitution (every base
changed: a near-all-mismatch pair with the ancestor).  The search DB holds
the families and random sequences up to 520 entries (so that the port
scores on its device index, K1, and aligns each query's top-1 candidate
in the prefetch, K2 + K3); its queries are a copy at about 4 % of each
ancestor, each ancestor with every base after its first 64 substituted
(it shares the first 64 with its ancestor, so the ancestor is a
candidate), and two random sequences.  The allpairs set holds the
ancestors, their substitutions and ten random sequences of 150-250 nt,
whose pairs stay inside 16 bits: 16 sequences, the fewest that take the
port's allpairs stats pipeline.  An overflowing pair costs the exact
linear-memory realignment, about a second each on the host, so the sets
are small.
"""

import numpy as np

ARGS = ["--match", "1", "--mismatch", "100"]
ALPHABET = np.frombuffer(b"ACGT", dtype=np.uint8)


def _substitute_all(rng, codes):
    """Every base changed to one of the three others."""
    return (codes + rng.integers(1, 4, size=codes.shape)) % 4


def _mutate(rng, codes, rate):
    out = codes.copy()
    pos = rng.choice(len(out), size=int(len(out) * rate), replace=False)
    out[pos] = _substitute_all(rng, out[pos])
    return out


def write_overflow_workload(d, families=3, db_n=520, seed=101):
    """(db, queries, allpairs) FASTA paths under directory d."""
    rng = np.random.default_rng(seed)
    db, queries, ap = [], [], []
    for f in range(families):
        anc = rng.integers(0, 4, size=int(rng.integers(440, 521)))
        anti = _substitute_all(rng, anc)
        db += [("f%d" % f, anc), ("f%d.a" % f, _mutate(rng, anc, 0.03)),
               ("f%d.b" % f, _mutate(rng, anc, 0.03)), ("f%d.sub" % f, anti)]
        tail = anc.copy()
        tail[64:] = _substitute_all(rng, anc[64:])
        copy = _mutate(rng, anc, 0.04)
        queries += [("q%d.copy" % f, copy), ("q%d.tail" % f, tail)]
        ap += [("f%d" % f, anc), ("f%d.sub" % f, anti)]
    for i in range(db_n - len(db)):
        db.append(("r%d" % i, rng.integers(0, 4, size=int(
            rng.integers(420, 521)))))
    for i in range(2):
        queries.append(("q.rand%d" % i, rng.integers(0, 4, size=480)))
    for i in range(10):
        ap.append(("short%d" % i, rng.integers(0, 4, size=int(
            rng.integers(150, 251)))))
    paths = []
    for name, recs in (("ovf_db", db), ("ovf_q", queries), ("ovf_ap", ap)):
        path = d / (name + ".fasta")
        path.write_bytes(b"".join(b">%s\n%s\n" % (h.encode(),
                                                   ALPHABET[c].tobytes())
                                  for h, c in recs))
        paths.append(path)
    return tuple(paths)


def count_overflow():
    """Patches the port to count the SHRT_MAX sentinels (overflowing
    pairs) among the batched aligner's results (BatchAligner.
    align_pairs_end, which align_pairs and the allpairs realign's second
    half both end in) and the pairs the allpairs pipeline
    (AllPairsDevice.run) flags as overflowing.  Returns (counts, undo): a
    dict the patched calls add to, and the function that restores the
    originals."""
    from vsearch_tpu_torch.ops.allpairs_dev import AllPairsDevice
    from vsearch_tpu_torch.ops.nw import SHRT_MAX
    from vsearch_tpu_torch.ops.nw_batch import BatchAligner
    seen = {"aligner_sentinels": 0, "allpairs_overflow": 0}
    align, run = BatchAligner.align_pairs_end, AllPairsDevice.run

    def counted_align(self, handle):
        out = align(self, handle)
        seen["aligner_sentinels"] += sum(r.score == SHRT_MAX for r in out)
        return out

    def counted_run(self, qpos, tpos):
        over, stats = run(self, qpos, tpos)
        seen["allpairs_overflow"] += int(over.sum())
        return over, stats

    def undo():
        BatchAligner.align_pairs_end, AllPairsDevice.run = align, run

    BatchAligner.align_pairs_end, AllPairsDevice.run = (counted_align,
                                                        counted_run)
    return seen, undo
