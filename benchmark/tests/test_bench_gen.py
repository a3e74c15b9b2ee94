"""The generators repeat exactly for a seed and give the stated
identities and shared word counts."""

import numpy as np
import pytest

from benchmark.gen import seqgen


def _shared_words(a, b, k=8):
    def words(x):
        w = np.zeros(x.size - k + 1, dtype=np.int64)
        for t in range(k):
            w = w * 4 + x[t:x.size - k + 1 + t]
        return set(w.tolist())
    return len(words(a) & words(b))


@pytest.mark.parametrize("seed", [0, 17, 2 ** 31 + 5, 3 * 2 ** 40])
def test_same_seed_same_codes(seed):
    def make(s):
        rng = seqgen.rng_for(s, 1, 0)
        a = seqgen.gen_fasta(rng, 20, 50)
        anc, ref = seqgen.genus_reference(rng, 4, 8, 100, 3)
        reads, src = seqgen.genus_reads(rng, anc, ref, 30, 10, 3, 1)
        fam = seqgen.gen_amp_families(rng, 5, 4, 80)
        tree, clades = seqgen.taxon_tree(rng, [2, 3, 2], [4, 2, 1],
                                         [1, 1, 0], 90)
        return a, anc, ref, reads, src, fam, tree, clades
    first, second, other = make(seed), make(seed), make(seed + 1)
    for x, y in zip(first, second):
        assert np.array_equal(x, y)
    assert not np.array_equal(first[0], other[0])


def test_substitute_changes_exactly_count():
    rng = seqgen.rng_for(5)
    codes = seqgen.uniform(rng, 200, 600)
    out = seqgen.substitute(rng, codes, 18)
    assert ((out != codes).sum(axis=1) == 18).all()
    assert out.max() <= 3


def test_genus_reads_identities_and_shared_words():
    rng = seqgen.rng_for(11)
    L, members, msubs, rsubs = 600, 32, 18, 6
    anc, ref = seqgen.genus_reference(rng, 6, members, L, msubs)
    assert ((ref != np.repeat(anc, members, axis=0)).sum(axis=1)
            == msubs).all()
    reads, src = seqgen.genus_reads(rng, anc, ref, 200, 100, msubs, rsubs)
    known = src >= 0
    assert known.sum() == 100
    # a known read is its source with read_subs substitutions: 0.99
    d = (reads[known] != ref[src[known]]).sum(axis=1)
    assert (d == rsubs).all()
    # a novel read lies about 7 % from each genus mate: below 0.97
    for r, s in zip(reads[~known][:20], src[~known][:20]):
        g = -1 - s
        mates = ref[g * members:(g + 1) * members]
        ident = 1 - (mates != r).sum(axis=1) / L
        assert (ident < 0.96).all() and (ident > 0.90).all()
        shared = [_shared_words(r, m) for m in mates[:4]]
        assert all(250 <= x <= 420 for x in shared), shared
        other = ref[((g + 1) % 6) * members]
        assert _shared_words(r, other) < 40
    # a known read loses at most 8 words a substitution against its source
    for r, s in zip(reads[known][:20], src[known][:20]):
        assert _shared_words(r, ref[s]) >= _shared_words(r, r) - 8 * rsubs


def test_amp_families_members_near_base():
    rng = seqgen.rng_for(2)
    fam = seqgen.gen_amp_families(rng, 10, 4, 100)
    base = fam[::4]
    assert fam.shape == (40, 100)
    d = (fam != np.repeat(base, 4, axis=0)).sum(axis=1)
    assert (d[::4] == 0).all() and d.max() <= 9


def test_taxon_tree_shape_and_clades():
    rng = seqgen.rng_for(4)
    codes, clades = seqgen.taxon_tree(rng, [4, 2, 3], [20, 6, 2],
                                      [2, 1, 0], 200)
    assert codes.shape == (24, 200) and clades.shape == (24, 3)
    assert codes.max() <= 3
    # clades nest: leaves sharing a level's clade share every level above
    for lv in range(1, 3):
        for c in np.unique(clades[:, lv]):
            assert np.unique(clades[clades[:, lv] == c, lv - 1]).size == 1
    assert [np.unique(clades[:, lv]).size for lv in range(3)] == [4, 8, 24]
    with pytest.raises(ValueError):
        seqgen.taxon_tree(rng, [2], [1], [20], 50)


def test_taxon_tree_identities_by_rank():
    """The allpairs config's tree: two leaves whose last common ancestor
    sits at a rank align at about Yarza et al.'s identity threshold of the
    rank below (the plain reference's alignment, --iddef 2)."""
    import torch
    from benchmark.harness import loader
    from benchmark.reference import nwalign
    torch.set_num_threads(2)
    gen = loader.config("allpairs_v34")["generator"]
    codes, clades = seqgen.taxon_tree(seqgen.rng_for(777, 1, 0),
                                      gen["branching"], gen["subs"],
                                      gen["indels"], gen["length"])
    rng = np.random.default_rng(1)
    n = codes.shape[0]
    qs, ts, level = [], [], []
    for lv in range(len(gen["branching"])):
        got = 0
        while got < 12:
            a, b = rng.integers(0, n, 2)
            if a != b and (clades[a] == clades[b]).sum() == lv:
                qs.append(codes[a])
                ts.append(codes[b])
                level.append(lv)
                got += 1
    ids = np.array([nwalign.hit_fields(x).identity for x in
                    nwalign.align_codes(nwalign.Scheme(), qs, ts, "cpu")])
    level = np.array(level)
    want = [75.0, 78.5, 82.0, 86.5, 94.5, 98.65, 99.5]
    for lv, w in enumerate(want):
        assert abs(ids[level == lv].mean() - w) < 1.5, (lv, ids[level == lv])


def test_fasta_bytes():
    codes = np.array([[0, 1, 2, 3], [3, 3, 0, 0]], dtype=np.uint8)
    assert seqgen.fasta_bytes([b"a", b"b"], codes) == b">a\nACGT\n>b\nTTAA\n"
