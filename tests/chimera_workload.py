"""The seeded chimera workload of the port's chimera tests and of
chip_smoke.py's chimera parity phase (numpy only, so that both can import
it)."""

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _mutate(rng, seq, n):
    s = seq.copy()
    pos = rng.integers(0, s.size, size=n)
    s[pos] = ACGT[rng.integers(0, 4, size=n)]
    return s


def write_chimera_workload(path, seed=12, parents=70, copies=10,
                           chimeras=30):
    """Random parents of 100-124 nt (sizes 100-500, within the plain K2's
    128 bucket; every tenth a close relative of the one before); mutated
    copies of them (1-4 substitutions, size 1, so that no copy passes the
    abundance gate as another's parent and the same-round repair aligns
    few pairs); two-parent chimeras (the left part of one parent at a
    random breakpoint, the right part of another, 0-2 substitutions,
    sizes 1-5), a third of them between a parent and a close relative of
    it, whose few differences can make them borderline under
    --uchime_denovo.  800 sequences at the defaults.  Returns the
    parents."""
    rng = np.random.default_rng(seed)
    par = []
    for p in range(parents):
        if p % 10 == 9:
            # a close relative of the previous parent
            par.append(_mutate(rng, par[-1], 6))
        else:
            par.append(ACGT[rng.integers(0, 4, size=rng.integers(100, 125))])
    recs = []
    for p, s in enumerate(par):
        recs.append((b"p%d" % p, int(rng.integers(100, 501)), s))
        for c in range(copies):
            recs.append((b"m%d_%d" % (p, c), 1,
                         _mutate(rng, s, int(rng.integers(1, 5)))))
    for c in range(chimeras):
        a = int(rng.integers(0, parents))
        b = (a - 1 if a % 10 == 9 else a + 1) if c % 3 == 0 \
            else int(rng.integers(0, parents))
        if b == a or b >= parents:
            b = (a + 5) % parents
        brk = int(rng.integers(20, 100))
        s = np.concatenate([par[a][:brk], par[b][brk:]])
        recs.append((b"c%d_%d_%d" % (c, a, b), int(rng.integers(1, 6)),
                     _mutate(rng, s, int(rng.integers(0, 3)))))
    order = rng.permutation(len(recs))
    with open(path, "wb") as fh:
        for i in order:
            name, size, s = recs[i]
            fh.write(b">%s;size=%d\n%s\n" % (name, size, s.tobytes()))
    return par


def write_ref_workload(workdir, seed=13):
    """The de novo workload (workdir/denovo.fa) and, for uchime_ref, its
    chimeras and some of its parents' copies as queries and a DB of its
    parents padded with unrelated random sequences to 520, so that the
    static index reaches K1 (512 and up).  Returns the three paths
    (de novo, queries, DB)."""
    fa = workdir / "denovo.fa"
    par = write_chimera_workload(fa)
    rng = np.random.default_rng(seed)
    recs = open(fa, "rb").read().split(b"\n")
    q = workdir / "ref_q.fa"
    with open(q, "wb") as fh:
        for head, seq in zip(recs[0::2], recs[1::2]):
            if head.startswith((b">c", b">m")) and (
                    head.startswith(b">c") or rng.random() < 0.08):
                fh.write(head + b"\n" + seq + b"\n")
    db = workdir / "ref_db.fa"
    with open(db, "wb") as fh:
        for p, s in enumerate(par):
            fh.write(b">p%d\n%s\n" % (p, s.tobytes()))
        for i in range(520 - len(par)):
            s = ACGT[rng.integers(0, 4, size=rng.integers(100, 125))]
            fh.write(b">r%d\n%s\n" % (i, s.tobytes()))
    return fa, q, db
