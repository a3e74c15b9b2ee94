"""The seeded amplicon workload of the port's pipeline test and of
chip_smoke.py's pipeline parity phase (numpy only, so that both can import
it): paired-end reads of a few amplicons from several samples, a taxonomy
database for them, and the chain of verbs that takes the reads to an OTU
table and a classification."""

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")
SAMPLES = 4


def _revcomp(seq: bytes) -> bytes:
    return seq.translate(COMP)[::-1]


def _mutate(rng, seq, n):
    s = seq.copy()
    pos = rng.integers(0, s.size, size=n)
    s[pos] = ACGT[rng.integers(0, 4, size=n)]
    return s


def _read(rng, seq: bytes, error_rate: float):
    """One read of seq: Phred 28-41 (Illumina 1.8 offset 33) on every base,
    a substitution at error_rate a base, each with Phred 5-14."""
    arr = np.frombuffer(seq, dtype=np.uint8).copy()
    qual = rng.integers(28, 42, size=arr.size)
    err = rng.random(arr.size) < error_rate
    n = int(err.sum())
    arr[err] = ACGT[(np.searchsorted(ACGT, arr[err])
                     + rng.integers(1, 4, size=n)) % 4]
    qual[err] = rng.integers(5, 15, size=n)
    return arr.tobytes(), (qual + 33).astype(np.uint8).tobytes()


def write_amplicon_workload(workdir, pairs=4000, seed=31, templates=14,
                            chimeras=2, readlen=150, error_rate=0.002):
    """Amplicons of 240-260 nt: `templates` random ones (every fourth a
    close relative of the one before, 3 substitutions) drawn with weights
    1/(i+1), and `chimeras` two-parent chimeras of the two most abundant
    ones (in turn left and right parent) at an eightieth of the first one's
    weight.  Each pair is one amplicon read from both ends (`readlen` nt, an overlap of 40-60 nt), labelled
    s<k>.<i> for one of SAMPLES samples.  The taxonomy database holds
    three copies of every template (1-3 substitutions) with a seven-rank
    tax annotation, and 20 unrelated sequences.  Writes fwd.fq, rev.fq and
    taxdb.fa into workdir and returns the three paths."""
    rng = np.random.default_rng(seed)
    amps = []
    for t in range(templates):
        if t % 4 == 3:
            amps.append(_mutate(rng, amps[-1], 3))
        else:
            amps.append(ACGT[rng.integers(0, 4,
                                          size=int(rng.integers(240, 261)))])
    weights = [1.0 / (t + 1) for t in range(templates)]
    for c in range(chimeras):
        a, b = (amps[0], amps[1]) if c % 2 == 0 else (amps[1], amps[0])
        brk = int(rng.integers(80, 170))
        amps.append(np.concatenate([a[:brk], b[brk:]]))
        weights.append(weights[0] / 80)
    p = np.asarray(weights) / sum(weights)
    pick = rng.choice(len(amps), size=pairs, p=p)
    sample = rng.integers(1, SAMPLES + 1, size=pairs)
    fwd, rev = workdir / "fwd.fq", workdir / "rev.fq"
    with open(fwd, "wb") as ff, open(rev, "wb") as fr:
        for i in range(pairs):
            amp = amps[pick[i]].tobytes()
            head = b"s%d.%d" % (sample[i], i)
            s, q = _read(rng, amp[:readlen], error_rate)
            ff.write(b"@%s\n%s\n+\n%s\n" % (head, s, q))
            s, q = _read(rng, _revcomp(amp[-readlen:]), error_rate)
            fr.write(b"@%s\n%s\n+\n%s\n" % (head, s, q))
    taxdb = workdir / "taxdb.fa"
    with open(taxdb, "wb") as fh:
        for t in range(templates):
            tax = (b"d:Bacteria,p:P%d,c:C%d,o:O%d,f:F%d,g:G%d,s:S%d"
                   % (t % 2, t % 3, t % 4, t % 5, t // 4, t))
            for k in range(3):
                s = _mutate(rng, amps[t], int(rng.integers(1, 4)))
                fh.write(b">t%d_%d;tax=%s;\n%s\n" % (t, k, tax, s.tobytes()))
        for r in range(20):
            s = ACGT[rng.integers(0, 4, size=int(rng.integers(240, 261)))]
            fh.write(b">u%d;tax=d:Archaea,p:PA,g:GA%d;\n%s\n"
                     % (r, r, s.tobytes()))
    return fwd, rev, taxdb


def pipeline_steps(fwd, rev, taxdb):
    """The amplicon workflow, each step's outputs (relative to the working
    directory) feeding the next: merge the pairs, filter at an expected
    error of 1, dereplicate, denoise, remove chimeras, map the merged
    reads to the ZOTUs for an OTU table, and classify the ZOTUs.  Returns
    [(name, argv, outputs)]."""
    return [
        ("mergepairs", ["--fastq_mergepairs", str(fwd), "--reverse",
                        str(rev), "--fastqout", "merged.fq",
                        "--eetabbedout", "merged.ee"],
         ["merged.fq", "merged.ee"]),
        ("filter", ["--fastq_filter", "merged.fq", "--fastq_maxee", "1",
                    "--fastaout", "filtered.fa"],
         ["filtered.fa"]),
        ("uniques", ["--fastx_uniques", "filtered.fa", "--sizeout",
                     "--relabel", "Uniq", "--fastaout", "uniques.fa",
                     "--minseqlength", "1"],
         ["uniques.fa"]),
        ("unoise", ["--cluster_unoise", "uniques.fa", "--sizein",
                    "--sizeout", "--relabel", "Zotu", "--centroids",
                    "zotus.fa", "--uc", "unoise.uc"],
         ["zotus.fa", "unoise.uc"]),
        ("uchime3", ["--uchime3_denovo", "zotus.fa", "--nonchimeras",
                     "zotus_nc.fa", "--chimeras", "zotus_ch.fa",
                     "--uchimeout", "uchime.tsv"],
         ["zotus_nc.fa", "zotus_ch.fa", "uchime.tsv"]),
        ("otutab", ["--usearch_global", "merged.fq", "--db", "zotus_nc.fa",
                    "--id", "0.97", "--otutabout", "otutab.tsv",
                    "--uc", "otutab.uc"],
         ["otutab.tsv", "otutab.uc"]),
        ("sintax", ["--sintax", "zotus_nc.fa", "--db", str(taxdb),
                    "--tabbedout", "sintax.tsv", "--randseed", "7",
                    "--sintax_cutoff", "0.8"],
         ["sintax.tsv"]),
    ]


# the steps whose verbs have a device tier (their launches are read)
DEVICE_STEPS = ("unoise", "uchime3", "otutab")
