"""The session API driven on seeded inputs, for either package: the port's
API tests run it through vsearch_tpu.api and, in a subprocess, through
vsearch_tpu_torch.api, and chip_smoke.py runs it through the port on cuda
and on cpu.  Imports neither package: the caller passes its `api` module
and its `Parameters` class.  Every function returns its results as JSON
values (dataclass fields by name, bytes as latin-1 text), so that two runs
compare field for field.
"""

import dataclasses
import random


def read_fasta(path):
    """(header, sequence) of each record of a FASTA file."""
    recs, head, seq = [], None, []
    with open(path, "rb") as fh:
        for line in fh.read().splitlines():
            if line.startswith(b">"):
                if head is not None:
                    recs.append((head, b"".join(seq)))
                head, seq = line[1:], []
            else:
                seq.append(line)
    if head is not None:
        recs.append((head, b"".join(seq)))
    return recs


def read_fastq(path):
    """(header, sequence, quality) of each record of a FASTQ file."""
    with open(path, "rb") as fh:
        lines = fh.read().splitlines()
    return [(lines[i][1:], lines[i + 1], lines[i + 3])
            for i in range(0, len(lines) - 3, 4)]


def as_json(obj):
    if dataclasses.is_dataclass(obj):
        return {k: as_json(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, (list, tuple)):
        return [as_json(x) for x in obj]
    if isinstance(obj, dict):
        return {k: as_json(v) for k, v in obj.items()}
    if isinstance(obj, (bytes, bytearray)):
        return bytes(obj).decode("latin-1")
    return obj


# the sessions set the word length, as the reference's api_examples do: a
# default Parameters() resolves its minimum word matches before its word
# length (apply_defaults_fixups), which leaves every k-mer required
def _session(api, params, device):
    """The package's session guard; the port's takes the device."""
    if device is None:
        return api.session(params)
    return api.session(params, device=device)


def write_cluster_set(path, families=12, members=8, length=150, seed=79):
    """Families of `members` copies (about 4 % substitutions) of random
    ancestors, with abundances."""
    rng = random.Random(seed)
    with open(path, "w") as fh:
        i = 0
        for _ in range(families):
            anc = [rng.choice("ACGT") for _ in range(length)]
            for _ in range(members):
                s = list(anc)
                for _ in range(rng.randint(0, length // 25)):
                    s[rng.randrange(length)] = rng.choice("ACGT")
                fh.write(">c%d;size=%d\n%s\n"
                         % (i, rng.randint(1, 60), "".join(s)))
                i += 1
    return path


def search(api, Parameters, db_path, q_path, device=None, n_single=16):
    """SearchSession over the DB: `search` on the first n_single queries
    (each a batch of one), then `search_batch` on all of them as one
    batch, the query numbers running on in the same session."""
    p = Parameters()
    p.opt_wordlength = 8
    p.opt_id = 0.8
    p.opt_maxaccepts = 4
    p.opt_maxrejects = 16
    queries = [(h, s, 1) for h, s in read_fasta(q_path)]
    with _session(api, p, device):
        db = api.Database()
        for head, seq in read_fasta(db_path):
            db.add(head, seq, None, 1)
        db.mask_and_index(p)
        with api.SearchSession(p, db) as ss:
            single = [ss.search(h, s, n, max_results=3)
                      for h, s, n in queries[:n_single]]
            batch = ss.search_batch(queries)
    return as_json({"single": single, "batch": batch})


def cluster(api, Parameters, fa_path, device=None):
    """ClusterSession over the DUST-masked DB sorted by length, every
    sequence assigned in seqno order."""
    p = Parameters()
    p.opt_wordlength = 8
    p.opt_id = 0.9
    p.opt_maxaccepts = 1
    p.opt_maxrejects = 32
    with _session(api, p, device):
        db = api.Database()
        for head, seq in read_fasta(fa_path):
            db.add(head, seq, None, 1)
        db.mask_and_index(p, add_all=False)
        db.sortbylength()
        with api.ClusterSession(p, db) as cs:
            results = [cs.assign(i) for i in range(db.seqcount)]
    return as_json(results)


def chimera(api, Parameters, q_path, db_path, device=None, n=None):
    """ChimeraSession against the reference DB, `detect` on each query (on
    the first n)."""
    p = Parameters()
    p.opt_wordlength = 8
    with _session(api, p, device):
        db = api.Database()
        for head, seq in read_fasta(db_path):
            db.add(head, seq, None, 1)
        db.mask_and_index(p)
        with api.ChimeraSession(p, db) as cs:
            results = [cs.detect(h, s, 1)
                       for h, s in read_fasta(q_path)[:n]]
    return as_json(results)


def derep(api, fa_path):
    with api.DerepSession() as ds:
        for head, seq in read_fasta(fa_path):
            ds.add_sequence(head, seq, 1 + len(seq) % 3)
        return as_json(ds.results())


def merge(api, Parameters, fwd_path, rev_path):
    p = Parameters()
    p.apply_defaults_fixups()
    with api.MergeSession(p) as ms:
        return as_json([ms.merge(f[1], f[2], r[1], r[2], f[0], r[0])
                        for f, r in zip(read_fastq(fwd_path),
                                        read_fastq(rev_path))])


def dust(api, fa_path):
    return as_json([[api.dust_single(seq), api.dust_single(seq, True)]
                    for _, seq in read_fasta(fa_path)])
