"""Jobs of ``vsearch --usearch_global <sample> --db <reference> --uc <out>
--userout <out>.user``.

The config gives the reference (``generator``: genera x members of one
length, each member its genus ancestor with ``member_subs``
substitutions) and the command's options; the cell gives the samples:
``reads`` reads each, ``novel`` of them new members of a genus (absent
from the reference) and the rest reference members, each read with
``read_subs`` substitutions more, and how many samples the pool holds.
Job k searches sample k % pool; its work is the sample's reads.  The
judge compares the uc line and the userout line (the config's
--userfields: labels, identity and the alignment's score) of a sample of
reads drawn from the seed with the plain reference's, and checks that
every job wrote one uc line a read.
"""

from __future__ import annotations

import pathlib
from typing import Dict, List, Optional, Tuple

import torch

from benchmark.gen import seqgen
from benchmark.reference import search as ref

SALT_REFERENCE = 1
SALT_READS = 2
SALT_JUDGE = 99


class Entry:
    def __init__(self, cfg: dict, cell: dict, seed: int,
                 workdir: pathlib.Path):
        gen = cfg["generator"]
        traffic = cell["traffic"]
        self.cfg = cfg
        self.pool = int(traffic["pool"])
        self.reads = int(traffic["reads"])
        self.ancestors, self.db = seqgen.genus_reference(
            seqgen.rng_for(seed, SALT_REFERENCE), int(gen["genera"]),
            int(gen["members"]), int(gen["length"]), int(gen["member_subs"]))
        self.db_path = workdir / "reference.fa"
        seqgen.write_fasta(self.db_path, "t", self.db)
        self.db_labels = ["t%d" % i for i in range(self.db.shape[0])]
        self.samples = []
        self.paths = []
        for k in range(self.pool):
            reads, _ = seqgen.genus_reads(
                seqgen.rng_for(seed, SALT_READS, k), self.ancestors, self.db,
                self.reads, int(traffic["novel"]), int(gen["member_subs"]),
                int(traffic["read_subs"]))
            path = workdir / ("sample%d.fa" % k)
            seqgen.write_fasta(path, "r", reads)
            self.samples.append(reads)
            self.paths.append(path)
        self.q_labels = ["r%d" % i for i in range(self.reads)]

    def argv(self, k: int, out: pathlib.Path) -> List[str]:
        return (["--usearch_global", str(self.paths[k % self.pool]),
                 "--db", str(self.db_path), "--uc", str(out),
                 "--userout", str(self.userout(out))]
                + list(self.cfg["argv"]))

    @staticmethod
    def userout(out: pathlib.Path) -> pathlib.Path:
        return out.with_name(out.name + ".user")

    def work(self, k: int) -> int:
        return self.reads

    def read_sample(self, seed: int, jobs: List[int]
                    ) -> List[Tuple[int, int]]:
        """The (job, read) pairs the judge compares, drawn from the seed."""
        rng = seqgen.rng_for(seed, SALT_JUDGE)
        n = int(self.cfg["judge"]["sample_reads"])
        jk = rng.choice(jobs, size=n)
        rk = rng.integers(0, self.reads, size=n)
        return sorted({(int(k), int(r)) for k, r in zip(jk, rk)})

    def _lines(self, sample: List[Tuple[int, int]], device, saturate=None
               ) -> Dict[Tuple[int, int], Tuple[str, Optional[str]]]:
        """The reference's (uc line, userout line or None) of each (job,
        read)."""
        want: Dict[int, set] = {}
        for k, r in sample:
            want.setdefault(k % self.pool, set()).add(r)
        index = None
        by_sample = {}
        for s, reads in sorted(want.items()):
            if index is None:
                index = ref.WordIndex(torch.from_numpy(self.db).to(device),
                                      int(self.cfg["reference"]["wordlength"]))
            got = ref.uc_lines(self.cfg["reference"], self.db,
                               self.db_labels, self.samples[s],
                               self.q_labels, sorted(reads), device,
                               saturate=saturate, index=index)
            by_sample.update({(s, r): line for r, line in got.items()})
        return {(k, r): by_sample[(k % self.pool, r)] for k, r in sample}

    def control_outputs(self, jobs: List[int], seed: int,
                        workdir: pathlib.Path, device, saturate
                        ) -> Dict[int, pathlib.Path]:
        """The jobs' output files as the reference, in ``saturate``'s
        lanes (None: exact), would write them in the program's place, for
        every read the judge reads (``read_sample``); every other read's
        uc line is a placeholder the judge does not read."""
        lines = self._lines(self.read_sample(seed, jobs), device, saturate)
        workdir.mkdir(parents=True, exist_ok=True)
        outputs = {}
        for k in jobs:
            uc = ["N\tplaceholder"] * self.reads
            user = []
            for r in range(self.reads):
                if (k, r) in lines:
                    uc[r], row = lines[(k, r)]
                    if row is not None:
                        user.append(row)
            outputs[k] = workdir / ("job%d.out" % k)
            outputs[k].write_text("".join(x + "\n" for x in uc))
            self.userout(outputs[k]).write_text(
                "".join(x + "\n" for x in user))
        return outputs

    def judge(self, outputs: Dict[int, pathlib.Path], seed: int,
              device) -> List[Tuple[str, float, float]]:
        """(name, value, limit) of each number compared."""
        jobs = sorted(outputs)
        lines = {k: outputs[k].read_text().splitlines() for k in jobs}
        user = {}
        for k in jobs:
            path = self.userout(outputs[k])
            rows = path.read_text().splitlines() if path.exists() else []
            user[k] = {row.split("\t", 1)[0]: row for row in rows}
        incomplete = sum(1 for k in jobs if len(lines[k]) != self.reads)
        sample = self.read_sample(seed, jobs) if jobs else []
        expected = self._lines(sample, device)
        wrong = sum(1 for k, r in sample
                    if r >= len(lines[k])
                    or lines[k][r] != expected[(k, r)][0])
        wrong_scores = sum(1 for k, r in sample
                           if user[k].get(self.q_labels[r])
                           != expected[(k, r)][1])
        return [("wrong_lines", wrong, 0),
                ("wrong_scores", wrong_scores, 0),
                ("incomplete_jobs", incomplete, 0)]
