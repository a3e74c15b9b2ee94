"""Jobs of ``vsearch --allpairs_global <set> --blast6out <out> --userout
<out>.user``.

The config gives the sets (``generator``: the leaves of a taxon tree,
gen/seqgen.py ``taxon_tree``) and the command's options; the cell gives
how many sets the pool holds.  Job k aligns set k % pool; its work is
every pair of the set.  The judge compares, against the plain reference,
a sample drawn from the seed of the rows the jobs wrote and a sample of
pairs, reported or not: half of them drawn from the whole triangle, half
from pairs that share a clade at the config's ``near_level``, whose
identities lie about the --id threshold.  It also checks each job's row
order.  The userout rows (the config's --userfields query+target+raw)
carry each reported pair's alignment score, which blast6 does not show;
a row or pair is right when both its rows are.
"""

from __future__ import annotations

import pathlib
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from benchmark.gen import seqgen
from benchmark.reference import allpairs as ref

SALT_SETS = 1
SALT_JUDGE = 99

Pair = Tuple[int, Tuple[int, int]]      # (job, (query, target))


class Entry:
    def __init__(self, cfg: dict, cell: dict, seed: int,
                 workdir: pathlib.Path):
        gen = cfg["generator"]
        self.cfg = cfg
        self.length = int(gen["length"])
        self.pool = int(cell["traffic"]["pool"])
        self.sets, self.clades = [], []
        self.paths = []
        for k in range(self.pool):
            codes, clades = seqgen.taxon_tree(
                seqgen.rng_for(seed, SALT_SETS, k), gen["branching"],
                gen["subs"], gen["indels"], self.length)
            path = workdir / ("set%d.fa" % k)
            seqgen.write_fasta(path, "s", codes)
            self.sets.append(codes)
            self.clades.append(clades)
            self.paths.append(path)
        self.n = self.sets[0].shape[0]
        self.labels = ["s%d" % i for i in range(self.n)]

    def argv(self, k: int, out: pathlib.Path) -> List[str]:
        return (["--allpairs_global", str(self.paths[k % self.pool]),
                 "--blast6out", str(out), "--userout", str(self.userout(out))]
                + list(self.cfg["argv"]))

    @staticmethod
    def userout(out: pathlib.Path) -> pathlib.Path:
        return out.with_name(out.name + ".user")

    def work(self, k: int) -> int:
        return self.n * (self.n - 1) // 2

    def dp_cells(self, k: int) -> int:
        return self.work(k) * self.length * self.length

    def pair_sample(self, seed: int, jobs: List[int]) -> List[Pair]:
        """The pairs the judge compares, drawn from the seed: half from
        the whole triangle, half from pairs sharing a clade at
        ``near_level``."""
        judge = self.cfg["judge"]
        rng = seqgen.rng_for(seed, SALT_JUDGE, 1)
        half = int(judge["sample_pairs"]) // 2
        jk = rng.choice(jobs, size=2 * half)
        a = rng.integers(0, self.n, size=2 * half)
        b = (a[:half] + rng.integers(1, self.n, size=half)) % self.n
        near = []
        for k, x in zip(jk[half:], a[half:]):
            clade = self.clades[k % self.pool][:, int(judge["near_level"])]
            mates = np.flatnonzero(clade == clade[x])
            mates = mates[mates != x]
            near.append(int(mates[rng.integers(0, mates.size)]))
        b = np.concatenate([b, np.asarray(near, dtype=np.int64)])
        return [(int(k), (int(min(x, y)), int(max(x, y))))
                for k, x, y in zip(jk, a, b)]

    def _rows(self, pairs: List[Pair], device, saturate=None
              ) -> Dict[Pair, Optional[Tuple[str, str]]]:
        """The reference's (blast6 row, userout row), or None, of each
        (job, pair)."""
        want: Dict[int, set] = {}
        for k, qt in pairs:
            want.setdefault(k % self.pool, set()).add(qt)
        by_set = {}
        for s, qts in want.items():
            got = ref.rows(self.cfg["reference"], self.sets[s], self.labels,
                           sorted(qts), device, saturate=saturate)
            by_set.update({(s, qt): row for qt, row in got.items()})
        return {(k, qt): by_set[(k % self.pool, qt)] for k, qt in pairs}

    def control_outputs(self, jobs: List[int], seed: int,
                        workdir: pathlib.Path, device, saturate
                        ) -> Dict[int, pathlib.Path]:
        """The jobs' output files as the reference, in ``saturate``'s
        lanes (None: exact), would write them in the program's place, for
        every pair the judge reads (``pair_sample``); the judge reads no
        other pair, and draws its rows from these files' rows."""
        rows = self._rows(self.pair_sample(seed, jobs), device, saturate)
        workdir.mkdir(parents=True, exist_ok=True)
        outputs = {}
        for k in jobs:
            mine = sorted(((qt[0], -float(row[0].split("\t")[2]), qt[1]), row)
                          for (j, qt), row in rows.items()
                          if j == k and row is not None)
            outputs[k] = workdir / ("job%d.out" % k)
            for path, part in ((outputs[k], 0), (self.userout(outputs[k]), 1)):
                path.write_text("".join(row[part] + "\n" for _, row in mine))
        return outputs

    def judge(self, outputs: Dict[int, pathlib.Path], seed: int,
              device) -> List[Tuple[str, float, float]]:
        """(name, value, limit) of each number compared; a row that does
        not parse counts as a wrong row."""
        jobs = sorted(outputs)
        table: Dict[int, Dict[Tuple[int, int], Tuple[str, str]]] = {}
        order_faults = malformed = 0
        for k in jobs:
            path = self.userout(outputs[k])
            user = {}
            for line in (path.read_text().splitlines() if path.exists()
                         else []):
                f = line.split("\t")
                user[(f[0], f[1] if len(f) > 1 else "")] = line
            rows = {}
            last = None
            for line in outputs[k].read_text().splitlines():
                f = line.split("\t")
                try:
                    q, t = int(f[0][1:]), int(f[1][1:])
                    key = (q, -float(f[2]))
                except (ValueError, IndexError):
                    malformed += 1
                    continue
                rows[(q, t)] = (line, user.get((f[0], f[1])))
                if last is not None and key < last:
                    order_faults += 1
                last = key
            table[k] = rows
        emitted = [(k, qt) for k in jobs for qt in table[k]]
        print("rows written: %d by %d jobs" % (len(emitted), len(jobs)),
              file=sys.stderr)
        rng = seqgen.rng_for(seed, SALT_JUDGE, 2)
        pick = (rng.choice(len(emitted), replace=False, size=min(
            len(emitted), int(self.cfg["judge"]["sample_rows"])))
            if emitted else [])
        rows_sample = [emitted[i] for i in sorted(pick)]
        pair_sample = self.pair_sample(seed, jobs) if jobs else []
        expected = self._rows(rows_sample + pair_sample, device)
        wrong_rows = malformed + sum(1 for k, qt in rows_sample
                                     if table[k][qt] != expected[(k, qt)])
        wrong_pairs = sum(1 for k, qt in pair_sample
                          if table[k].get(qt) != expected[(k, qt)])
        return [("wrong_rows", wrong_rows, 0),
                ("wrong_pairs", wrong_pairs, 0),
                ("order_faults", order_faults, 0)]
