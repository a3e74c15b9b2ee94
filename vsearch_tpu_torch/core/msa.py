"""Star MSA / consensus / profile of clusters.

Mirrors reference src/core/msa.cpp: per-position max-insert model against
the centroid from stored CIGARs, 6-row abundance-weighted profile
(A/C/G/U/N/gap), majority consensus with '+' censoring outside the
centroid, and the profile table output.
"""

from __future__ import annotations

import re
from typing import IO, List, Optional, Tuple

from ..params import Parameters
from ..io import fastx as fastx_io
from ..utils.maps import reverse_complement
from ..io.openfile import open_output

_CIGAR_RE = re.compile(r"(\d*)([MDI])")

A, C, G, U, N, GAP = range(6)
_SYM_NT_4BIT = b"-ACMGRSVTWYHKDBN"


def _prof_index(ch: int) -> int:
    c = chr(ch).upper()
    if c == "A":
        return A
    if c == "C":
        return C
    if c == "G":
        return G
    if c in "TU":
        return U
    if c in "RYSWKMBDHVN":
        return N
    if c == "-":
        return GAP
    return -1


class MsaTarget:
    __slots__ = ("seqno", "cigar", "strand")

    def __init__(self, seqno: int, cigar: Optional[str], strand: int) -> None:
        self.seqno = seqno
        self.cigar = cigar
        self.strand = strand


def msa(fp_msaout: Optional[IO[bytes]], fp_consout: Optional[IO[bytes]],
        fp_profile: Optional[IO[bytes]], cluster: int,
        targets: List[MsaTarget], totalabundance: int, db,
        params: Parameters) -> None:
    """reference: msa.cpp msa() (:555-613)."""
    centroid_seqno = targets[0].seqno
    centroid_len = db.getsequencelen(centroid_seqno)

    # max insertions ahead of each centroid position (msa.cpp:157-189)
    max_insertions = [0] * (centroid_len + 1)
    for target in targets[1:]:
        position = 0
        for count, op in _CIGAR_RE.findall(target.cigar or ""):
            run = int(count) if count else 1
            if op in ("M", "I"):
                position += run
            else:  # D
                max_insertions[position] = max(max_insertions[position], run)
    alignment_length = centroid_len + sum(max_insertions)

    profile = [[0] * 6 for _ in range(alignment_length)]
    rows = []  # (prefix, seqno, aligned bytes) for msaout

    def target_seq(target: MsaTarget) -> bytes:
        seq = db.getsequence(target.seqno)
        if target.strand:
            seq = reverse_complement(seq)
        return seq

    def abundance(target: MsaTarget) -> int:
        return db.getabundance(target.seqno) if params.opt_sizein else 1

    # centroid row (msa.cpp process_and_print_centroid)
    centroid = targets[0]
    cseq = target_seq(centroid)
    cab = abundance(centroid)
    aln = bytearray()
    for i in range(centroid_len):
        for _ in range(max_insertions[i]):
            profile[len(aln)][GAP] += cab
            aln.append(ord("-"))
        idx = _prof_index(cseq[i])
        if idx >= 0:
            profile[len(aln)][idx] += cab
        aln.append(cseq[i])
    for _ in range(max_insertions[centroid_len]):
        profile[len(aln)][GAP] += cab
        aln.append(ord("-"))
    rows.append((b"*", centroid.seqno, bytes(aln)))

    # member rows (msa.cpp compute_and_print_msa)
    for target in targets[1:]:
        tseq = target_seq(target)
        tab = abundance(target)
        aln = bytearray()
        qpos = tpos = 0
        is_inserted = False

        def pad(qp: int) -> None:
            nonlocal aln
            if is_inserted:
                return
            for _ in range(max_insertions[qp]):
                profile[len(aln)][GAP] += tab
                aln.append(ord("-"))

        for count, op in _CIGAR_RE.findall(target.cigar or ""):
            run = int(count) if count else 1
            if op == "D":
                for _ in range(run):
                    idx = _prof_index(tseq[tpos])
                    if idx >= 0:
                        profile[len(aln)][idx] += tab
                    aln.append(tseq[tpos])
                    tpos += 1
                for _ in range(run, max_insertions[qpos]):
                    profile[len(aln)][GAP] += tab
                    aln.append(ord("-"))
                is_inserted = True
            elif op == "M":
                for _ in range(run):
                    pad(qpos)
                    idx = _prof_index(tseq[tpos])
                    if idx >= 0:
                        profile[len(aln)][idx] += tab
                    aln.append(tseq[tpos])
                    tpos += 1
                    qpos += 1
                    is_inserted = False
            else:  # I
                for _ in range(run):
                    pad(qpos)
                    profile[len(aln)][GAP] += tab
                    aln.append(ord("-"))
                    qpos += 1
                    is_inserted = False
        pad(qpos)
        rows.append((b"", target.seqno, bytes(aln)))

    if fp_msaout is not None:
        fp_msaout.write(b"\n")
        for prefix, seqno, row in rows:
            fastx_io.fasta_print_general(fp_msaout, params, row,
                                         db.getheader(seqno),
                                         db.getabundance(seqno), 0,
                                         prefix=prefix)

    # consensus (msa.cpp compute_and_print_consensus)
    left_censored = max_insertions[0]
    right_censored = max_insertions[centroid_len]
    cons_aln = bytearray(b"+" * alignment_length)
    cons = bytearray()
    for i in range(left_censored, alignment_length - right_censored):
        best_sym = 0
        best_count = 0
        for nuc in range(4):
            if profile[i][nuc] > best_count:
                best_count = profile[i][nuc]
                best_sym = 1 << nuc
        if best_count == 0 and profile[i][N] > 0:
            best_count = profile[i][N]
            best_sym = 15
        if best_count >= profile[i][GAP]:
            sym = _SYM_NT_4BIT[best_sym]
            cons_aln[i] = sym
            cons.append(sym)
        else:
            cons_aln[i] = ord("-")

    if fp_msaout is not None:
        fp_msaout.write(b">consensus\n")
        fastx_io.print_sequence(fp_msaout, bytes(cons_aln),
                                int(params.opt_fasta_width))

    if fp_consout is not None:
        fastx_io.fasta_print_general(
            fp_consout, params, bytes(cons), db.getheader(centroid_seqno),
            totalabundance, cluster + 1, clustersize=len(targets),
            clusterid=(cluster if params.opt_clusterout_id else -1),
            prefix=b"centroid=")

    if fp_profile is not None:
        fastx_io.fasta_print_general(
            fp_profile, params, None, db.getheader(centroid_seqno),
            totalabundance, cluster + 1, clustersize=len(targets),
            clusterid=(cluster if params.opt_clusterout_id else -1),
            prefix=b"centroid=")
        symbol_indexes = [0, 1, 2, 3, 5, 4]  # gaps before Ns
        for i in range(alignment_length):
            fp_profile.write(b"%d\t%c" % (i, cons_aln[i]))
            for s in symbol_indexes:
                fp_profile.write(b"\t%d" % profile[i][s])
            fp_profile.write(b"\n")
        fp_profile.write(b"\n")


def write_msa_outputs(params: Parameters, db, engine, order: List[int],
                      stack) -> None:
    """Post-clustering MSA pass (reference: cluster.cpp:1443-1530)."""
    fp_msaout = stack.enter_context(open_output(params.opt_msaout, "--msaout")) \
        if params.opt_msaout else None
    fp_consout = stack.enter_context(open_output(params.opt_consout, "--consout")) \
        if params.opt_consout else None
    fp_profile = stack.enter_context(open_output(params.opt_profile, "--profile")) \
        if params.opt_profile else None

    from ..utils.progress import phase
    phase(params, "Multiple alignments")  # cluster.cpp:1488

    lastcluster = -1
    targets: List[MsaTarget] = []
    abundance_sum = 0

    def flush() -> None:
        nonlocal targets, abundance_sum
        if targets:
            msa(fp_msaout, fp_consout, fp_profile, lastcluster, targets,
                abundance_sum, db, params)
        targets = []
        abundance_sum = 0

    for i in order:
        info = engine.clusterinfo[i]
        if info.clusterno != lastcluster:
            flush()
            lastcluster = info.clusterno
        targets.append(MsaTarget(info.seqno, info.cigar, info.strand))
        abundance_sum += (db.getabundance(info.seqno)
                          if params.opt_sizein else 1)
    flush()
