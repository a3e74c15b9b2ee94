"""Paired-end read merging core (Edgar & Flyvbjerg 2015 posterior quality).

Mirrors reference src/core/mergepairs.cpp: precomputed 94x94 posterior
quality and log-odds score tables, 5-mer diagonal voting for overlap
detection (core/kmerhash.cpp), per-diagonal score scan with drop-max
rejection, and the consensus merge with N handling.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, List, Optional

import numpy as np

from ..params import Parameters
from ..utils.maps import CHRMAP_COMPLEMENT, CHRMAP_MASK_AMBIG, CHRMAP_2BIT

K = 5
MERGE_DROPMAX = 16.0
MERGE_MISMATCHMAX = -4.0


class Reason(enum.Enum):
    undefined = 0
    ok = 1
    minlen = 2
    maxlen = 3
    maxns = 4
    minovlen = 5
    maxdiffs = 6
    maxdiffpct = 7
    staggered = 8
    indel = 9
    repeat = 10
    minmergelen = 11
    maxmergelen = 12
    maxee = 13
    minscore = 14
    nokmers = 15


class QualTables:
    """reference: mergepairs.cpp precompute_qual (:237-289)."""

    def __init__(self, params: Parameters) -> None:
        ascii_off = params.opt_fastq_ascii
        qmaxout = float(params.opt_fastq_qmaxout)
        qminout = float(params.opt_fastq_qminout)

        def q_to_p(symbol: int) -> float:
            q = symbol - ascii_off
            if q < 2:
                return 0.75
            return 10.0 ** (-q / 10.0)

        n = 128
        self.q2p = np.zeros(n)
        self.merge_qual_same = np.zeros((n, n), dtype=np.uint8)
        self.merge_qual_diff = np.zeros((n, n), dtype=np.uint8)
        self.match_score = np.zeros((n, n))
        self.mism_score = np.zeros((n, n))
        for x in range(33, 127):
            px = q_to_p(x)
            self.q2p[x] = px
            for y in range(33, 127):
                py = q_to_p(y)
                p = px * py / 3.0 / (1.0 - px - py + (4.0 * px * py / 3.0))
                q = round(-10.0 * math.log10(p))
                q = min(q, qmaxout)
                q = max(q, qminout)
                self.merge_qual_same[x][y] = int(ascii_off + q)

                p = px * (1.0 - (py / 3.0)) / (px + py - (4.0 * px * py / 3.0))
                q = round(-10.0 * math.log10(p))
                q = min(q, qmaxout)
                q = max(q, qminout)
                self.merge_qual_diff[x][y] = int(ascii_off + q)

                p = 1.0 - px - py + (px * py * 4.0 / 3.0)
                self.match_score[x][y] = math.log2(p / 0.25)
                self.mism_score[x][y] = min(math.log2((1.0 - p) / 0.75),
                                            MERGE_MISMATCHMAX)


@dataclasses.dataclass
class MergeData:
    fwd_header: bytes = b""
    rev_header: bytes = b""
    fwd_sequence: bytearray = dataclasses.field(default_factory=bytearray)
    rev_sequence: bytearray = dataclasses.field(default_factory=bytearray)
    fwd_quality: bytearray = dataclasses.field(default_factory=bytearray)
    rev_quality: bytearray = dataclasses.field(default_factory=bytearray)
    fwd_abundance: int = 1
    rev_abundance: int = 1
    fwd_length: int = 0
    rev_length: int = 0
    fwd_trunc: int = 0
    rev_trunc: int = 0
    offset: int = 0
    merged: bool = False
    reason: Reason = Reason.undefined
    merged_sequence: bytes = b""
    merged_quality: bytes = b""
    merged_length: int = 0
    ee_merged: float = 0.0
    ee_fwd: float = 0.0
    ee_rev: float = 0.0
    fwd_errors: int = 0
    rev_errors: int = 0


def _find_diagonal_counts(fwd: bytes, fwd_len: int, rev: bytes,
                          rev_len: int) -> np.ndarray:
    """5-mer diagonal voting (kmerhash.cpp kh_insert_kmers +
    kh_find_diagonals).  diag counts indexed by len+fpos-(pos-k+1)."""
    kmer_mask = (1 << (2 * K)) - 1
    positions: Dict[int, List[int]] = {}
    bad = kmer_mask
    kmer = 0
    for pos in range(fwd_len):
        c = fwd[pos]
        bad = ((bad << 2) | int(CHRMAP_MASK_AMBIG[c])) & kmer_mask
        kmer = ((kmer << 2) | int(CHRMAP_2BIT[c])) & kmer_mask
        if bad == 0:
            positions.setdefault(kmer, []).append(pos - K + 1 + 1)  # 1-based

    diags = np.zeros(fwd_len + rev_len, dtype=np.int64)
    bad = kmer_mask
    kmer = 0
    for pos in range(rev_len):
        c = rev[rev_len - 1 - pos]
        bad = ((bad << 2) | int(CHRMAP_MASK_AMBIG[c])) & kmer_mask
        kmer = ((kmer << 2) | int(CHRMAP_2BIT[CHRMAP_COMPLEMENT[c]])) & kmer_mask
        if bad == 0:
            for fpos1 in positions.get(kmer, ()):
                diag = rev_len + (fpos1 - 1) - (pos - K + 1)
                if diag >= 0:
                    diags[diag] += 1
    return diags


def optimize(pair: MergeData, tables: QualTables,
             params: Parameters) -> int:
    """reference: mergepairs.cpp optimize (:449-620)."""
    if params.opt_fastq_minovlen < 9:
        merge_mindiagcount = params.opt_fastq_minovlen - 4
        merge_minscore = 1.6 * float(params.opt_fastq_minovlen)
    else:
        merge_mindiagcount = 4
        merge_minscore = 16.0

    ft, rt = pair.fwd_trunc, pair.rev_trunc
    diags = _find_diagonal_counts(bytes(pair.fwd_sequence), ft,
                                  bytes(pair.rev_sequence), rt)

    fwd = pair.fwd_sequence
    rev = pair.rev_sequence
    fq = pair.fwd_quality
    rq = pair.rev_quality
    match_score = tables.match_score
    mism_score = tables.mism_score

    best_score = 0.0
    best_i = 0
    best_diffs = 0
    hits = 0
    kmers = 0

    for i in range(1, ft + rt):
        diag = rt + ft - i
        if diags[diag] < merge_mindiagcount:
            continue
        kmers = 1
        fwd_3p = i - rt if i > rt else 0
        rev_3p = i - ft if i > ft else 0
        overlap = i - fwd_3p - rev_3p
        fwd_pos = ft - fwd_3p - 1
        rev_pos = rt - rev_3p - overlap

        score = 0.0
        diffs = 0
        score_high = 0.0
        dropmax = 0.0
        for _ in range(overlap):
            fwd_sym = fwd[fwd_pos]
            rev_sym = CHRMAP_COMPLEMENT[rev[rev_pos]]
            fq_sym = fq[fwd_pos]
            rq_sym = rq[rev_pos]
            fwd_pos -= 1
            rev_pos += 1
            if fwd_sym == rev_sym:
                score += match_score[fq_sym][rq_sym]
                score_high = max(score, score_high)
            else:
                score += mism_score[fq_sym][rq_sym]
                diffs += 1
                if score < score_high - dropmax:
                    dropmax = score_high - score
        if dropmax >= MERGE_DROPMAX:
            score = 0.0
        if score >= merge_minscore:
            hits += 1
        if score > best_score:
            best_score = score
            best_i = i
            best_diffs = diffs

    if hits > 1:
        pair.reason = Reason.repeat
        return 0
    if not params.opt_fastq_allowmergestagger and best_i > ft:
        pair.reason = Reason.staggered
        return 0
    if best_diffs > params.opt_fastq_maxdiffs:
        pair.reason = Reason.maxdiffs
        return 0
    # reference divides by best_i unguarded; best_i==0 gives NaN which
    # compares false, so only test when best_i > 0
    if best_i > 0 and 100.0 * best_diffs / best_i > params.opt_fastq_maxdiffpct:
        pair.reason = Reason.maxdiffpct
        return 0
    if kmers == 0:
        pair.reason = Reason.nokmers
        return 0
    if best_score < merge_minscore:
        pair.reason = Reason.minscore
        return 0
    if best_i < params.opt_fastq_minovlen:
        pair.reason = Reason.minovlen
        return 0
    mergelen = ft + rt - best_i
    if mergelen < params.opt_fastq_minmergelen:
        pair.reason = Reason.minmergelen
        return 0
    if mergelen > params.opt_fastq_maxmergelen:
        pair.reason = Reason.maxmergelen
        return 0
    return best_i


def merge(pair: MergeData, tables: QualTables, params: Parameters) -> None:
    """reference: mergepairs.cpp merge (:292-445)."""
    fwd_5p = pair.fwd_trunc - pair.offset if pair.fwd_trunc > pair.offset else 0

    pair.ee_merged = 0.0
    pair.ee_fwd = 0.0
    pair.ee_rev = 0.0
    pair.fwd_errors = 0
    pair.rev_errors = 0

    seq = bytearray()
    qual = bytearray()
    q2p = tables.q2p
    ascii_off = params.opt_fastq_ascii

    fwd_pos = 0
    while fwd_pos < fwd_5p:
        sym = pair.fwd_sequence[fwd_pos]
        q = pair.fwd_quality[fwd_pos]
        seq.append(sym)
        qual.append(q)
        ee = q2p[q]
        pair.ee_merged += ee
        pair.ee_fwd += ee
        fwd_pos += 1

    rev_3p = pair.offset - pair.fwd_trunc if pair.offset > pair.fwd_trunc else 0
    rev_pos = pair.rev_trunc - 1 - rev_3p

    while fwd_pos < pair.fwd_trunc and rev_pos >= 0:
        fwd_sym = pair.fwd_sequence[fwd_pos]
        rev_sym = CHRMAP_COMPLEMENT[pair.rev_sequence[rev_pos]]
        fwd_qual = pair.fwd_quality[fwd_pos]
        rev_qual = pair.rev_quality[rev_pos]

        # merge_sym inputs: the reference passes 'N' when the raw quality
        # char is < 2 — never true for printable qualities, so this reduces
        # to the plain symbols (mergepairs.cpp:768-773)
        f_sym = ord("N") if fwd_qual < 2 else fwd_sym
        r_sym = ord("N") if rev_qual < 2 else rev_sym
        if r_sym == ord("N"):
            sym, q = f_sym, fwd_qual
        elif f_sym == ord("N"):
            sym, q = r_sym, rev_qual
        elif f_sym == r_sym:
            sym = f_sym
            q = tables.merge_qual_same[fwd_qual][rev_qual]
        else:
            if fwd_qual > rev_qual:
                sym = f_sym
                q = tables.merge_qual_diff[fwd_qual][rev_qual]
            else:
                sym = r_sym
                q = tables.merge_qual_diff[rev_qual][fwd_qual]

        if sym != fwd_sym:
            pair.fwd_errors += 1
        if sym != rev_sym:
            pair.rev_errors += 1
        seq.append(sym)
        qual.append(q)
        pair.ee_merged += q2p[q]
        pair.ee_fwd += q2p[fwd_qual]
        pair.ee_rev += q2p[rev_qual]
        fwd_pos += 1
        rev_pos -= 1

    while rev_pos >= 0:
        sym = CHRMAP_COMPLEMENT[pair.rev_sequence[rev_pos]]
        q = pair.rev_quality[rev_pos]
        seq.append(sym)
        qual.append(q)
        ee = q2p[q]
        pair.ee_merged += ee
        pair.ee_rev += ee
        rev_pos -= 1

    pair.merged_sequence = bytes(seq)
    pair.merged_quality = bytes(qual)
    pair.merged_length = len(seq)

    if pair.ee_merged <= params.opt_fastq_maxee:
        pair.reason = Reason.ok
        pair.merged = True
    else:
        pair.reason = Reason.maxee


def process(pair: MergeData, tables: QualTables, params: Parameters) -> None:
    """reference: mergepairs.cpp process (:622-760)."""
    pair.merged = False
    skip = False

    if (pair.fwd_length < params.opt_fastq_minlen
            or pair.rev_length < params.opt_fastq_minlen):
        pair.reason = Reason.minlen
        skip = True
    if (pair.fwd_length > params.opt_fastq_maxlen
            or pair.rev_length > params.opt_fastq_maxlen):
        pair.reason = Reason.maxlen
        skip = True

    fwd_trunc = pair.fwd_length
    if not skip:
        for i in range(pair.fwd_length):
            q = pair.fwd_quality[i] - params.opt_fastq_ascii
            if q < params.opt_fastq_qmin:
                raise SystemExit(
                    "\n\nFatal error: FASTQ quality value (%d) below qmin "
                    "(%d)" % (q, params.opt_fastq_qmin))
            if q > params.opt_fastq_qmax:
                raise SystemExit(
                    "\n\nFatal error: FASTQ quality value (%d) above qmax "
                    "(%d)" % (q, params.opt_fastq_qmax))
            if q <= params.opt_fastq_truncqual:
                fwd_trunc = i
                break
        if fwd_trunc < params.opt_fastq_minlen:
            pair.reason = Reason.minlen
            skip = True
    pair.fwd_trunc = fwd_trunc

    rev_trunc = pair.rev_length
    if not skip:
        for i in range(pair.rev_length):
            q = pair.rev_quality[i] - params.opt_fastq_ascii
            if q < params.opt_fastq_qmin:
                raise SystemExit(
                    "\n\nFatal error: FASTQ quality value (%d) below qmin "
                    "(%d)" % (q, params.opt_fastq_qmin))
            if q > params.opt_fastq_qmax:
                raise SystemExit(
                    "\n\nFatal error: FASTQ quality value (%d) above qmax "
                    "(%d)" % (q, params.opt_fastq_qmax))
            if q <= params.opt_fastq_truncqual:
                rev_trunc = i
                break
        if rev_trunc < params.opt_fastq_minlen:
            pair.reason = Reason.minlen
            skip = True
    pair.rev_trunc = rev_trunc

    if not skip:
        ncount = 0
        for i in range(fwd_trunc):
            if pair.fwd_sequence[i] == ord("N"):
                pair.fwd_quality[i] = params.opt_fastq_ascii
                ncount += 1
        if ncount > params.opt_fastq_maxns:
            pair.reason = Reason.maxns
            skip = True
    if not skip:
        ncount = 0
        for i in range(rev_trunc):
            if pair.rev_sequence[i] == ord("N"):
                pair.rev_quality[i] = params.opt_fastq_ascii
                ncount += 1
        if ncount > params.opt_fastq_maxns:
            pair.reason = Reason.maxns
            skip = True

    pair.offset = 0
    if not skip:
        pair.offset = optimize(pair, tables, params)
    if pair.offset > 0:
        merge(pair, tables, params)
