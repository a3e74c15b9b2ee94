"""Format-conversion commands: fastq_convert, fasta2fastq, fastq_join,
fastx_syncpairs.

reference: src/commands/fastq_convert.cpp, fasta2fastq.cpp, fastq_join.cpp,
fastx_syncpairs.cpp.  Pure host-side streaming IO — no device work.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

from ..params import Parameters
from ..io import fastx as fastx_io
from ..utils.maps import reverse_complement
from ..io.openfile import open_output
from ..parallel.distributed import output_path


def fastq_convert(params: Parameters) -> None:
    """reference: fastq_convert.cpp fastq_convert (:74-171) — re-offset and
    clamp quality symbols."""
    if params.opt_fastqout is None:
        raise ValueError("No output file specified with --fastqout")
    if not fastx_io.is_fastq(params.opt_fastq_convert):
        raise ValueError("The input file is not in FASTQ format")

    from ..utils.progress import Progress
    with open_output(params.opt_fastqout, "--fastqout") as out, \
            Progress("Reading FASTQ file", 1, params) as prog:
        n = 0
        for rec in fastx_io.read_fastx(params.opt_fastq_convert, params,
                                       truncateatspace=False):
            prog.update()
            n += 1
            qual = bytearray(rec.quality or b"")
            for i, symbol in enumerate(qual):
                q = symbol - params.opt_fastq_ascii
                if q < params.opt_fastq_qmin:
                    raise ValueError(
                        "FASTQ quality score (%d) below minimum (%d) in "
                        "entry no %d" % (q, params.opt_fastq_qmin, n))
                if q > params.opt_fastq_qmax:
                    raise ValueError(
                        "FASTQ quality score (%d) above maximum (%d) in "
                        "entry no %d" % (q, params.opt_fastq_qmax, n))
                q = max(q, params.opt_fastq_qminout)
                q = min(q, params.opt_fastq_qmaxout)
                q += params.opt_fastq_asciiout
                qual[i] = min(max(q, 33), 126)
            fastx_io.fastq_print_general(out, params, rec.sequence,
                                         rec.header, bytes(qual),
                                         rec.abundance, n)


def fasta2fastq(params: Parameters) -> None:
    """reference: fasta2fastq.cpp (:70-121) — fake maximal quality string."""
    if params.opt_fastqout is None:
        raise ValueError("No output file specified with --fastqout")
    max_ascii = params.opt_fastq_asciiout + params.opt_fastq_qmaxout
    from ..utils.progress import Progress
    with open_output(params.opt_fastqout, "--fastqout") as out, \
            Progress("Converting FASTA file to FASTQ", 1, params) as prog:
        n = 0
        for rec in fastx_io.read_fastx(params.opt_fasta2fastq, params,
                                       truncateatspace=False):
            prog.update()
            n += 1
            qual = bytes([max_ascii]) * len(rec.sequence)
            fastx_io.fastq_print_general(out, params, rec.sequence,
                                         rec.header, qual, rec.abundance, n)


def fastq_join(params: Parameters) -> None:
    """reference: fastq_join.cpp (:185-310) — concatenate fwd + pad +
    revcomp(rev); vsearch.cc:471-483 swaps in the offset-64 quality pad when
    --fastq_ascii is non-default and --join_padgapq was not given."""
    if params.opt_reverse is None:
        raise ValueError("No reverse reads file specified with --reverse")
    if params.opt_fastqout is None and params.opt_fastaout is None:
        raise ValueError("No output files specified")

    padgap = params.opt_join_padgap.encode()
    if (not params.opt_join_padgapq_set_by_user
            and params.opt_fastq_ascii != 33):
        params.opt_join_padgapq = "hhhhhhhh"
    padgapq = params.opt_join_padgapq.encode()
    if len(padgap) != len(padgapq):
        raise ValueError("Strings given by --join_padgap and --join_padgapq "
                         "differ in length")

    fwd_iter = fastx_io.read_fastx(params.opt_fastq_join, params,
                                   truncateatspace=False)
    rev_iter = fastx_io.read_fastx(params.opt_reverse, params,
                                   truncateatspace=False)

    fp_fa = open_output(params.opt_fastaout, "--fastaout") if params.opt_fastaout else None
    fp_fq = open_output(params.opt_fastqout, "--fastqout") if params.opt_fastqout else None
    total = 0
    from ..utils.progress import Progress
    join_progress = Progress("Joining reads", 1, params)
    try:
        for fwd in fwd_iter:
            join_progress.update()
            try:
                rev = next(rev_iter)
            except StopIteration:
                raise ValueError("More forward reads than reverse reads")
            seq = (fwd.sequence + padgap
                   + reverse_complement(rev.sequence))
            qual = ((fwd.quality or b"") + padgapq
                    + (rev.quality or b"")[::-1])
            total += 1
            if fp_fq is not None:
                fastx_io.fastq_print_general(fp_fq, params, seq, fwd.header,
                                             qual, fwd.abundance, total)
            if fp_fa is not None:
                fastx_io.fasta_print_general(fp_fa, params, seq, fwd.header,
                                             fwd.abundance, total)
        try:
            next(rev_iter)
            raise ValueError("More reverse reads than forward reads")
        except StopIteration:
            pass
    finally:
        if fp_fa is not None:
            fp_fa.close()
        if fp_fq is not None:
            fp_fq.close()

    join_progress.done()
    from ..utils.progress import message_both
    message_both(params, "%d pairs joined\n" % total)


def _matching_key(header: bytes, separators: bytes) -> bytes:
    """reference: fastx_syncpairs.cpp matching_key (:177-199)."""
    key = header
    for i, b in enumerate(key):
        if b in (0x20, 0x09):
            key = key[:i]
            break
    if len(key) >= 2 and key[-1] in (ord("1"), ord("2")) \
            and key[-2] in separators:
        key = key[:-2]
    return key


def fastx_syncpairs(params: Parameters) -> None:
    """reference: fastx_syncpairs.cpp (:287-396) — index the reverse file,
    stream the forward file, emit synced pairs in forward order then orphans."""
    if params.opt_reverse is None:
        raise ValueError("No reverse reads file specified with --reverse")
    outs = [params.opt_fastaout, params.opt_fastqout,
            params.opt_fastaout_rev, params.opt_fastqout_rev,
            params.opt_fastaout_orphans, params.opt_fastqout_orphans,
            params.opt_fastaout_orphans_rev, params.opt_fastqout_orphans_rev]
    if all(o is None for o in outs):
        raise ValueError("No output files specified")

    fwd_is_fq = fastx_io.is_fastq(params.opt_fastx_syncpairs)
    rev_is_fq = fastx_io.is_fastq(params.opt_reverse)
    if fwd_is_fq != rev_is_fq:
        raise ValueError(
            "Forward and reverse files must both be FASTA or both FASTQ")
    is_fastq = fwd_is_fq
    wants_fastq = any(o is not None for o in
                      (params.opt_fastqout, params.opt_fastqout_rev,
                       params.opt_fastqout_orphans,
                       params.opt_fastqout_orphans_rev))
    if not is_fastq and wants_fastq:
        raise ValueError(
            "Cannot write FASTQ output from FASTA input (no quality scores)")

    separators = (params.opt_read_separators or "/").encode()

    def write(pair, rec, ordinal):
        fa_path, fq_path, handles = pair
        if fq_path is not None:
            fastx_io.fastq_print_general(handles[1], params, rec.sequence,
                                         rec.header, rec.quality or b"",
                                         rec.abundance, ordinal)
        if fa_path is not None:
            fastx_io.fasta_print_general(handles[0], params, rec.sequence,
                                         rec.header, rec.abundance, ordinal)

    pairs_spec = [
        (params.opt_fastaout, params.opt_fastqout),
        (params.opt_fastaout_rev, params.opt_fastqout_rev),
        (params.opt_fastaout_orphans, params.opt_fastqout_orphans),
        (params.opt_fastaout_orphans_rev, params.opt_fastqout_orphans_rev),
    ]
    opened: List = []
    try:
        dests = []
        for fa, fq in pairs_spec:
            h_fa = open(output_path(fa), "wb") if fa else None
            h_fq = open(output_path(fq), "wb") if fq else None
            opened.extend(h for h in (h_fa, h_fq) if h)
            dests.append((fa, fq, (h_fa, h_fq)))
        synced_fwd, synced_rev, orph_fwd, orph_rev = dests

        from ..utils.progress import Progress
        reverse_records = []
        index: Dict[bytes, int] = {}
        with Progress("Indexing reverse reads", 1, params) as prog:
            for rec in fastx_io.read_fastx(params.opt_reverse, params,
                                           truncateatspace=False):
                prog.update()
                key = _matching_key(rec.header, separators)
                if key in index:
                    raise ValueError(
                        "Duplicate read label in reverse file")
                index[key] = len(reverse_records)
                reverse_records.append(rec)

        used = [False] * len(reverse_records)
        pairs = 0
        orphans_fwd = 0
        sync_progress = Progress("Synchronizing reads", 1, params)
        for rec in fastx_io.read_fastx(params.opt_fastx_syncpairs, params,
                                       truncateatspace=False):
            sync_progress.update()
            key = _matching_key(rec.header, separators)
            pos = index.get(key)
            if pos is None:
                orphans_fwd += 1
                write(orph_fwd, rec, orphans_fwd)
            else:
                if used[pos]:
                    raise ValueError("Duplicate read label in forward file")
                used[pos] = True
                pairs += 1
                write(synced_fwd, rec, pairs)
                write(synced_rev, reverse_records[pos], pairs)

        sync_progress.done()
        orphans_rev = 0
        for pos, rec in enumerate(reverse_records):
            if not used[pos]:
                orphans_rev += 1
                write(orph_rev, rec, orphans_rev)
    finally:
        for h in opened:
            h.close()

    from ..utils.progress import message_both
    message_both(params,
                 "%d pairs synchronized, %d forward and %d reverse orphan "
                 "reads\n" % (pairs, orphans_fwd, orphans_rev))
