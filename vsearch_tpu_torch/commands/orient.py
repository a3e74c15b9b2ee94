"""orient command: fix sequence orientation against a reference index.

reference: src/commands/orient.cpp — per query k-mer, compare forward vs
reverse-complement postings counts in the reference index (8x majority per
k-mer, 4x majority overall).
"""

from __future__ import annotations

import sys
from contextlib import ExitStack
from typing import IO, Optional

import numpy as np

from ..params import Masking, Parameters
from ..db import Database
from ..index import KmerIndex
from ..io import fastx as fastx_io
from ..ops import kmer as kmer_ops
from ..core import mask as mask_mod
from ..utils.maps import reverse_complement


def rc_kmer(kmer: int, wordlength: int) -> int:
    """reference: orient.cpp rc_kmer (:90-113)."""
    fwd = kmer
    rev = 0
    for _ in range(wordlength):
        rev = (rev << 2) | ((fwd & 3) ^ 3)
        fwd >>= 2
    return rev


from ..io.openfile import open_output_opt as _open  # noqa: E402


def orient(params: Parameters) -> None:
    if params.opt_db is None:
        raise ValueError("Database not specified with --db")
    if (params.opt_fastaout is None and params.opt_fastqout is None
            and params.opt_notmatched is None
            and params.opt_tabbedout is None):
        raise ValueError("Output file not specified with --fastaout, "
                         "--fastqout, --notmatched or --tabbedout")

    is_fq = fastx_io.is_fastq(params.opt_orient)
    if params.opt_fastqout is not None and not is_fq:
        raise ValueError("Cannot write FASTQ output with FASTA input")

    from ..core.search import load_db_and_index
    db, index = load_db_and_index(params, params.opt_db)
    index._build_csr()
    matchcounts = np.diff(index._csr_indptr)

    w = index.wordlength

    def rc_of(kmers: np.ndarray) -> np.ndarray:
        """Vectorized reverse-complement of the query's k-mer codes only
        (a whole-vocabulary permutation is 4^w memory for nothing)."""
        fwd = kmers.astype(np.uint64)
        rc = np.zeros_like(fwd)
        for _ in range(w):
            rc = (rc << np.uint64(2)) | ((fwd & np.uint64(3)) ^ np.uint64(3))
            fwd >>= np.uint64(2)
        return rc.astype(np.int64)

    stats = {"queries": 0, "fwd": 0, "rev": 0, "notmatched": 0}

    with ExitStack() as stack:
        fp_fastaout = _open(stack, params.opt_fastaout, "--fastaout")
        fp_fastqout = _open(stack, params.opt_fastqout, "--fastqout")
        fp_notmatched = _open(stack, params.opt_notmatched, "--notmatched")
        fp_tabbedout = _open(stack, params.opt_tabbedout, "--tabbedout")

        from ..utils.progress import Progress, message_both
        orient_progress = Progress("Orienting sequences", 1, params)
        for rec in fastx_io.read_fastx(params.opt_orient, params):
            orient_progress.update()
            kmers = kmer_ops.unique_kmers(rec.sequence, w, params.opt_qmask)
            hits_fwd = matchcounts[kmers.astype(np.int64)]
            hits_rev = matchcounts[rc_of(kmers)]
            count_fwd = int(np.count_nonzero(hits_fwd > 8 * hits_rev))
            count_rev = int(np.count_nonzero(hits_rev > 8 * hits_fwd))

            stats["queries"] += 1
            strand = 2
            if count_fwd >= 1 and count_fwd >= 4 * count_rev:
                strand = 0
                stats["fwd"] += 1
            elif count_rev >= 1 and count_rev >= 4 * count_fwd:
                strand = 1
                stats["rev"] += 1
            else:
                stats["notmatched"] += 1

            if strand == 0:
                seq, qual = rec.sequence, rec.quality
            elif strand == 1:
                seq = reverse_complement(rec.sequence)
                qual = rec.quality[::-1] if rec.quality else None
            if strand in (0, 1):
                n = stats["fwd"] + stats["rev"]
                if fp_fastaout is not None:
                    fastx_io.fasta_print_general(fp_fastaout, params, seq,
                                                 rec.header, rec.abundance, n)
                if fp_fastqout is not None:
                    fastx_io.fastq_print_general(fp_fastqout, params, seq,
                                                 rec.header, qual or b"",
                                                 rec.abundance, n)
            else:
                if fp_notmatched is not None:
                    if is_fq:
                        fastx_io.fastq_print_general(
                            fp_notmatched, params, rec.sequence, rec.header,
                            rec.quality or b"", rec.abundance,
                            stats["notmatched"])
                    else:
                        fastx_io.fasta_print_general(
                            fp_notmatched, params, rec.sequence, rec.header,
                            rec.abundance, stats["notmatched"])
            if fp_tabbedout is not None:
                fp_tabbedout.write(b"%s\t%c\t%d\t%d\n" % (
                    rec.header,
                    ord("+") if strand == 0 else (
                        ord("-") if strand == 1 else ord("?")),
                    count_fwd, count_rev))

        orient_progress.done()
        # reference: orient.cpp:470-527 — identical block to stderr and log
        q = stats["queries"]

        def pct(x):
            return " (%.2f%%)" % (100.0 * x / q) if q > 0 else ""
        message_both(
            params,
            "Forward oriented sequences: %d%s\n"
            "Reverse oriented sequences: %d%s\n"
            "All oriented sequences:     %d%s\n"
            "Not oriented sequences:     %d%s\n"
            "Total number of sequences:  %d\n" % (
                stats["fwd"], pct(stats["fwd"]),
                stats["rev"], pct(stats["rev"]),
                stats["fwd"] + stats["rev"],
                pct(stats["fwd"] + stats["rev"]),
                stats["notmatched"], pct(stats["notmatched"]), q))
