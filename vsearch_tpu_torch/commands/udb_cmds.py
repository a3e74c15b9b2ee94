"""UDB commands: makeudb_usearch, udb2fasta, udbinfo, udbstats.

reference: src/commands/makeudb_usearch.cpp, udb2fasta.cpp, udbinfo.cpp,
udbstats.cpp.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..params import Masking, Parameters
from ..db import Database
from ..index import KmerIndex
from ..io import fastx as fastx_io
from ..io import udb as udb_io
from ..core import mask as mask_mod
from ..io.openfile import open_output


def _kmer_string(wordlength: int, kmer: int) -> str:
    """reference: dbindex.cpp fprint_kmer (:112-120)."""
    return "".join("ACGT"[(kmer >> (2 * (wordlength - i - 1))) & 3]
                   for i in range(wordlength))


def makeudb_usearch(params: Parameters) -> None:
    if params.opt_output is None:
        raise ValueError("UDB output file must be specified with --output")
    db = Database()
    db.read(params.opt_makeudb_usearch, params, upcase=True)
    if params.opt_dbmask == Masking.dust:
        mask_mod.dust_all(db, params)
    elif params.opt_dbmask == Masking.soft and params.opt_hardmask:
        mask_mod.hardmask_all(db)
    index = KmerIndex(params.opt_wordlength)
    index.add_all_sequences(db, params.opt_dbmask, params)
    from ..utils.progress import Progress
    with Progress("Writing UDB file", 1, params):
        udb_io.write_udb(params.opt_output, params, db, index)


def udb2fasta(params: Parameters) -> None:
    if params.opt_output is None:
        raise ValueError("FASTA output file must be specified with --output")
    db = Database()
    index = KmerIndex(params.opt_wordlength)
    udb_io.read_udb(params.opt_udb2fasta, params, db, index,
                    parse_abundances=False)
    with open_output(params.opt_output, "--output") as out:
        for i in range(db.seqcount):
            fastx_io.fasta_print_general(out, params, db.getsequence(i),
                                         db.getheader(i),
                                         db.getabundance(i), i + 1)


def udbinfo(params: Parameters) -> None:
    """reference: udbinfo.cpp (:69-158) — header fields only."""
    filename = params.opt_udbinfo
    filesize = os.path.getsize(filename)
    with open(filename, "rb") as handle:
        raw = handle.read(4 * 50)
    if len(raw) != 4 * 50:
        raise ValueError("Unable to read from UDB file or invalid UDB file")
    head = np.frombuffer(raw, dtype="<u4")
    if (head[0] != udb_io.MAGIC_HEAD or head[2] != 32 or head[4] < 3
            or head[4] > 15 or head[13] == 0 or head[17] != 0x0000746E
            or head[49] != udb_io.MAGIC_TAIL):
        raise ValueError("Invalid UDB file")
    if head[13] > filesize // 4:
        raise ValueError("Invalid UDB file")

    def report(out) -> None:
        out.write("           Seqs  %d\n" % head[13])
        out.write("     SeqIx bits  %d\n" % head[2])
        out.write("          Alpha  nt (4)\n")
        out.write("     Word width  %d\n" % head[4])
        out.write("          Slots  %d\n" % head[11])
        out.write("      Dict size  %d (%.1fk)\n"
                  % (1 << (2 * head[4]), (1 << (2 * head[4])) / 1000.0))
        out.write("         DBstep  %d\n" % head[5])
        out.write("        DBAccel  %d%%\n" % head[6])

    import io as _io
    if not params.opt_quiet:
        report(sys.stderr)
    if params.fp_log is not None:
        buf = _io.StringIO()
        report(buf)
        params.fp_log.write(buf.getvalue().encode())


def udbstats(params: Parameters) -> None:
    """reference: udbstats.cpp (:111-346) — full report goes to --log."""
    db = Database()
    index = KmerIndex(params.opt_wordlength)
    udb_io.read_udb(params.opt_udbstats, params, db, index,
                    parse_abundances=False)
    if params.fp_log is None:
        return
    w = index.wordlength
    hashsize = index.hashsize
    kmercount = np.diff(index._csr_indptr)
    indexsize = int(kmercount.sum())
    # sort by (count asc, kmer desc) — udbstats.cpp wc_compare (:85-107)
    order = np.lexsort((-np.arange(hashsize), kmercount))
    sorted_counts = kmercount[order]
    wcmax = int(sorted_counts[-1])
    wcmedian = (int(sorted_counts[hashsize // 2 - 1])
                + int(sorted_counts[hashsize // 2])) // 2
    seqcount = db.seqcount
    nt = sum(db.getsequencelen(i) for i in range(seqcount))

    out = params.fp_log

    def wr(text: str) -> None:
        out.write(text.encode())

    wr("      Alphabet  nt\n")
    wr("    Word width  %d\n" % w)
    wr("     Word ones  %d\n" % w)
    wr("        Spaced  No\n")
    wr("        Hashed  No\n")
    wr("         Coded  No\n")
    wr("       Stepped  No\n")
    wr("         Slots  %d (%.1fk)\n" % (hashsize, hashsize / 1000.0))
    wr("       DBAccel  %d%%\n" % getattr(index, "dbaccel", 100))
    wr("\n")
    wr("%10d  DB size (%.1fk)\n" % (nt, nt / 1000.0))
    wr("%10d  Words\n" % indexsize)
    wr("%10d  Median size\n" % wcmedian)
    wr("%10.1f  Mean size\n" % (indexsize / hashsize))
    wr("\n")
    wr("     iWord         sWord         Cap        Size  Row\n")
    wr("----------  ------------  ----------  ----------  ---\n")
    indptr = index._csr_indptr
    postings = index._csr_postings
    for i in range(hashsize):
        kmer = int(order[hashsize - 1 - i])
        count = int(kmercount[kmer])
        wr("%10d  " % kmer)
        wr("            "[:max(12 - w, 0)])
        wr(_kmer_string(w, kmer))
        wr("  %10d  %10d" % (0, count))
        wr(" ")
        for j in range(count):
            wr(" %d" % postings[indptr[kmer] + j])
            if j == 7:
                break
        if count > 8:
            wr("...")
        wr("\n")
        if i == 10:
            break
    wr("\n\n")
    wr("Word width  %d\n" % w)
    wr("Slots       %d\n" % hashsize)
    wr("Words       %d\n" % indexsize)
    wr("Max size    %d (%s)\n\n"
       % (wcmax, _kmer_string(w, int(order[hashsize - 1]))))
    wr("   Size lo     Size hi  Total size   Nr. Words     Pct  TotPct\n")
    wr("----------  ----------  ----------  ----------  ------  ------\n")

    size_lo = 0
    size_hi = 0
    x = 0
    totpct = 0.0
    while size_lo < seqcount:
        count = 0
        size = 0
        while x < hashsize and sorted_counts[x] <= size_hi:
            count += 1
            size += int(sorted_counts[x])
            x += 1
        pct = 100.0 * count / hashsize
        totpct += pct
        if size_lo < size_hi:
            wr("%10d" % size_lo)
        else:
            wr("          ")
        wr("  %10d" % size_hi)
        if size >= 10000:
            wr("  %9.1fk" % (size * 0.001))
        else:
            wr("  %10.1f" % float(size))
        if count >= 10000:
            wr("  %9.1fk" % (count * 0.001))
        else:
            wr("  %10.1f" % float(count))
        wr("  %5.1f%%  %5.1f%%" % (pct, totpct))
        dots = int(pct / 3.0 + 0.5)  # lround: half away from zero
        if dots > 0:
            wr("  ")
        wr("*" * dots)
        wr("\n")
        size_lo = size_hi + 1
        size_hi = size_hi * 2 if size_hi > 0 else 1
        size_hi = min(size_hi, seqcount)
    wr("----------  ----------  ----------  ----------\n")
    wr("                      ")
    if indexsize >= 10000:
        wr("  %9.1fk" % (indexsize * 0.001))
    else:
        wr("  %10.1f" % float(indexsize))
    if hashsize >= 10000:
        wr("  %9.1fk" % (hashsize * 0.001))
    else:
        wr("  %10.1f" % float(hashsize))
    wr("\n\n")
    wr("%10d  Upper\n" % nt)
    wr("%10d  Lower (%.1f%%)\n" % (0, 0.0))
    wr("%10d  Total\n" % nt)
    wr("%10d  Indexed words\n" % indexsize)
