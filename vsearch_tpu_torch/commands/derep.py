"""Dereplication commands: derep_fulllength / derep_id / fastx_uniques /
derep_prefix.

reference: src/core/derep.cpp (streaming exact dedup via hash of the
normalized sequence; sort by abundance desc, label asc, first-seen asc),
src/commands/derep_prefix.cpp (prefix collapsing).
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Optional

from ..params import Parameters
from ..io import fastx as fastx_io
from ..utils.digest import normalize
from ..utils.maps import reverse_complement
from ..io.openfile import open_output


class _Cluster:
    __slots__ = ("header", "seq", "qual", "size", "count", "seqno_first",
                 "members", "strands")

    def __init__(self, header: bytes, seq: bytes, qual: Optional[bytes],
                 size: int, seqno: int) -> None:
        self.header = header
        self.seq = seq
        self.qual = bytearray(qual) if qual is not None else None
        self.size = size
        self.count = 1
        self.seqno_first = seqno
        self.members: List[bytes] = []   # headers of subsequent members
        self.strands: List[int] = []


def _q2p(symbol: int, params: Parameters) -> float:
    """reference: derep.cpp convert_quality_symbol_to_probability"""
    q = symbol - params.opt_fastq_ascii
    if q < 2:
        return 0.75
    return 10.0 ** (-q / 10.0)


def _p2q(p: float, params: Parameters) -> int:
    q = int(math.trunc(-10.0 * math.log10(p)))
    q = min(q, params.opt_fastq_qmaxout)
    q = max(q, params.opt_fastq_qminout)
    return q + params.opt_fastq_asciiout


def derep(params: Parameters, command: str) -> None:
    """reference: derep.cpp derep() (:255-930)."""
    filename = getattr(params, "opt_" + command)
    use_header = command == "derep_id"
    is_uniques = command == "fastx_uniques"

    input_is_fastq = fastx_io.is_fastq(filename)
    if input_is_fastq and not is_uniques:
        raise ValueError(
            "FASTQ input is only allowed with the fastx_uniques command")

    if is_uniques:
        out_fasta = params.opt_fastaout
        if (params.opt_uc is None and params.opt_fastaout is None
                and params.opt_fastqout is None
                and params.opt_tabbedout is None):
            raise ValueError(
                "Output file for dereplication with fastx_uniques must be "
                "specified with --fastaout, --fastqout, --tabbedout, or --uc")
    else:
        out_fasta = params.opt_output
        if params.opt_output is None and params.opt_uc is None:
            raise ValueError("Output file for dereplication must be "
                             "specified with --output or --uc")

    from ..utils.progress import Progress, message_both

    table: Dict[bytes, _Cluster] = {}
    clusters: List[_Cluster] = []
    sequencecount = 0
    nucleotidecount = 0
    shortest_len = None
    longest_len = 0
    sumsize = 0
    maxsize = 0
    discarded_short = discarded_long = 0

    fast = None
    if not use_header and params.opt_fastqout is None:
        fast = _derep_fast(params, filename)
    if fast is not None:
        (clusters, sequencecount, nucleotidecount, shortest_len, longest_len,
         sumsize, maxsize, discarded_short, discarded_long) = fast
        read_progress = Progress("Dereplicating file %s" % filename, 1,
                                 params)
        read_progress.done()
        _post_derep(params, is_uniques, out_fasta, clusters, sequencecount,
                    nucleotidecount, shortest_len, longest_len, sumsize,
                    maxsize, discarded_short, discarded_long)
        return

    read_progress = Progress("Dereplicating file %s" % filename, 1, params)
    for rec in fastx_io.read_fastx(filename, params):
        read_progress.update()
        seqlen = len(rec.sequence)
        if seqlen < params.opt_minseqlength:
            discarded_short += 1
            continue
        if seqlen > params.opt_maxseqlength:
            discarded_long += 1
            continue
        nucleotidecount += seqlen
        longest_len = max(longest_len, seqlen)
        shortest_len = (seqlen if shortest_len is None
                        else min(shortest_len, seqlen))
        seq_norm = normalize(rec.sequence)
        key = seq_norm + (b"\x00" + rec.header if use_header else b"")
        abundance = rec.abundance if params.opt_sizein else 1
        sumsize += abundance

        cluster = table.get(key)
        strand = 0
        if cluster is None and params.opt_strand:
            rc_norm = normalize(reverse_complement(rec.sequence))
            rc_key = rc_norm + (b"\x00" + rec.header if use_header else b"")
            cluster = table.get(rc_key)
            if cluster is not None:
                strand = 1

        if cluster is not None:
            cluster.members.append(rec.header)
            cluster.strands.append(strand)
            s1, s2 = cluster.size, abundance
            if params.opt_fastqout is not None and cluster.qual is not None \
                    and rec.quality is not None:
                for i in range(seqlen):
                    p1 = _q2p(cluster.qual[i], params)
                    p2 = _q2p(rec.quality[i], params)
                    if params.opt_fastq_qout_max:
                        p3 = min(p1, p2)
                    else:
                        p3 = (p1 * s1 + p2 * s2) / (s1 + s2)
                    cluster.qual[i] = _p2q(p3, params)
            cluster.size = s1 + s2
            cluster.count += 1
        else:
            cluster = _Cluster(rec.header, rec.sequence, rec.quality,
                               abundance, sequencecount)
            table[key] = cluster
            clusters.append(cluster)
        maxsize = max(maxsize, cluster.size)
        sequencecount += 1

    read_progress.done()
    _post_derep(params, is_uniques, out_fasta, clusters, sequencecount,
                nucleotidecount, shortest_len, longest_len, sumsize,
                maxsize, discarded_short, discarded_long)


def _derep_fast(params: Parameters, filename: str):
    """Native-core dereplication: single-pass C scan + C hash clustering.

    Returns the same aggregates the Python loop computes, or None when the
    native library is unavailable or the input needs the Python path (bad
    characters / zero ;size= — the fallback raises the exact reference
    error messages)."""
    from .. import native
    import numpy as np
    if not native.available():
        return None
    input_is_fastq = fastx_io.is_fastq(filename)
    with fastx_io.open_maybe_compressed(filename) as handle:
        if type(handle).__module__ == "_io" and filename != "-":
            # plain file: map it instead of copying 100s of MB through a
            # buffered read (the native scan touches each page once)
            import mmap
            try:
                data = mmap.mmap(handle.fileno(), 0,
                                 access=mmap.ACCESS_READ)
            except (ValueError, OSError):
                data = handle.read()
        else:
            data = handle.read()
    truncateatspace = not params.opt_notrunclabels
    if input_is_fastq:
        res = native.scan_fastq(data, truncateatspace, False)
        if res is None:
            return None
        (nrec, seq_out, qual_out, seq_off, head_off, head_len, sizes,
         stripped) = res
    else:
        res = native.scan_fasta(data, truncateatspace, False)
        if res is None:
            return None
        nrec, seq_out, seq_off, head_off, head_len, sizes, stripped = res
        qual_out = None
    import ctypes as ct
    lib = native._load()
    if not hasattr(lib, "_derep_ready"):
        lib.vstpu_derep_assign.argtypes = [
            ct.c_void_p, ct.c_void_p, ct.c_int64, ct.c_int, ct.c_void_p,
            ct.c_void_p]
        lib.vstpu_derep_assign.restype = ct.c_int64
        lib._derep_ready = True

    lens = np.diff(seq_off[:nrec + 1])
    keep = ((lens >= params.opt_minseqlength)
            & (lens <= params.opt_maxseqlength))
    discarded_short = int((lens < params.opt_minseqlength).sum())
    discarded_long = int((lens > params.opt_maxseqlength).sum())
    kept_idx = np.flatnonzero(keep)
    n = int(kept_idx.size)
    if n != nrec:
        # compact the packed seq buffer for the kept records
        new_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens[kept_idx], out=new_off[1:])
        packed = np.empty(int(new_off[-1]), dtype=np.uint8)
        for j, r in enumerate(kept_idx):
            packed[int(new_off[j]):int(new_off[j + 1])] = \
                seq_out[int(seq_off[r]):int(seq_off[r + 1])]
        coff = new_off
        cseq = packed
    else:
        coff = seq_off[:nrec + 1]
        cseq = seq_out

    cluster_of = np.empty(n, dtype=np.int64)
    strand_of = np.empty(n, dtype=np.uint8)
    nclusters = lib.vstpu_derep_assign(
        cseq.ctypes.data, coff.ctypes.data, n, int(bool(params.opt_strand)),
        cluster_of.ctypes.data, strand_of.ctypes.data)
    if nclusters < 0:
        return None

    counts = np.bincount(cluster_of, minlength=nclusters)
    if params.opt_sizein:
        abund = sizes[:nrec][kept_idx]
        # float64 weighted bincount is exact for abundances < 2^53
        cluster_sizes = np.bincount(
            cluster_of, weights=abund.astype(np.float64),
            minlength=nclusters).astype(np.int64)
        sumsize_total = int(abund.sum())
    else:
        cluster_sizes = counts.astype(np.int64)
        sumsize_total = n
    # cluster ids cover 0..nclusters-1, so np.unique's first-occurrence
    # indices land in id order (ufunc.at was ~10x slower here)
    _, first_idx = np.unique(cluster_of, return_index=True)

    def header_of(j):
        r = int(kept_idx[j])
        ho = int(head_off[r])
        return data[ho:ho + int(head_len[r])]

    clusters = []
    for c in range(nclusters):
        j = int(first_idx[c])
        lo, hi = int(coff[j]), int(coff[j + 1])
        qual = None
        if qual_out is not None:
            r = int(kept_idx[j])
            qlo, qhi = int(seq_off[r]), int(seq_off[r + 1])
            qual = qual_out[qlo:qhi].tobytes() if n == nrec else None
        cl = _Cluster(header_of(j), cseq[lo:hi].tobytes(), qual,
                      int(cluster_sizes[c]), j)
        cl.count = int(counts[c])
        clusters.append(cl)
    # member chains (headers after the representative, input order)
    need_members = (params.opt_uc is not None
                    or params.opt_tabbedout is not None)
    if need_members:
        for j in range(n):
            c = int(cluster_of[j])
            if j != int(first_idx[c]):
                clusters[c].members.append(header_of(j))
                clusters[c].strands.append(int(strand_of[j]))

    from ..io.fastx import _warn_stripped
    _warn_stripped(params, stripped.astype(np.int64),
                   input_is_fastq)

    nucleotidecount = int(lens[kept_idx].sum())
    shortest_len = int(lens[kept_idx].min()) if n else None
    longest_len = int(lens[kept_idx].max()) if n else 0
    return (clusters, n, nucleotidecount, shortest_len, longest_len,
            sumsize_total, int(cluster_sizes.max()) if nclusters else 0,
            discarded_short, discarded_long)


def _post_derep(params: Parameters, is_uniques: bool, out_fasta,
                clusters: List[_Cluster], sequencecount: int,
                nucleotidecount: int, shortest_len, longest_len: int,
                sumsize: int, maxsize: int, discarded_short: int,
                discarded_long: int) -> None:
    from ..utils.progress import Progress, message_both

    # read summary — quirk: derep's "nt in" log copy has NO extra blank line
    # (derep.cpp:639-659), unlike db.cpp's; the discarded ones do (:671,:689)
    if sequencecount > 0:
        message_both(params,
                     "%d nt in %d seqs, min %d, max %d, avg %.0f\n" % (
                         nucleotidecount, sequencecount, shortest_len,
                         longest_len, nucleotidecount / sequencecount))
    else:
        message_both(params, "%d nt in %d seqs\n" % (nucleotidecount,
                                                     sequencecount))
    for label, limit, count in (
            ("minseqlength", params.opt_minseqlength, discarded_short),
            ("maxseqlength", params.opt_maxseqlength, discarded_long)):
        if count:
            text = "%s %d: %d %s discarded.\n" % (
                label, limit, count,
                "sequence" if count == 1 else "sequences")
            if not params.opt_quiet:
                sys.stderr.write(text)
            if getattr(params, "fp_log", None) is not None:
                params.fp_log.write((text + "\n").encode())

    # sort: abundance desc, label asc, first-seen asc (derep_compare_full)
    with Progress("Sorting", 1, params):
        clusters.sort(key=lambda c: (-c.size, c.header, c.seqno_first))

    n = len(clusters)
    if n < 1:
        summary = "0 unique sequences"
    else:
        sizes = [c.size for c in clusters]
        mid = n // 2
        median = (float(sizes[mid]) if n % 2 else
                  sizes[mid] + (sizes[mid - 1] - sizes[mid]) * 0.5)
        summary = ("%d unique sequences, avg cluster %.1f, median %.0f, "
                   "max %d" % (n, sumsize / n, median, maxsize))
    if not params.opt_quiet:
        sys.stderr.write(summary + "\n")
    if getattr(params, "fp_log", None) is not None:
        params.fp_log.write((summary + "\n\n").encode())

    def selected(c: _Cluster) -> bool:
        return params.opt_minuniquesize <= c.size <= params.opt_maxuniquesize

    n_selected = sum(1 for c in clusters if selected(c))

    if out_fasta is not None:
        from ..parallel.distributed import output_path
        with open(output_path(out_fasta), "wb") as out, \
                Progress("Writing FASTA output file", n, params) as prog:
            relabel_count = 0
            for c in clusters:
                prog.update()
                if selected(c):
                    relabel_count += 1
                    fastx_io.fasta_print_general(out, params, c.seq, c.header,
                                                 c.size, relabel_count)
                    if relabel_count == params.opt_topn:
                        break

    if is_uniques and params.opt_fastqout is not None:
        with open_output(params.opt_fastqout, "--fastqout") as out, \
                Progress("Writing FASTQ output file", n, params) as prog:
            relabel_count = 0
            for c in clusters:
                prog.update()
                if selected(c):
                    relabel_count += 1
                    fastx_io.fastq_print_general(out, params, c.seq, c.header,
                                                 bytes(c.qual or b""),
                                                 c.size, relabel_count)
                    if relabel_count == params.opt_topn:
                        break

    if params.opt_uc is not None:
        with open_output(params.opt_uc, "--uc") as out:
            # rows are batched per cluster and written in one join per
            # section — the uc file dominates derep wall time at scale
            with Progress("Writing uc file, first part", n, params) as prog:
                rows = []
                for i, c in enumerate(clusters):
                    prog.update()
                    seqlen = len(c.seq)
                    rows.append(b"S\t%d\t%d\t*\t*\t*\t*\t*\t%s\t*\n"
                                % (i, seqlen, c.header))
                    rows.extend(
                        b"H\t%d\t%d\t100.0\t%s\t0\t0\t*\t%s\t%s\n"
                        % (i, seqlen, b"-" if strand else b"+", header,
                           c.header)
                        for header, strand in zip(c.members, c.strands))
                out.write(b"".join(rows))
                del rows
            with Progress("Writing uc file, second part", n, params) as prog:
                rows = []
                for i, c in enumerate(clusters):
                    prog.update()
                    rows.append(b"C\t%d\t%d\t*\t*\t*\t*\t*\t%s\t*\n"
                                % (i, c.size, c.header))
                out.write(b"".join(rows))

    if is_uniques and params.opt_tabbedout is not None:
        with open_output(params.opt_tabbedout, "--tabbedout") as out, \
                Progress("Writing tab separated file", n, params) as _prog:
            for i, c in enumerate(clusters):
                _prog.update()
                if params.opt_relabel is not None:
                    label = params.opt_relabel.encode() + b"%d" % (i + 1)
                    out.write(b"%s\t%s\t%d\t%d\t%d\t%s\n" % (
                        c.header, label, i, 0, c.count, c.header))
                    for j, header in enumerate(c.members, 1):
                        out.write(b"%s\t%s\t%d\t%d\t%d\t%s\n" % (
                            header, label, i, j, c.count, c.header))
                else:
                    out.write(b"%s\t%s\t%d\t%d\t%d\t%s\n" % (
                        c.header, c.header, i, 0, c.count, c.header))
                    for j, header in enumerate(c.members, 1):
                        out.write(b"%s\t%s\t%d\t%d\t%d\t%s\n" % (
                            header, c.header, i, j, c.count, c.header))

    # reference: derep.cpp:898-918 — discard summary after all writers
    if n_selected < n:
        text = "%d uniques written, %d clusters discarded (%.1f%%)" % (
            n_selected, n - n_selected, 100.0 * (n - n_selected) / n)
        if not params.opt_quiet:
            sys.stderr.write(text + "\n")
        if getattr(params, "fp_log", None) is not None:
            params.fp_log.write((text + "\n\n").encode())


def derep_prefix(params: Parameters) -> None:
    """reference: src/commands/derep_prefix.cpp — collapse sequences that
    are identical to prefixes of longer ones, processed shortest-first."""
    if params.opt_strand:
        raise ValueError(
            "Option '--strand both' not supported with --derep_prefix")
    if params.opt_output is None and params.opt_uc is None:
        raise ValueError("Output file for dereplication must be specified "
                         "with --output or --uc")

    from ..db import Database
    db = Database()
    db.read(params.opt_derep_prefix, params)
    db.sortbylength_shortest_first(params)

    len_shortest = db.shortest if db.seqcount else 0

    class PCluster:
        __slots__ = ("seqno_first", "seqno_last", "size", "members",
                     "deleted")

        def __init__(self, seqno, size):
            self.seqno_first = seqno
            self.seqno_last = seqno
            self.size = size
            self.members = []  # seqnos after the representative, chain order

    from ..utils.progress import Progress
    table: Dict[bytes, PCluster] = {}
    clusters: List[PCluster] = []
    sumsize = 0
    maxsize = 0

    derep_progress = Progress("Dereplicating", db.seqcount, params)
    for i in range(db.seqcount):
        derep_progress.update()
        norm = normalize(db.getsequence(i))
        abundance = db.getabundance(i) if params.opt_sizein else 1
        sumsize += abundance

        cluster = table.get(norm)
        if cluster is not None:
            # exact match: append to chain tail (derep_prefix.cpp:289-296)
            cluster.size += abundance
            cluster.members.append(i)
            cluster.seqno_last = i
            maxsize = max(maxsize, cluster.size)
            continue

        # prefix match: shorter and shorter prefixes (:300-324)
        found = None
        for plen in range(len(norm) - 1, len_shortest - 1, -1):
            found = table.get(norm[:plen])
            if found is not None:
                break
        if found is not None:
            # new sequence becomes the representative (:326-345)
            del table[normalize(db.getsequence(found.seqno_first))]
            found.deleted = True
            new = PCluster(i, found.size + abundance)
            new.members = [found.seqno_first] + found.members
            new.seqno_last = found.seqno_last
            clusters[clusters.index(found)] = new
            table[norm] = new
            maxsize = max(maxsize, new.size)
        else:
            new = PCluster(i, abundance)
            table[norm] = new
            clusters.append(new)
            maxsize = max(maxsize, new.size)

    derep_progress.done()

    # sort: size desc, header asc, seqno_first asc (derep_compare_prefix)
    with Progress("Sorting", 1, params):
        clusters.sort(key=lambda c: (-c.size, db.getheader(c.seqno_first),
                                     c.seqno_first))
    n = len(clusters)

    if n < 1:
        summary = "0 unique sequences"
    else:
        if n % 2 != 0:
            median = float(clusters[(n - 1) // 2].size)
        else:
            median = (clusters[n // 2 - 1].size
                      + clusters[n // 2].size) / 2.0
        summary = ("%d unique sequences, avg cluster %.1f, median %.0f, "
                   "max %d" % (n, sumsize / n, median, maxsize))
    if not params.opt_quiet:
        sys.stderr.write(summary + "\n")
    if getattr(params, "fp_log", None) is not None:
        params.fp_log.write((summary + "\n\n").encode())

    def selected(c) -> bool:
        return params.opt_minuniquesize <= c.size <= params.opt_maxuniquesize

    if params.opt_output is not None:
        with open_output(params.opt_output, "--output") as out, \
                Progress("Writing output file", n, params) as _wprog:
            relabel_count = 0
            for c in clusters:
                _wprog.update()
                if selected(c):
                    relabel_count += 1
                    fastx_io.fasta_print_general(
                        out, params, db.getsequence(c.seqno_first),
                        db.getheader(c.seqno_first), c.size, relabel_count)
                    if relabel_count == params.opt_topn:
                        break

    if params.opt_uc is not None:
        with open_output(params.opt_uc, "--uc") as out:
            with Progress("Writing uc file, first part", n, params) as prog:
                for i, c in enumerate(clusters):
                    prog.update()
                    rep_head = db.getheader(c.seqno_first)
                    rep_len = db.getsequencelen(c.seqno_first)
                    out.write(b"S\t%d\t%d\t*\t*\t*\t*\t*\t%s\t*\n"
                              % (i, rep_len, rep_head))
                    for next_seqno in c.members:
                        out.write(b"H\t%d\t%d\t100.0\t+\t0\t0\t*\t%s\t%s\n"
                                  % (i, db.getsequencelen(next_seqno),
                                     db.getheader(next_seqno), rep_head))
            with Progress("Writing uc file, second part", n, params) as prog:
                for i, c in enumerate(clusters):
                    prog.update()
                    out.write(b"C\t%d\t%d\t*\t*\t*\t*\t*\t%s\t*\n"
                              % (i, c.size, db.getheader(c.seqno_first)))


def derep_smallmem(params: Parameters) -> None:
    """reference: src/commands/derep_smallmem.cpp — two-pass dereplication
    keyed by sequence identity only (the reference matches 128-bit CityHash
    values; byte-exact keys are a strict superset of that behavior), output
    in order of first appearance."""
    from ..utils.progress import Progress
    if params.opt_fastaout is None:
        raise ValueError(
            "Output file for dereplication must be specified with --fastaout")

    sizes: Dict[bytes, int] = {}
    sequencecount = 0
    nucleotidecount = 0
    shortest = None
    longest = 0
    discarded_short = discarded_long = 0
    sumsize = 0
    maxsize = 0

    def keys_for(rec):
        norm = normalize(rec.sequence)
        rc = normalize(reverse_complement(rec.sequence)) \
            if params.opt_strand else None
        return norm, rc

    _rprog = Progress("Dereplicating file %s" % params.opt_derep_smallmem, 1, params)
    for rec in fastx_io.read_fastx(params.opt_derep_smallmem, params):
        _rprog.update()
        seqlen = len(rec.sequence)
        if seqlen < params.opt_minseqlength:
            discarded_short += 1
            continue
        if seqlen > params.opt_maxseqlength:
            discarded_long += 1
            continue
        nucleotidecount += seqlen
        longest = max(longest, seqlen)
        shortest = seqlen if shortest is None else min(shortest, seqlen)
        norm, rc = keys_for(rec)
        key = norm
        if norm not in sizes and rc is not None and rc in sizes:
            key = rc
        ab = rec.abundance if params.opt_sizein else 1
        sumsize += ab
        sizes[key] = sizes.get(key, 0) + ab
        maxsize = max(maxsize, sizes[key])
        sequencecount += 1
    _rprog.done()

    clusters = len(sizes)

    def stats(out, tail="\n"):
        if sequencecount > 0:
            out.write("%d nt in %d seqs, min %d, max %d, avg %.0f\n" % (
                nucleotidecount, sequencecount, shortest, longest,
                nucleotidecount / sequencecount))
        else:
            out.write("%d nt in %d seqs\n" % (nucleotidecount, sequencecount))
        if discarded_short:
            out.write("minseqlength %d: %d %s discarded.\n%s" % (
                params.opt_minseqlength, discarded_short,
                "sequence" if discarded_short == 1 else "sequences",
                tail[1:]))
        if discarded_long:
            out.write("maxseqlength %d: %d %s discarded.\n%s" % (
                params.opt_maxseqlength, discarded_long,
                "sequence" if discarded_long == 1 else "sequences",
                tail[1:]))
        if clusters < 1:
            out.write("0 unique sequences%s" % tail)
        else:
            svals = sorted(sizes.values())
            n = len(svals)
            median = (float(svals[n // 2]) if n % 2
                      else (svals[n // 2 - 1] + svals[n // 2]) / 2.0)
            out.write("%d unique sequences, avg cluster %.1f, median %.0f, "
                      "max %d%s" % (clusters, sumsize / clusters, median,
                                    maxsize, tail))

    import io as _io
    if not params.opt_quiet:
        stats(sys.stderr)
    if params.fp_log is not None:
        buf = _io.StringIO()
        stats(buf, tail="\n\n")
        params.fp_log.write(buf.getvalue().encode())

    selected = 0
    _wprog = Progress("Writing FASTA output file", 1, params)
    with open_output(params.opt_fastaout, "--fastaout") as out:
        for rec in fastx_io.read_fastx(params.opt_derep_smallmem, params):
            _wprog.update()
            seqlen = len(rec.sequence)
            if not (params.opt_minseqlength <= seqlen
                    <= params.opt_maxseqlength):
                continue
            norm, rc = keys_for(rec)
            key = norm
            if norm not in sizes and rc is not None and rc in sizes:
                key = rc
            size = sizes.get(key, 0)
            if size > 0 and size != -1:
                if params.opt_minuniquesize <= size \
                        <= params.opt_maxuniquesize:
                    selected += 1
                    fastx_io.fasta_print_general(out, params, rec.sequence,
                                                 rec.header, size, selected)
                sizes[key] = -1
    _wprog.done()

    if selected < clusters:
        msg = "%d uniques written, %d clusters discarded (%.1f%%)\n" % (
            selected, clusters - selected,
            100.0 * (clusters - selected) / clusters)
        if not params.opt_quiet:
            sys.stderr.write(msg)
        if params.fp_log is not None:
            params.fp_log.write(msg.encode() + b"\n")
