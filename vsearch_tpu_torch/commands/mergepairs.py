"""fastq_mergepairs command.

reference: src/commands/fastq_mergepairs.cpp — reads the fwd/rev FASTQ
pair streams (headers untruncated, sequences upcased), merges via the core
(core/mergepairs.py), writes up to 9 outputs in input order, and prints the
summary statistics block.
"""

from __future__ import annotations

import math
import sys
from contextlib import ExitStack
from typing import IO, Optional

from ..params import Parameters
from ..io import fastx as fastx_io
from ..core.mergepairs import MergeData, QualTables, Reason, process


from ..io.openfile import open_output_opt as _open  # noqa: E402


def _ee_value(out: IO[bytes], ee: float) -> None:
    """reference: fastq_mergepairs.cpp fprintf_ee_value (:179-204)."""
    thresholds = [(1e-9, 13), (1e-8, 12), (1e-7, 11), (1e-6, 10), (1e-5, 9),
                  (1e-4, 8), (1e-3, 7), (1e-2, 6), (1e-1, 5)]
    for limit, prec in thresholds:
        if ee < limit:
            out.write(b"%.*f" % (prec, ee))
            return
    out.write(b"%.4f" % ee)


FAILURE_LABELS = [
    (Reason.undefined, "undefined reason"),
    (Reason.minlen, "reads too short (after truncation)"),
    (Reason.maxlen, "reads too long (after truncation)"),
    (Reason.maxns, "too many N's"),
    (Reason.nokmers, "too few kmers found on same diagonal"),
    (Reason.repeat, "multiple potential alignments"),
    (Reason.maxdiffs, "too many differences"),
    (Reason.maxdiffpct, "too high percentage of differences"),
    (Reason.minscore, "alignment score too low, or score drop too high"),
    (Reason.minovlen, "overlap too short"),
    (Reason.maxee, "expected error too high"),
    (Reason.minmergelen, "merged fragment too short"),
    (Reason.maxmergelen, "merged fragment too long"),
    (Reason.staggered, "staggered read pairs"),
    (Reason.indel, "indel errors"),
]


def fastq_mergepairs(params: Parameters) -> None:
    if params.opt_reverse is None:
        raise ValueError("No reverse reads file specified with --reverse")
    if params.opt_fastq_minovlen < 5:
        raise ValueError(
            "Overlap specified with --fastq_minovlen must be at least 5")

    tables = QualTables(params)

    # input open failures surface before outputs/progress (reference:
    # fastq_open at fastq_mergepairs.cpp:1016-1017 precedes the output opens)
    from ..io import fastx as _fx
    _fx.check_readable(params.opt_fastq_mergepairs)
    _fx.check_readable(params.opt_reverse)

    with ExitStack() as stack:
        fp_fastqout = _open(stack, params.opt_fastqout, "--fastqout")
        fp_fastaout = _open(stack, params.opt_fastaout, "--fastaout")
        fp_fastqout_nm_fwd = _open(stack, params.opt_fastqout_notmerged_fwd, "--fastqout_notmerged_fwd")
        fp_fastqout_nm_rev = _open(stack, params.opt_fastqout_notmerged_rev, "--fastqout_notmerged_rev")
        fp_fastaout_nm_fwd = _open(stack, params.opt_fastaout_notmerged_fwd, "--fastaout_notmerged_fwd")
        fp_fastaout_nm_rev = _open(stack, params.opt_fastaout_notmerged_rev, "--fastaout_notmerged_rev")
        fp_eetabbedout = _open(stack, params.opt_eetabbedout, "--eetabbedout")

        stats = {"total": 0, "merged": 0, "notmerged": 0,
                 "sum_read_length": 0.0, "pairs_read": 0,
                 "sum_fragment_length": 0.0,
                 "sum_squared_fragment_length": 0.0,
                 "sum_ee_merged": 0.0, "sum_ee_fwd": 0.0, "sum_ee_rev": 0.0,
                 "sum_errors_fwd": 0, "sum_errors_rev": 0}
        failed = {r: 0 for r, _ in FAILURE_LABELS}

        from ..utils.progress import Progress
        from .. import native
        merge_progress = Progress("Merging reads", 1, params)

        if native.available() and _merge_native_arrays(
                params, tables, stats, failed, fp_fastqout, fp_fastaout,
                fp_fastqout_nm_fwd, fp_fastqout_nm_rev, fp_fastaout_nm_fwd,
                fp_fastaout_nm_rev, fp_eetabbedout, merge_progress):
            merge_progress.done()
            _emit_merge_stats(params, stats, failed)
            return

        fwd_reader = fastx_io.read_fastx(params.opt_fastq_mergepairs, params,
                                         truncateatspace=False, upcase=True)
        rev_reader = fastx_io.read_fastx(params.opt_reverse, params,
                                         truncateatspace=False, upcase=True)

        if native.available():
            _merge_native(params, tables, fwd_reader, rev_reader, stats,
                          failed, fp_fastqout, fp_fastaout,
                          fp_fastqout_nm_fwd, fp_fastqout_nm_rev,
                          fp_fastaout_nm_fwd, fp_fastaout_nm_rev,
                          fp_eetabbedout, merge_progress)
            merge_progress.done()
            _emit_merge_stats(params, stats, failed)
            return

        for fwd in fwd_reader:
            merge_progress.update()
            try:
                rev = next(rev_reader)
            except StopIteration:
                raise SystemExit("\n\nFatal error: More forward reads than "
                                 "reverse reads")
            pair = MergeData(
                fwd_header=fwd.header, rev_header=rev.header,
                fwd_sequence=bytearray(fwd.sequence),
                rev_sequence=bytearray(rev.sequence),
                fwd_quality=bytearray(fwd.quality or b""),
                rev_quality=bytearray(rev.quality or b""),
                fwd_abundance=fwd.abundance, rev_abundance=rev.abundance,
                fwd_length=len(fwd.sequence), rev_length=len(rev.sequence))
            stats["pairs_read"] += 1
            stats["sum_read_length"] += len(fwd.sequence) + len(rev.sequence)
            process(pair, tables, params)
            stats["total"] += 1

            if pair.merged:
                stats["merged"] += 1
                stats["sum_fragment_length"] += pair.merged_length
                stats["sum_squared_fragment_length"] += \
                    pair.merged_length * pair.merged_length
                stats["sum_ee_merged"] += pair.ee_merged
                stats["sum_ee_fwd"] += pair.ee_fwd
                stats["sum_ee_rev"] += pair.ee_rev
                stats["sum_errors_fwd"] += pair.fwd_errors
                stats["sum_errors_rev"] += pair.rev_errors
                if fp_fastqout is not None:
                    fastx_io.fastq_print_general(
                        fp_fastqout, params, pair.merged_sequence,
                        pair.fwd_header, pair.merged_quality,
                        pair.fwd_abundance, stats["merged"], pair.ee_merged)
                if fp_fastaout is not None:
                    fastx_io.fasta_print_general(
                        fp_fastaout, params, pair.merged_sequence,
                        pair.fwd_header, pair.fwd_abundance, stats["merged"],
                        pair.ee_merged)
                if fp_eetabbedout is not None:
                    _ee_value(fp_eetabbedout, pair.ee_fwd)
                    fp_eetabbedout.write(b"\t")
                    _ee_value(fp_eetabbedout, pair.ee_rev)
                    fp_eetabbedout.write(b"\t%d\t%d\n" % (pair.fwd_errors,
                                                          pair.rev_errors))
            else:
                failed[pair.reason] = failed.get(pair.reason, 0) + 1
                stats["notmerged"] += 1
                if fp_fastqout_nm_fwd is not None:
                    fastx_io.fastq_print_general(
                        fp_fastqout_nm_fwd, params, bytes(pair.fwd_sequence),
                        pair.fwd_header, bytes(pair.fwd_quality),
                        pair.fwd_abundance, stats["notmerged"])
                if fp_fastqout_nm_rev is not None:
                    fastx_io.fastq_print_general(
                        fp_fastqout_nm_rev, params, bytes(pair.rev_sequence),
                        pair.rev_header, bytes(pair.rev_quality),
                        pair.rev_abundance, stats["notmerged"])
                if fp_fastaout_nm_fwd is not None:
                    fastx_io.fasta_print_general(
                        fp_fastaout_nm_fwd, params, bytes(pair.fwd_sequence),
                        pair.fwd_header, pair.fwd_abundance,
                        stats["notmerged"])
                if fp_fastaout_nm_rev is not None:
                    fastx_io.fasta_print_general(
                        fp_fastaout_nm_rev, params, bytes(pair.rev_sequence),
                        pair.rev_header, pair.rev_abundance,
                        stats["notmerged"])

        merge_progress.done()
        _emit_merge_stats(params, stats, failed)


def _emit_merge_stats(params, stats, failed) -> None:
    # reference: fastq_mergepairs.cpp:1059-1064 — stats go to the
    # log when open, otherwise to stderr (exclusive, not duplicated)
    fp_log = getattr(params, "fp_log", None)
    if fp_log is not None:
        import io as _io
        buf = _io.StringIO()
        print_stats(stats, failed, buf)
        fp_log.write(buf.getvalue().encode())
    else:
        print_stats(stats, failed, sys.stderr)


def _plain_headers(params) -> bool:
    """True when the output header pipeline is a passthrough (no relabel or
    annotation options), enabling the bulk native emitters."""
    return not (params.opt_relabel is not None or params.opt_relabel_self
                or params.opt_relabel_sha1 or params.opt_relabel_md5
                or params.opt_xsize or params.opt_xee or params.opt_xlength
                or params.opt_sizeout or params.opt_eeout
                or params.opt_fastq_eeout or params.opt_lengthout
                or params.opt_label_suffix is not None
                or params.opt_sample is not None)


def _merge_native_arrays(params, tables, stats, failed, fp_fastqout,
                         fp_fastaout, fp_fastqout_nm_fwd, fp_fastqout_nm_rev,
                         fp_fastaout_nm_fwd, fp_fastaout_nm_rev,
                         fp_eetabbedout, merge_progress) -> bool:
    """Buffer-level merge pipeline: native FASTQ scan -> one OpenMP merge
    call -> vectorized stats -> bulk native record emission.  Returns False
    (caller falls back to the record pipeline) when the scanner or the
    passthrough-header fast path does not apply."""
    import numpy as np
    from .. import native
    from ..params import INT64_MAX

    if not _plain_headers(params):
        return False
    # scan both inputs concurrently (the native scanner releases the GIL);
    # stripped-char warnings are deferred and emitted in fwd, rev order
    from concurrent.futures import ThreadPoolExecutor
    warn_f: list = []
    warn_r: list = []
    with ThreadPoolExecutor(2) as pool:
        fut_f = pool.submit(fastx_io.scan_fastq_arrays,
                            params.opt_fastq_mergepairs, params=params,
                            truncateatspace=False, upcase=True,
                            warn_out=warn_f)
        fut_r = pool.submit(fastx_io.scan_fastq_arrays, params.opt_reverse,
                            params=params, truncateatspace=False, upcase=True,
                            warn_out=warn_r)
        fa = fut_f.result()
        ra = fut_r.result()
    for stripped, is_fastq in warn_f + warn_r:
        fastx_io._warn_stripped(params, stripped, is_fastq)
    if fa is None or ra is None:
        return False
    (fdata, nf, fseq, fqual, foff, fhead_off, fhead_len, _) = fa
    (rdata, nr, rseq, rqual, roff, rhead_off, rhead_len, _) = ra
    if nf > nr:
        raise SystemExit("\n\nFatal error: More forward reads than reverse "
                         "reads")
    if nr > nf:
        raise SystemExit("\n\nFatal error: More reverse reads than forward "
                         "reads")
    n = nf

    iparams = [params.opt_fastq_minlen, params.opt_fastq_maxlen,
               params.opt_fastq_ascii, params.opt_fastq_qmin,
               params.opt_fastq_qmax,
               max(params.opt_fastq_truncqual, -(2 ** 62)),
               params.opt_fastq_maxns, params.opt_fastq_minovlen,
               params.opt_fastq_maxdiffs,
               params.opt_fastq_minmergelen,
               min(params.opt_fastq_maxmergelen, INT64_MAX),
               1 if params.opt_fastq_allowmergestagger else 0]
    dparams = [params.opt_fastq_maxdiffpct, params.opt_fastq_maxee]

    res = native.merge_batch_arrays(fseq, fqual, foff, rseq, rqual, roff,
                                    n, iparams, dparams, tables)
    if res is None:
        return False
    (oi, od, out_seq, out_qual, out_off,
     fseq, fqual, foff, rseq, rqual, roff) = res

    # fatal quality errors: the reference fails at the first offending pair
    # in input order
    fatal = oi[:, 7] >= 0
    if fatal.any():
        p = int(np.argmax(fatal))
        q = int(oi[p, 7])
        if int(oi[p, 1]) == -1:
            raise SystemExit(
                "\n\nFatal error: FASTQ quality value (%d) below qmin "
                "(%d)" % (q, params.opt_fastq_qmin))
        raise SystemExit(
            "\n\nFatal error: FASTQ quality value (%d) above qmax "
            "(%d)" % (q, params.opt_fastq_qmax))

    merge_progress.update(n)
    reason = oi[:, 0]
    merged_len = oi[:, 2]
    merged = reason == Reason.ok.value
    sel = np.nonzero(merged)[0].astype(np.int32)
    nm_sel = np.nonzero(~merged)[0].astype(np.int32)

    stats["pairs_read"] = n
    stats["sum_read_length"] = float(foff[n] + roff[n])
    stats["total"] = n
    stats["merged"] = int(sel.size)
    stats["notmerged"] = int(nm_sel.size)
    ml = merged_len[sel]
    stats["sum_fragment_length"] = float(ml.sum())
    stats["sum_squared_fragment_length"] = float((ml * ml).sum())
    stats["sum_ee_merged"] = float(od[sel, 0].sum())
    stats["sum_ee_fwd"] = float(od[sel, 1].sum())
    stats["sum_ee_rev"] = float(od[sel, 2].sum())
    stats["sum_errors_fwd"] = int(oi[sel, 3].sum())
    stats["sum_errors_rev"] = int(oi[sel, 4].sum())
    for r_i, count in zip(*np.unique(reason[nm_sel], return_counts=True)):
        failed[Reason(int(r_i))] = int(count)

    out_start = out_off[:n]
    if fp_fastqout is not None:
        fp_fastqout.write(native.emit_fastq(
            fdata, fhead_off, fhead_len, out_seq, out_qual,
            out_start, merged_len, sel))
    if fp_fastaout is not None:
        fp_fastaout.write(native.emit_fasta(
            fdata, fhead_off, fhead_len, out_seq, out_start, merged_len,
            sel, int(params.opt_fasta_width)))
    if fp_eetabbedout is not None:
        for p in sel.tolist():
            _ee_value(fp_eetabbedout, float(od[p, 1]))
            fp_eetabbedout.write(b"\t")
            _ee_value(fp_eetabbedout, float(od[p, 2]))
            fp_eetabbedout.write(b"\t%d\t%d\n" % (int(oi[p, 3]),
                                                  int(oi[p, 4])))
    flen = np.diff(foff)
    rlen = np.diff(roff)
    if fp_fastqout_nm_fwd is not None:
        fp_fastqout_nm_fwd.write(native.emit_fastq(
            fdata, fhead_off, fhead_len, fseq, fqual, foff[:n], flen,
            nm_sel))
    if fp_fastaout_nm_fwd is not None:
        fp_fastaout_nm_fwd.write(native.emit_fasta(
            fdata, fhead_off, fhead_len, fseq, foff[:n], flen, nm_sel,
            int(params.opt_fasta_width)))
    if fp_fastqout_nm_rev is not None:
        fp_fastqout_nm_rev.write(native.emit_fastq(
            rdata, rhead_off, rhead_len, rseq, rqual, roff[:n], rlen,
            nm_sel))
    if fp_fastaout_nm_rev is not None:
        fp_fastaout_nm_rev.write(native.emit_fasta(
            rdata, rhead_off, rhead_len, rseq, roff[:n], rlen, nm_sel,
            int(params.opt_fasta_width)))
    return True


def _merge_native(params, tables, fwd_reader, rev_reader, stats, failed,
                  fp_fastqout, fp_fastaout, fp_fastqout_nm_fwd,
                  fp_fastqout_nm_rev, fp_fastaout_nm_fwd, fp_fastaout_nm_rev,
                  fp_eetabbedout, merge_progress) -> None:
    """Batched native merge path: pack all pairs, one OpenMP C call
    (native/vsearch_tpu_native.c vstpu_merge_batch), then ordered output."""
    from .. import native
    from ..params import INT64_MAX

    fwd_heads, fwd_seqs, fwd_quals, fwd_abunds = [], [], [], []
    for rec in fwd_reader:
        fwd_heads.append(rec.header)
        fwd_seqs.append(rec.sequence)
        fwd_quals.append(rec.quality or b"")
        fwd_abunds.append(rec.abundance)
    rev_heads, rev_seqs, rev_quals, rev_abunds = [], [], [], []
    for rec in rev_reader:
        rev_heads.append(rec.header)
        rev_seqs.append(rec.sequence)
        rev_quals.append(rec.quality or b"")
        rev_abunds.append(rec.abundance)
    if len(rev_seqs) > len(fwd_seqs):
        raise SystemExit("\n\nFatal error: More reverse reads than forward "
                         "reads")
    if len(fwd_seqs) > len(rev_seqs):
        raise SystemExit("\n\nFatal error: More forward reads than reverse "
                         "reads")
    n = len(fwd_seqs)

    iparams = [params.opt_fastq_minlen, params.opt_fastq_maxlen,
               params.opt_fastq_ascii, params.opt_fastq_qmin,
               params.opt_fastq_qmax,
               max(params.opt_fastq_truncqual, -(2 ** 62)),
               params.opt_fastq_maxns, params.opt_fastq_minovlen,
               params.opt_fastq_maxdiffs,
               params.opt_fastq_minmergelen,
               min(params.opt_fastq_maxmergelen, INT64_MAX),
               1 if params.opt_fastq_allowmergestagger else 0]
    dparams = [params.opt_fastq_maxdiffpct, params.opt_fastq_maxee]

    res = native.merge_batch(fwd_seqs, fwd_quals, rev_seqs, rev_quals,
                             iparams, dparams, tables)
    (out_ints, out_doubles, out_seq, out_qual, out_off,
     fwd_buf, fq_buf, fwd_off, rev_buf, rq_buf, rev_off) = res

    out_seq_b = out_seq.tobytes()
    out_qual_b = out_qual.tobytes()
    fq_b = fq_buf.tobytes()
    rq_b = rq_buf.tobytes()
    oi_rows = out_ints.tolist()
    od_rows = out_doubles.tolist()
    out_off_l = out_off.tolist()
    fwd_off_l = fwd_off.tolist()
    rev_off_l = rev_off.tolist()

    for p in range(n):
        merge_progress.update()
        (reason_i, offset, merged_len, fwd_errors, rev_errors, ft, rt,
         fatal_q) = oi_rows[p]
        if fatal_q >= 0:
            if offset == -1:
                raise SystemExit(
                    "\n\nFatal error: FASTQ quality value (%d) below qmin "
                    "(%d)" % (fatal_q, params.opt_fastq_qmin))
            raise SystemExit(
                "\n\nFatal error: FASTQ quality value (%d) above qmax "
                "(%d)" % (fatal_q, params.opt_fastq_qmax))
        ee_merged, ee_fwd, ee_rev = od_rows[p]
        stats["pairs_read"] += 1
        stats["sum_read_length"] += len(fwd_seqs[p]) + len(rev_seqs[p])
        stats["total"] += 1
        merged = reason_i == Reason.ok.value
        if merged:
            stats["merged"] += 1
            stats["sum_fragment_length"] += merged_len
            stats["sum_squared_fragment_length"] += merged_len * merged_len
            stats["sum_ee_merged"] += ee_merged
            stats["sum_ee_fwd"] += ee_fwd
            stats["sum_ee_rev"] += ee_rev
            stats["sum_errors_fwd"] += fwd_errors
            stats["sum_errors_rev"] += rev_errors
            lo = out_off_l[p]
            mseq = out_seq_b[lo:lo + merged_len]
            mqual = out_qual_b[lo:lo + merged_len]
            if fp_fastqout is not None:
                fastx_io.fastq_print_general(
                    fp_fastqout, params, mseq, fwd_heads[p], mqual,
                    fwd_abunds[p], stats["merged"], ee_merged)
            if fp_fastaout is not None:
                fastx_io.fasta_print_general(
                    fp_fastaout, params, mseq, fwd_heads[p], fwd_abunds[p],
                    stats["merged"], ee_merged)
            if fp_eetabbedout is not None:
                _ee_value(fp_eetabbedout, ee_fwd)
                fp_eetabbedout.write(b"\t")
                _ee_value(fp_eetabbedout, ee_rev)
                fp_eetabbedout.write(b"\t%d\t%d\n" % (fwd_errors,
                                                      rev_errors))
        else:
            failed[Reason(reason_i)] = failed.get(Reason(reason_i), 0) + 1
            stats["notmerged"] += 1
            if (fp_fastqout_nm_fwd is not None
                    or fp_fastaout_nm_fwd is not None):
                flo, fhi = fwd_off_l[p], fwd_off_l[p + 1]
                if fp_fastqout_nm_fwd is not None:
                    fastx_io.fastq_print_general(
                        fp_fastqout_nm_fwd, params, fwd_seqs[p],
                        fwd_heads[p], fq_b[flo:fhi], fwd_abunds[p],
                        stats["notmerged"])
                if fp_fastaout_nm_fwd is not None:
                    fastx_io.fasta_print_general(
                        fp_fastaout_nm_fwd, params, fwd_seqs[p],
                        fwd_heads[p], fwd_abunds[p], stats["notmerged"])
            if (fp_fastqout_nm_rev is not None
                    or fp_fastaout_nm_rev is not None):
                rlo, rhi = rev_off_l[p], rev_off_l[p + 1]
                if fp_fastqout_nm_rev is not None:
                    fastx_io.fastq_print_general(
                        fp_fastqout_nm_rev, params, rev_seqs[p],
                        rev_heads[p], rq_b[rlo:rhi], rev_abunds[p],
                        stats["notmerged"])
                if fp_fastaout_nm_rev is not None:
                    fastx_io.fasta_print_general(
                        fp_fastaout_nm_rev, params, rev_seqs[p],
                        rev_heads[p], rev_abunds[p], stats["notmerged"])


def print_stats(stats, failed, out) -> None:
    """reference: fastq_mergepairs.cpp print_stats (:779-999)."""
    total = stats["total"]
    merged = stats["merged"]
    notmerged = stats["notmerged"]

    def w(line):
        print(line, file=out)

    w("%10d  Pairs" % total)
    line = "%10d  Merged" % merged
    if total > 0:
        line += " (%.1f%%)" % (100.0 * merged / total)
    w(line)
    line = "%10d  Not merged" % notmerged
    if total > 0:
        line += " (%.1f%%)" % (100.0 * notmerged / total)
    w(line)

    if notmerged > 0:
        w("")
        w("Pairs that failed merging due to various reasons:")
    for reason, label in FAILURE_LABELS:
        if failed.get(reason):
            w("%10d  %s" % (failed[reason], label))
    w("")
    if total > 0:
        w("Statistics of all reads:")
        w("%10.2f  Mean read length" % (
            stats["sum_read_length"] / (2.0 * stats["pairs_read"])))
    if merged > 0:
        w("")
        w("Statistics of merged reads:")
        mean = stats["sum_fragment_length"] / merged
        w("%10.2f  Mean fragment length" % mean)
        stdev = math.sqrt((stats["sum_squared_fragment_length"]
                           - 2.0 * mean * stats["sum_fragment_length"]
                           + mean * mean * merged) / merged)
        w("%10.2f  Standard deviation of fragment length" % stdev)
        w("%10.2f  Mean expected error in forward sequences" % (
            stats["sum_ee_fwd"] / merged))
        w("%10.2f  Mean expected error in reverse sequences" % (
            stats["sum_ee_rev"] / merged))
        w("%10.2f  Mean expected error in merged sequences" % (
            stats["sum_ee_merged"] / merged))
        w("%10.2f  Mean observed errors in merged region of forward sequences"
          % (stats["sum_errors_fwd"] / merged))
        w("%10.2f  Mean observed errors in merged region of reverse sequences"
          % (stats["sum_errors_rev"] / merged))
        w("%10.2f  Mean observed errors in merged region" % (
            (stats["sum_errors_fwd"] + stats["sum_errors_rev"]) / merged))
