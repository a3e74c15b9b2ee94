"""FASTQ statistics commands: fastq_chars, fastq_stats, fastq_eestats,
fastq_eestats2.

reference: src/commands/fastq_chars.cpp, fastq_stats.cpp, fastq_eestats.cpp,
fastq_eestats2.cpp.  Host-side single-pass accumulators over the quality
histograms; all heavy lifting is table lookups, so no device work.
"""

from __future__ import annotations

import sys
from typing import IO, List

import numpy as np

from ..params import Parameters
from ..io import fastx as fastx_io
from ..utils.progress import Progress
from ..io.openfile import open_output


def _q2p(q: float) -> float:
    return 10.0 ** (-q / 10.0)


def _qual_length_groups(filename: str, params, warn_out):
    """Scan a FASTQ file once (native) and return (lens, groups) where
    groups yields (length, (n, length) uint8 quality matrix) per distinct
    read length — the wide-vectorization layout for the stats commands.
    Per-read operations (cumsum/cummin along axis 1) keep the scalar
    loop's left-to-right float semantics exactly.  Returns None when the
    native scanner is unavailable (callers keep their per-record loop)."""
    res = fastx_io.scan_fastq_arrays(filename, truncateatspace=False,
                                     upcase=True, params=params,
                                     warn_out=warn_out)
    if res is None:
        return None
    data, nrec, seq_buf, qual_buf, seq_off, head_off, head_len, sizes = res
    lens = np.diff(seq_off[:nrec + 1]).astype(np.int64)

    def groups():
        order = np.argsort(lens, kind="stable")
        sorted_lens = lens[order]
        bounds = np.flatnonzero(np.diff(sorted_lens)) + 1
        starts = np.concatenate(([0], bounds))
        ends = np.concatenate((bounds, [nrec]))
        for s, e in zip(starts, ends):
            ln = int(sorted_lens[s])
            if ln == 0:
                continue
            rows = seq_off[order[s:e]]
            yield ln, qual_buf[rows[:, None]
                               + np.arange(ln, dtype=np.int64)[None, :]]

    return lens, qual_buf[:int(seq_off[nrec])], groups


def fastq_chars(params: Parameters) -> None:
    """reference: fastq_chars.cpp (:303-359 main loop, :170-260 report)."""
    seq_chars = np.zeros(256, dtype=np.int64)
    qual_chars = np.zeros(256, dtype=np.int64)
    tail_chars = np.zeros(256, dtype=np.int64)
    maxrun = np.zeros(256, dtype=np.int64)
    total_chars = 0
    seq_count = 0
    qmin_n, qmax_n = 255, 0
    tail_len = params.opt_fastq_tail

    _prog = Progress("Reading FASTQ file", 1, params)
    for rec in fastx_io.read_fastx(params.opt_fastq_chars, params,
                                   truncateatspace=False, upcase=True):
        seq = np.frombuffer(rec.sequence, dtype=np.uint8)
        qual = np.frombuffer(rec.quality or b"", dtype=np.uint8)
        seq_count += 1
        total_chars += len(seq)
        seq_chars += np.bincount(seq, minlength=256)
        qual_chars += np.bincount(qual, minlength=256)
        n_mask = seq == ord("N")
        if n_mask.any():
            qn = qual[n_mask]
            qmin_n = min(qmin_n, int(qn.min()))
            qmax_n = max(qmax_n, int(qn.max()))
        # per-char maximum run length (run counts repeats beyond the first)
        if len(seq):
            boundaries = np.flatnonzero(np.diff(seq) != 0)
            starts = np.concatenate(([0], boundaries + 1))
            ends = np.concatenate((boundaries + 1, [len(seq)]))
            for s, e in zip(starts, ends):
                c = seq[s]
                maxrun[c] = max(maxrun[c], e - s - 1)
        # trailing homopolymer in the quality string
        if len(qual) >= tail_len and tail_len >= 0:
            tail = qual[len(qual) - tail_len:]
            if (tail == qual[-1]).all():
                tail_chars[qual[-1]] += 1

    _prog.done()
    nz = np.flatnonzero(qual_chars)
    qmin = int(nz[0]) if len(nz) else 0
    qmax = int(nz[-1]) if len(nz) else 0
    # reference: fastq_chars.cpp guess_quality_offset (:99-112)
    if qmin < ord(";") or qmax < ord("K"):
        fastq_ascii = 33
    else:
        fastq_ascii = 64

    def report(out) -> None:
        out.write(b"Read %d sequences.\n" % seq_count)
        if seq_count == 0:
            return
        out.write(b"Qmin %d, Qmax %d, Range %d\n"
                  % (qmin, qmax, qmax - qmin + 1))
        out.write(b"Guess: -fastq_qmin %d -fastq_qmax %d -fastq_ascii %d\n"
                  % (qmin - fastq_ascii, qmax - fastq_ascii, fastq_ascii))
        if fastq_ascii == 64:
            if qmin < 64:
                out.write(b"Guess: Solexa format (phred+64)\n")
            elif qmin < ord("B"):
                out.write(b"Guess: Illumina 1.3+ format (phred+64)\n")
            else:
                out.write(b"Guess: Illumina 1.5+ format (phred+64)\n")
        else:
            if qmax > ord("I"):
                out.write(b"Guess: Illumina 1.8+ format (phred+33)\n")
            else:
                out.write(b"Guess: Original Sanger format (phred+33)\n")
        out.write(b"\nLetter          N   Freq MaxRun\n")
        out.write(b"------ ---------- ------ ------\n")
        factor = 100.0 / total_chars if total_chars else 0.0
        for index in range(256):
            counter = int(seq_chars[index])
            if counter == 0:
                continue
            out.write(b"     %c %10d %5.1f%% %6d"
                      % (index, counter, counter * factor, maxrun[index]))
            if index == ord("N"):
                if qmin_n < qmax_n:
                    out.write(b"  Q=%c..%c" % (qmin_n, qmax_n))
                else:
                    out.write(b"  Q=%c" % qmin_n)
            out.write(b"\n")
        out.write(b"\nChar  ASCII    Freq       Tails\n")
        out.write(b"----  -----  ------  ----------\n")
        for i in range(qmin, qmax + 1):
            if qual_chars[i] == 0:
                continue
            out.write(b" '%c'  %5d  %5.1f%%  %10d\n"
                      % (i, i, qual_chars[i] * factor, tail_chars[i]))

    if not params.opt_quiet:
        report(sys.stderr.buffer)
        sys.stderr.buffer.flush()
    if params.fp_log is not None:
        report(params.fp_log)


def fastq_stats(params: Parameters) -> None:
    """reference: fastq_stats.cpp fastq_stats (:506-633) plus the section
    reporters (:339-500); the full report goes only to --log."""
    sym_score = np.zeros(256, dtype=np.int64)
    sym_score[params.opt_fastq_ascii:] = np.arange(
        256 - params.opt_fastq_ascii)
    sym_prob = 10.0 ** (-sym_score.astype(np.float64) / 10.0)
    q_thresholds = (5, 10, 15, 20)
    ee_thresholds = (1.0, 0.5, 0.25, 0.1)

    size = 512
    read_length_table = np.zeros(size, dtype=np.int64)
    qual_length_table = np.zeros((size, 256), dtype=np.int64)
    ee_length_table = np.zeros((size, 4), dtype=np.int64)
    q_length_table = np.zeros((size, 4), dtype=np.int64)
    sumee_length_table = np.zeros(size, dtype=np.float64)

    def qrange_fatal(s: int):
        raise ValueError(
            "FASTQ quality value (%d) out of range (%d-%d).\n"
            "Please adjust the FASTQ quality base character or range "
            "with the\n--fastq_ascii, --fastq_qmin or --fastq_qmax "
            "options. For a complete\ndiagnosis with suggested "
            "values, please run vsearch --fastq_chars file."
            % (s, params.opt_fastq_qmin, params.opt_fastq_qmax))

    _prog = Progress("Reading FASTQ file", 1, params)
    warn_out: List = []
    scanned = _qual_length_groups(params.opt_fastq_stats, params, warn_out)
    if scanned is not None:
        # wide vectorization: all reads of one length as a (n, L) matrix;
        # per-read cumsum/cummin run along axis 1 with the scalar loop's
        # exact left-to-right float order
        lens, allqual, groups = scanned
        size = max(size, int(lens.max(initial=0)) + 1)
        read_length_table = np.bincount(lens, minlength=size)
        qual_length_table = np.zeros((size, 256), dtype=np.int64)
        ee_length_table = np.zeros((size, 4), dtype=np.int64)
        q_length_table = np.zeros((size, 4), dtype=np.int64)
        sumee_length_table = np.zeros(size, dtype=np.float64)
        allscores = sym_score[allqual]
        bad = ((allscores < params.opt_fastq_qmin)
               | (allscores > params.opt_fastq_qmax))
        if bad.any():
            qrange_fatal(int(allscores[np.argmax(bad)]))
        for ln, Q in groups():
            scores = sym_score[Q]
            combined = (np.arange(ln, dtype=np.int64)[None, :] * 256
                        + Q).ravel()
            qual_length_table[:ln] += np.bincount(
                combined, minlength=ln * 256).reshape(ln, 256)
            qmin_running = np.minimum.accumulate(scores, axis=1)
            for k, thr in enumerate(q_thresholds):
                q_length_table[:ln, k] += (qmin_running > thr).sum(axis=0)
            ee = np.cumsum(sym_prob[Q], axis=1)
            sumee_length_table[:ln] += ee.sum(axis=0)
            for k, thr in enumerate(ee_thresholds):
                ee_length_table[:ln, k] += (ee <= thr).sum(axis=0)
        for stripped, is_fq in warn_out:
            fastx_io._warn_stripped(params, stripped, is_fq)
    else:
        for rec in fastx_io.read_fastx(params.opt_fastq_stats, params,
                                       truncateatspace=False, upcase=True):
            length = len(rec.sequence)
            if length + 1 > size:
                grow = length + 1 - size
                read_length_table = np.pad(read_length_table, (0, grow))
                qual_length_table = np.pad(qual_length_table,
                                           ((0, grow), (0, 0)))
                ee_length_table = np.pad(ee_length_table,
                                         ((0, grow), (0, 0)))
                q_length_table = np.pad(q_length_table, ((0, grow), (0, 0)))
                sumee_length_table = np.pad(sumee_length_table, (0, grow))
                size = length + 1
            read_length_table[length] += 1
            qual = np.frombuffer(rec.quality or b"", dtype=np.uint8)
            if length == 0:
                continue
            scores = sym_score[qual]
            smin, smax = int(scores.min()), int(scores.max())
            for s in (smin, smax):
                if not (params.opt_fastq_qmin <= s
                        <= params.opt_fastq_qmax):
                    qrange_fatal(s)
            np.add.at(qual_length_table, (np.arange(length), qual), 1)
            qmin_running = np.minimum.accumulate(scores)
            for k, thr in enumerate(q_thresholds):
                q_length_table[:length, k] += qmin_running > thr
            ee = np.cumsum(sym_prob[qual])
            sumee_length_table[:length] += ee
            for k, thr in enumerate(ee_thresholds):
                ee_length_table[:length, k] += ee <= thr

    _prog.done()
    nz = np.flatnonzero(read_length_table)
    len_min = int(nz[0]) if len(nz) else 0
    len_max = int(nz[-1]) if len(nz) else 0
    seq_count = int(read_length_table.sum())
    n_sequences = float(seq_count)
    n_symbols = float(
        (np.arange(size, dtype=np.int64) * read_length_table).sum())
    length_dist = np.cumsum(read_length_table)
    quality_dist = qual_length_table.sum(axis=0)

    if not params.opt_quiet:
        print("Read %d sequences." % seq_count, file=sys.stderr)
    if params.fp_log is None:
        return
    out: IO[bytes] = params.fp_log

    # section 1: read length distribution
    out.write(b"\nRead length distribution\n"
              b"      L           N      Pct   AccPct\n"
              b"-------  ----------  -------  -------\n")
    for length in range(len_max, len_min - 1, -1):
        if read_length_table[length] != 0:
            prev = float(length_dist[length - 1]) if length != 0 else 0.0
            out.write(b"%2s%5d  %10d   %5.1f%%   %5.1f%%\n" % (
                b">=" if length == len_max else b"  ", length,
                read_length_table[length],
                read_length_table[length] * 100.0 / n_sequences,
                100.0 * (n_sequences - prev) / n_sequences))
        if length == 0:
            break

    # section 2: Q score distribution
    nzq = np.flatnonzero(quality_dist)
    qmin = int(nzq[0]) if len(nzq) else 0
    qmax = int(nzq[-1]) if len(nzq) else 0
    out.write(b"\nQ score distribution\n"
              b"ASCII    Q       Pe           N      Pct   AccPct\n"
              b"-----  ---  -------  ----------  -------  -------\n")
    qual_accum = 0
    for sym in range(qmax, qmin - 1, -1):
        if quality_dist[sym] == 0:
            continue
        qual_accum += int(quality_dist[sym])
        out.write(b"    %c  %3d  %7.5f  %10d  %6.1f%%  %6.1f%%\n" % (
            sym, sym_score[sym], sym_prob[sym], quality_dist[sym],
            100.0 * quality_dist[sym] / n_symbols,
            100.0 * qual_accum / n_symbols))

    # section 3: length vs quality distribution
    sum_counts = qual_length_table.sum(axis=1).astype(np.float64)
    sum_scores = (qual_length_table * sym_score[None, :]).sum(axis=1)
    sum_probs = (qual_length_table * sym_prob[None, :]).sum(axis=1)
    out.write(b"\n    L  PctRecs  AvgQ  P(AvgQ)      AvgP  AvgEE       Rate"
              b"   RatePct\n"
              b"-----  -------  ----  -------  --------  -----  ---------"
              b"  --------\n")
    for length in range(2, len_max + 1):
        pos = length - 1
        with np.errstate(divide="ignore", invalid="ignore"):
            n_sym = sum_counts[pos]
            avgq = float(sum_scores[pos]) / n_sym
            avgp = float(sum_probs[pos]) / n_sym
            avgee = float(sumee_length_table[pos]) / n_sym
        rate = avgee / length
        prev = float(length_dist[pos])
        out.write(b"%5d  %6.1f%%  %4.1f  %7.5f  %8.6f  %5.2f  %9.6f"
                  b"  %7.3f%%\n" % (
                      length, 100.0 * (n_sequences - prev) / n_sequences,
                      avgq, _q2p(avgq), avgp, avgee, rate, 100.0 * rate))

    # section 4: expected error and length filtering
    out.write(b"\n    L   1.0000   0.5000   0.2500   0.1000   1.0000"
              b"   0.5000   0.2500   0.1000\n"
              b"-----  -------  -------  -------  -------  -------"
              b"  -------  -------  -------\n")
    empty = np.flatnonzero(ee_length_table[:, 0] == 0)
    max_length = int(empty[0]) if len(empty) else len_max
    for length in range(max_length, 0, -1):
        rc = ee_length_table[length - 1]
        out.write(b"%5d  %7d  %7d  %7d  %7d  %6.2f%%  %6.2f%%  %6.2f%%"
                  b"  %6.2f%%\n" % (
                      length, rc[0], rc[1], rc[2], rc[3],
                      100.0 * rc[0] / n_sequences, 100.0 * rc[1] / n_sequences,
                      100.0 * rc[2] / n_sequences,
                      100.0 * rc[3] / n_sequences))

    # section 5: truncate at first low Q
    out.write(b"\nTruncate at first Q\n"
              b"  Len     Q=5    Q=10    Q=15    Q=20\n"
              b"-----  ------  ------  ------  ------\n")
    mid = max(1, len_max // 2)
    for length in range(len_max, mid - 1, -1):
        rc = q_length_table[length - 1]
        out.write(b"%5d  %5.1f%%  %5.1f%%  %5.1f%%  %5.1f%%\n" % (
            length, 100.0 * rc[0] / n_sequences, 100.0 * rc[1] / n_sequences,
            100.0 * rc[2] / n_sequences, 100.0 * rc[3] / n_sequences))

    # closing section
    out.write(b"\n%10d  Recs (%.1fM), 0 too long\n"
              % (seq_count, n_sequences / 1e6))
    if seq_count != 0:
        out.write(b"%10.1f  Avg length\n" % (n_symbols / n_sequences))
    out.write(b"%9.1fM  Bases\n" % (n_symbols / 1e6))


def _qual_eestats(symbol: int, params: Parameters) -> int:
    """reference: core/eestats.cpp fastq_get_qual_eestats (:69-110)."""
    qual = symbol - params.opt_fastq_ascii
    if qual < params.opt_fastq_qmin:
        raise ValueError("FASTQ quality value (%d) below qmin (%d)"
                         % (qual, params.opt_fastq_qmin))
    if qual > params.opt_fastq_qmax:
        raise ValueError(
            "FASTQ quality value (%d) above qmax (%d)\n"
            "By default, quality values range from 0 to 41.\n"
            "To allow higher quality values, "
            "please use the option --fastq_qmax %d"
            % (qual, params.opt_fastq_qmax, qual))
    return qual


def fastq_eestats(params: Parameters) -> None:
    """reference: fastq_eestats.cpp (:82-349) — per-position quantiles of Q,
    Pe and EE (EE binned at resolution 1/1000)."""
    if params.opt_output is None:
        raise ValueError(
            "Output file for fastq_eestats must be specified with --output")
    resolution = 1000
    max_quality = params.opt_fastq_qmax + 1
    q2p_tab = 10.0 ** (-np.arange(max_quality + 1, dtype=np.float64) / 10.0)

    seq_count = 0
    len_max = 0
    read_length = np.zeros(0, dtype=np.int64)
    qual_length = np.zeros((0, max_quality + 1), dtype=np.int64)
    ee_hist: List = []          # per position: dict bucket -> count
    sum_ee = np.zeros(0, dtype=np.float64)
    sum_pe = np.zeros(0, dtype=np.float64)

    _prog = Progress("Reading FASTQ file", 1, params)
    for rec in fastx_io.read_fastx(params.opt_fastq_eestats, params,
                                   truncateatspace=False, upcase=True):
        seq_count += 1
        length = len(rec.sequence)
        if length > len_max:
            grow = length - len(read_length)
            read_length = np.pad(read_length, (0, grow))
            qual_length = np.pad(qual_length, ((0, grow), (0, 0)))
            sum_ee = np.pad(sum_ee, (0, grow))
            sum_pe = np.pad(sum_pe, (0, grow))
            ee_hist.extend({} for _ in range(grow))
            len_max = length
        qual = np.frombuffer(rec.quality or b"", dtype=np.uint8)
        scores = qual.astype(np.int64) - params.opt_fastq_ascii
        if length:
            smin, smax = int(scores.min()), int(scores.max())
            for s in (smin, smax):
                _qual_eestats(s + params.opt_fastq_ascii, params)
        scores = np.maximum(scores, 0)
        read_length[:length] += 1
        np.add.at(qual_length, (np.arange(length), scores), 1)
        pe = q2p_tab[scores]
        sum_pe[:length] += pe
        ee = np.cumsum(pe)
        sum_ee[:length] += ee
        # bucket = min(resolution*(i+1), trunc(resolution*ee))
        buckets = np.minimum(resolution * (np.arange(length) + 1),
                             (resolution * ee).astype(np.int64))
        for i, b in enumerate(buckets):
            h = ee_hist[i]
            h[int(b)] = h.get(int(b), 0) + 1

    _prog.done()
    def quantiles_from_hist(items, reads):
        """(value, count) ascending -> (min, low, med, hi, max)."""
        mn = lo = md = hi = mx = -1.0
        n = 0.0
        for v, x in items:
            if x <= 0:
                continue
            n += x
            if mn < 0:
                mn = v
            if lo < 0 and n >= 0.25 * reads:
                lo = v
            if md < 0 and n >= 0.50 * reads:
                md = v
            if hi < 0 and n >= 0.75 * reads:
                hi = v
            mx = v
        return mn, lo, md, hi, mx

    with open_output(params.opt_output, "--output") as out:
        out.write(b"Pos\tRecs\tPctRecs\t"
                  b"Min_Q\tLow_Q\tMed_Q\tMean_Q\tHi_Q\tMax_Q\t"
                  b"Min_Pe\tLow_Pe\tMed_Pe\tMean_Pe\tHi_Pe\tMax_Pe\t"
                  b"Min_EE\tLow_EE\tMed_EE\tMean_EE\tHi_EE\tMax_EE\n")
        for i in range(len_max):
            reads = int(read_length[i])
            pctrecs = 100.0 * reads / seq_count
            row = qual_length[i]
            qs = quantiles_from_hist(
                ((q, int(row[q])) for q in range(max_quality + 1)), reads)
            mean_q = float((np.arange(max_quality + 1) * row).sum()) / reads
            # Pe quantiles scan q from high to low (low Pe first)
            pes = quantiles_from_hist(
                ((float(q2p_tab[q]), int(row[q]))
                 for q in range(max_quality, -1, -1)), reads)
            mean_pe = float((q2p_tab * row).sum()) / reads
            ees = quantiles_from_hist(sorted(ee_hist[i].items()), reads)
            mean_ee = float(sum_ee[i]) / reads
            ees = tuple((e + 0.5) / resolution for e in ees)
            out.write(b"%d\t%d\t%.1f"
                      b"\t%.1f\t%.1f\t%.1f\t%.1f\t%.1f\t%.1f"
                      b"\t%.2g\t%.2g\t%.2g\t%.2g\t%.2g\t%.2g"
                      b"\t%.2f\t%.2f\t%.2f\t%.2f\t%.2f\t%.2f\n" % (
                          i + 1, reads, pctrecs,
                          qs[0], qs[1], qs[2], mean_q, qs[3], qs[4],
                          pes[0], pes[1], pes[2], mean_pe, pes[3], pes[4],
                          ees[0], ees[1], ees[2], mean_ee, ees[3], ees[4]))


def fastq_eestats2(params: Parameters) -> None:
    """reference: fastq_eestats2.cpp (:66-252) — reads surviving each
    (length cutoff, max-EE) combination."""
    if params.opt_output is None:
        raise ValueError(
            "Output file for fastq_eestats2 must be specified with --output")
    ee_cutoffs = params.opt_ee_cutoffs
    ncut = len(ee_cutoffs)
    shortest = params.opt_length_cutoffs_shortest
    increment = params.opt_length_cutoffs_increment
    longest_opt = params.opt_length_cutoffs_longest

    seq_count = 0
    symbols = 0
    longest = 0
    len_steps = 0
    count_table = np.zeros((0, ncut), dtype=np.int64)

    _prog = Progress("Reading FASTQ file", 1, params)
    for rec in fastx_io.read_fastx(params.opt_fastq_eestats2, params,
                                   truncateatspace=False, upcase=True):
        seq_count += 1
        length = len(rec.sequence)
        if length > longest:
            longest = length
            high = min(longest, longest_opt)
            new_steps = 1 + max(0, (high - shortest) // increment)
            if new_steps > len_steps:
                count_table = np.pad(count_table,
                                     ((0, new_steps - len_steps), (0, 0)))
                len_steps = new_steps
        symbols += length
        qual = np.frombuffer(rec.quality or b"", dtype=np.uint8)
        scores = qual.astype(np.int64) - params.opt_fastq_ascii
        if length:
            smin, smax = int(scores.min()), int(scores.max())
            for s in (smin, smax):
                _qual_eestats(s + params.opt_fastq_ascii, params)
        ee = np.cumsum(10.0 ** (-np.maximum(scores, 0) / 10.0))
        for x in range(len_steps):
            len_cutoff = shortest + x * increment
            if len_cutoff <= length:
                e = ee[len_cutoff - 1]
                for y, cut in enumerate(ee_cutoffs):
                    if e <= cut:
                        count_table[x, y] += 1

    _prog.done()
    def report(out) -> None:
        out.write(b"%d reads" % seq_count)
        if seq_count > 0:
            out.write(b", max len %d, avg %.1f" % (longest,
                                                   symbols / seq_count))
        out.write(b"\n\n")
        out.write(b"Length")
        for cut in ee_cutoffs:
            out.write(b"         MaxEE %.2f" % cut)
        out.write(b"\n------" + b"   ----------------" * ncut + b"\n")
        for x in range(len_steps):
            len_cutoff = shortest + x * increment
            if len_cutoff > longest_opt:
                break
            out.write(b"%6d" % len_cutoff)
            for y in range(ncut):
                out.write(b"   %8d(%5.1f%%)" % (
                    count_table[x, y],
                    100.0 * count_table[x, y] / seq_count))
            out.write(b"\n")

    with open_output(params.opt_output, "--output") as out:
        report(out)
    if params.fp_log is not None:
        # log variant uses a single-line header (fastq_eestats2.cpp:204-208)
        params.fp_log.write(b"%d reads, max len %d, avg %.1f\n\n"
                            % (seq_count, longest,
                               symbols / seq_count if seq_count else 0.0))
        params.fp_log.write(b"Length")
        for cut in ee_cutoffs:
            params.fp_log.write(b"         MaxEE %.2f" % cut)
        params.fp_log.write(b"\n------" + b"   ----------------" * ncut
                            + b"\n")
        for x in range(len_steps):
            len_cutoff = shortest + x * increment
            if len_cutoff > longest_opt:
                break
            params.fp_log.write(b"%6d" % len_cutoff)
            for y in range(ncut):
                params.fp_log.write(b"   %8d(%5.1f%%)" % (
                    count_table[x, y],
                    100.0 * count_table[x, y] / seq_count))
            params.fp_log.write(b"\n")
