"""fastq_filter / fastx_filter commands.

reference: src/core/filter.cpp — per-read strip/truncate/quality analysis
pipeline routing kept/discarded reads to fasta/fastq outputs, paired-file
aware.
"""

from __future__ import annotations

import dataclasses
import sys
from contextlib import ExitStack
from typing import IO, Optional

from ..params import DBL_MAX, INT64_MIN_LONG, Parameters
from ..io import fastx as fastx_io


@dataclasses.dataclass
class AnalysisRes:
    discarded: bool = False
    truncated: bool = False
    start: int = 0
    length: int = 0
    ee: float = -1.0



_Q2P_CACHE = {}


def _q2p_table(params: Parameters):
    """256-entry raw-quality-symbol -> error-probability lookup."""
    import numpy as np
    key = params.opt_fastq_ascii
    tab = _Q2P_CACHE.get(key)
    if tab is None:
        q = np.arange(256, dtype=np.float64) - key
        tab = 10.0 ** (-q / 10.0)
        _Q2P_CACHE[key] = tab
    return tab


def analyse(rec: fastx_io.SeqRecord, is_fastq: bool,
            params: Parameters) -> AnalysisRes:
    """reference: filter.cpp analyse (:122-268)."""
    res = AnalysisRes()
    res.length = len(rec.sequence)
    old_length = res.length

    if params.opt_fastq_stripleft < res.length:
        res.start += params.opt_fastq_stripleft
        res.length -= params.opt_fastq_stripleft
    else:
        res.start = res.length
        res.length = 0

    if params.opt_fastq_stripright < res.length:
        res.length -= params.opt_fastq_stripright
    else:
        res.length = 0

    if params.opt_fastq_trunclen >= 0:
        res.length = min(res.length, params.opt_fastq_trunclen)
    if params.opt_fastq_trunclen_keep >= 0:
        res.length = min(res.length, params.opt_fastq_trunclen_keep)

    if is_fastq:
        # vectorized form of the reference per-base scan (filter.cpp
        # analyse quality loop): cumulative expected error with
        # truncqual / truncee / truncee_rate cut at the first violation
        import numpy as np
        res.ee = 0.0
        if res.length > 0:
            qual_u8 = np.frombuffer(rec.quality, dtype=np.uint8,
                                    count=res.length, offset=res.start)
            q_lo = int(qual_u8.min()) - params.opt_fastq_ascii
            q_hi = int(qual_u8.max()) - params.opt_fastq_ascii
            if q_lo < params.opt_fastq_qmin:
                qarr = qual_u8.astype(np.int64) - params.opt_fastq_ascii
                bad = qarr < params.opt_fastq_qmin
                raise SystemExit(
                    "\n\nFatal error: FASTQ quality value (%d) below qmin "
                    "(%d)" % (int(qarr[np.argmax(bad)]),
                              params.opt_fastq_qmin))
            if q_hi > params.opt_fastq_qmax:
                qarr = qual_u8.astype(np.int64) - params.opt_fastq_ascii
                bad = qarr > params.opt_fastq_qmax
                raise SystemExit(
                    "\n\nFatal error: FASTQ quality value (%d) above qmax "
                    "(%d)" % (int(qarr[np.argmax(bad)]),
                              params.opt_fastq_qmax))
            terms = _q2p_table(params)[qual_u8]
            ee_cum = np.cumsum(terms)
            truncqual_on = q_lo <= params.opt_fastq_truncqual
            truncee_on = (params.opt_fastq_truncee < DBL_MAX
                          or params.opt_fastq_truncee_rate < DBL_MAX)
            if truncqual_on or truncee_on:
                cut = (qual_u8.astype(np.int64) - params.opt_fastq_ascii
                       <= params.opt_fastq_truncqual)
                if params.opt_fastq_truncee < DBL_MAX:
                    cut |= ee_cum > params.opt_fastq_truncee
                if params.opt_fastq_truncee_rate < DBL_MAX:
                    cut |= (ee_cum > params.opt_fastq_truncee_rate
                            * np.arange(1, res.length + 1))
                has_cut = bool(cut.any())
            else:
                has_cut = False
            if has_cut:
                trunc_at = int(np.argmax(cut))
                # float-exact replay of the reference's `ee += e; ee -= e`
                # at the truncation base (filter.cpp analyse loop)
                res.ee = float(ee_cum[trunc_at]) - float(terms[trunc_at])
            else:
                trunc_at = res.length
                res.ee = float(ee_cum[-1])
            if q_lo < params.opt_fastq_minqual:
                qarr = (qual_u8[:trunc_at].astype(np.int64)
                        - params.opt_fastq_ascii)
                if (qarr < params.opt_fastq_minqual).any():
                    res.discarded = True
            res.length = trunc_at
        if res.ee > params.opt_fastq_maxee:
            res.discarded = True
        if res.length > 0 and res.ee / res.length > params.opt_fastq_maxee_rate:
            res.discarded = True

    if params.opt_fastq_trunclen >= 0 and res.length < params.opt_fastq_trunclen:
        res.discarded = True
    if res.length < params.opt_fastq_minlen:
        res.discarded = True
    if res.length > params.opt_fastq_maxlen:
        res.discarded = True

    ncount = rec.sequence.count(b"N", res.start, res.start + res.length) + \
        rec.sequence.count(b"n", res.start, res.start + res.length)
    if ncount > params.opt_fastq_maxns:
        res.discarded = True

    if rec.abundance < params.opt_minsize:
        res.discarded = True
    if rec.abundance > params.opt_maxsize:
        res.discarded = True

    res.truncated = res.length < old_length
    return res


from ..io.openfile import open_output_opt as _open  # noqa: E402


def _filter_arrays(params, filename, fp_fastaout, fp_fastqout,
                   fp_fastaout_d, fp_fastqout_d, read_progress) -> bool:
    """Buffer-level single-file FASTQ filter: native scan -> one OpenMP
    analysis call (float-exact per-read EE accumulation) -> bulk record
    emission.  Returns False when the native scanner or the
    passthrough-header fast path does not apply."""
    import numpy as np
    from .. import native
    from .mergepairs import _plain_headers
    from ..params import INT64_MAX

    if not (native.available() and _plain_headers(params)):
        return False
    arrays = fastx_io.scan_fastq_arrays(filename, params=params,
                                        truncateatspace=False)
    if arrays is None:
        return False
    (data, n, seq_buf, qual_buf, seq_off, head_off, head_len, sizes) = arrays

    iparams = [params.opt_fastq_stripleft, params.opt_fastq_stripright,
               params.opt_fastq_trunclen, params.opt_fastq_trunclen_keep,
               params.opt_fastq_truncqual, params.opt_fastq_maxns,
               params.opt_fastq_minlen,
               min(params.opt_fastq_maxlen, INT64_MAX),
               params.opt_fastq_ascii, params.opt_fastq_qmin,
               params.opt_fastq_qmax, params.opt_fastq_minqual, 1,
               params.opt_minsize, min(params.opt_maxsize, INT64_MAX)]
    dparams = [params.opt_fastq_truncee, params.opt_fastq_truncee_rate,
               params.opt_fastq_maxee, params.opt_fastq_maxee_rate]
    res = native.filter_analyse(seq_buf, qual_buf, seq_off, n, sizes,
                                iparams, dparams, _q2p_table(params))
    if res is None:
        return False
    start, length, ee, flags, fatal = res
    if fatal[0] >= 0:
        if fatal[2]:
            raise SystemExit(
                "\n\nFatal error: FASTQ quality value (%d) below qmin "
                "(%d)" % (int(fatal[1]), params.opt_fastq_qmin))
        raise SystemExit(
            "\n\nFatal error: FASTQ quality value (%d) above qmax "
            "(%d)" % (int(fatal[1]), params.opt_fastq_qmax))

    read_progress.update(n)
    disc = (flags & 1) != 0
    kept_sel = np.nonzero(~disc)[0].astype(np.int32)
    disc_sel = np.nonzero(disc)[0].astype(np.int32)
    kept = int(kept_sel.size)
    discarded = int(disc_sel.size)
    truncated = int(((flags & 2) != 0)[kept_sel].sum())

    rec_start = seq_off[:n] + start
    width = int(params.opt_fasta_width)
    if fp_fastaout is not None:
        fp_fastaout.write(native.emit_fasta(
            data, head_off, head_len, seq_buf, rec_start, length, kept_sel,
            width))
    if fp_fastqout is not None:
        fp_fastqout.write(native.emit_fastq(
            data, head_off, head_len, seq_buf, qual_buf, rec_start, length,
            kept_sel))
    if fp_fastaout_d is not None:
        fp_fastaout_d.write(native.emit_fasta(
            data, head_off, head_len, seq_buf, rec_start, length, disc_sel,
            width))
    if fp_fastqout_d is not None:
        fp_fastqout_d.write(native.emit_fastq(
            data, head_off, head_len, seq_buf, qual_buf, rec_start, length,
            disc_sel))

    read_progress.done()
    from ..utils.progress import message_both
    message_both(params,
                 "%d sequences kept (of which %d truncated), %d "
                 "sequences discarded.\n" % (kept, truncated, discarded))
    return True


def filter_command(params: Parameters, command: str) -> None:
    """reference: filter.cpp filter() (:264-520)."""
    fastq_only = command == "fastq_filter"
    filename = getattr(params, "opt_" + command)

    if all(getattr(params, "opt_" + o) is None for o in (
            "fastqout", "fastaout", "fastqout_discarded",
            "fastaout_discarded", "fastqout_rev", "fastaout_rev",
            "fastqout_discarded_rev", "fastaout_discarded_rev")):
        raise ValueError("No output files specified")

    is_fastq = fastx_io.is_fastq(filename)
    if not is_fastq:
        if fastq_only:
            raise ValueError(
                "FASTA input files not allowed with fastq_filter, consider "
                "using fastx_filter command instead")
        if (params.opt_eeout or params.opt_fastq_ascii != 33
                or params.opt_fastq_eeout
                or params.opt_fastq_maxee < DBL_MAX
                or params.opt_fastq_maxee_rate < DBL_MAX
                or params.opt_fastqout is not None
                or params.opt_fastq_qmax < 41 or params.opt_fastq_qmin > 0
                or params.opt_fastq_truncee < DBL_MAX
                or params.opt_fastq_truncee_rate < DBL_MAX
                # note: the reference tests truncqual < LONG_MIN, which can
                # never hold (filter.cpp:297) — replicated by omission
                or params.opt_fastq_minqual > 0
                or params.opt_fastqout_discarded is not None
                or params.opt_fastqout_discarded_rev is not None
                or params.opt_fastqout_rev is not None):
            raise ValueError(
                "The following options are not accepted with the "
                "fastx_filter command when the input is a FASTA file, "
                "because quality scores are not available: eeout, "
                "fastq_ascii, fastq_eeout, fastq_maxee, fastq_maxee_rate, "
                "fastq_minqual, fastq_out, fastq_qmax, fastq_qmin, "
                "fastq_truncee, fastq_truncee_rate, fastq_truncqual,  "
                "fastqout_discarded, fastqout_discarded_rev, fastqout_rev")

    reverse_reader = None
    if params.opt_reverse is not None:
        if fastx_io.is_fastq(params.opt_reverse) != is_fastq:
            raise ValueError("The forward and reverse input sequence must in "
                             "the same format, either FASTA or FASTQ")
        reverse_reader = fastx_io.read_fastx(params.opt_reverse, params,
                                             truncateatspace=False)

    with ExitStack() as stack:
        fp_fastaout = _open(stack, params.opt_fastaout, "--fastaout")
        fp_fastqout = _open(stack, params.opt_fastqout, "--fastqout")
        fp_fastaout_d = _open(stack, params.opt_fastaout_discarded, "--fastaout_discarded")
        fp_fastqout_d = _open(stack, params.opt_fastqout_discarded, "--fastqout_discarded")
        fp_fastaout_rev = fp_fastqout_rev = None
        fp_fastaout_d_rev = fp_fastqout_d_rev = None
        if reverse_reader is not None:
            fp_fastaout_rev = _open(stack, params.opt_fastaout_rev, "--fastaout_rev")
            fp_fastqout_rev = _open(stack, params.opt_fastqout_rev, "--fastqout_rev")
            fp_fastaout_d_rev = _open(stack, params.opt_fastaout_discarded_rev, "--fastaout_discarded_rev")
            fp_fastqout_d_rev = _open(stack, params.opt_fastqout_discarded_rev, "--fastqout_discarded_rev")

        kept = 0
        discarded = 0
        truncated = 0

        # filter reads with truncateatspace=False (filter.cpp:358)
        from ..utils.progress import Progress
        read_progress = Progress("Reading input file", 1, params)

        if reverse_reader is None and is_fastq and _filter_arrays(
                params, filename, fp_fastaout, fp_fastqout, fp_fastaout_d,
                fp_fastqout_d, read_progress):
            return
        for rec1 in fastx_io.read_fastx(filename, params,
                                        truncateatspace=False):
            read_progress.update()
            rec2 = None
            if reverse_reader is not None:
                try:
                    rec2 = next(reverse_reader)
                except StopIteration:
                    raise ValueError("More forward reads than reverse reads")
            res1 = analyse(rec1, is_fastq, params)
            res2 = analyse(rec2, is_fastq, params) if rec2 is not None \
                else AnalysisRes()

            def emit(fa, fq, rec, res, ordinal):
                seq = rec.sequence[res.start:res.start + res.length]
                if fa is not None:
                    fastx_io.fasta_print_general(fa, params, seq, rec.header,
                                                 rec.abundance, ordinal,
                                                 res.ee)
                if fq is not None:
                    qual = rec.quality[res.start:res.start + res.length]
                    fastx_io.fastq_print_general(fq, params, seq, rec.header,
                                                 qual, rec.abundance, ordinal,
                                                 res.ee)

            if res1.discarded or res2.discarded:
                discarded += 1
                emit(fp_fastaout_d, fp_fastqout_d, rec1, res1, discarded)
                if rec2 is not None:
                    emit(fp_fastaout_d_rev, fp_fastqout_d_rev, rec2, res2,
                         discarded)
            else:
                kept += 1
                if res1.truncated or res2.truncated:
                    truncated += 1
                emit(fp_fastaout, fp_fastqout, rec1, res1, kept)
                if rec2 is not None:
                    emit(fp_fastaout_rev, fp_fastqout_rev, rec2, res2, kept)

        read_progress.done()
        from ..utils.progress import message_both
        message_both(params,
                     "%d sequences kept (of which %d truncated), %d "
                     "sequences discarded.\n" % (kept, truncated, discarded))
