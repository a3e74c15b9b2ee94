"""fastx_getseq / fastx_getseqs / fastx_getsubseq — extract sequences whose
labels match.

reference: src/core/getseq.cpp (:321-581 main loop, :179-323 label matching).
--label/--labels match the whole header case-insensitively (or substring with
--label_substr_match); --label_word(s) are case-sensitive whole-word hits,
optionally constrained to a ';'-delimited "field=" context.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from ..params import Parameters
from ..io import fastx as fastx_io
from ..io.openfile import open_output


def _read_labels_file(filename: str, params: Parameters) -> List[bytes]:
    """reference: getseq.cpp read_labels_file (:102-177)."""
    labels: List[bytes] = []
    longest = 0
    with open(filename, "rb") as handle:
        for line in handle:
            # the reference reads 1023-char chunks; longer lines split
            for start in range(0, len(line), 1023):
                chunk = line[start:start + 1023]
                if chunk.endswith(b"\n"):
                    chunk = chunk[:-1]
                if chunk.endswith(b"\r"):
                    # reference keeps '\r'; we match its byte behavior
                    pass
                if not chunk:
                    continue
                longest = max(longest, len(chunk))
                labels.append(chunk)
    if longest >= 1023 and not params.opt_quiet:
        print("WARNING: Labels longer than 1023 characters are not supported",
              file=sys.stderr)
    return labels


def _isalnum(byte: int) -> bool:
    return chr(byte).isalnum() and byte < 128


def _word_hits(header: bytes, needle: bytes, field: Optional[bytes]) -> bool:
    """Whole-word (or whole-field) case-sensitive search
    (getseq.cpp:236-320)."""
    if field is not None:
        needle = field + b"=" + needle
    hlen = len(header)
    wlen = len(needle)
    pos = 0
    while True:
        hit = header.find(needle, pos)
        if hit < 0:
            return False
        end = hit + wlen
        if field is not None:
            if (hit == 0 or header[hit - 1] == ord(";")) and \
                    (end == hlen or header[end] == ord(";")):
                return True
        else:
            if (hit == 0 or not _isalnum(header[hit - 1])) and \
                    (end == hlen or not _isalnum(header[end])):
                return True
        pos = hit + 1


def _match(header: bytes, params: Parameters,
           labels: List[bytes]) -> bool:
    """reference: getseq.cpp test_label_match (:179-323)."""
    if params.opt_label is not None:
        needle = params.opt_label.encode()
        if params.opt_label_substr_match:
            return needle.upper() in header.upper()
        return header.upper() == needle.upper()
    if params.opt_labels is not None:
        if params.opt_label_substr_match:
            hu = header.upper()
            return any(lab.upper() in hu for lab in labels)
        hu = header.upper()
        return any(hu == lab.upper() for lab in labels)
    field = (params.opt_label_field.encode()
             if params.opt_label_field is not None else None)
    if params.opt_label_word is not None:
        return _word_hits(header, params.opt_label_word.encode(), field)
    if params.opt_label_words is not None:
        return any(_word_hits(header, lab, field) for lab in labels)
    return False


def getseq(params: Parameters, command: str) -> None:
    """reference: getseq.cpp getseq (:326-581)."""
    filename = getattr(params, "opt_" + command)
    if (params.opt_fastqout is None and params.opt_fastaout is None
            and params.opt_notmatched is None
            and params.opt_notmatchedfq is None):
        raise ValueError("No output files specified")

    labels: List[bytes] = []
    if command in ("fastx_getseq", "fastx_getsubseq"):
        if params.opt_label is None:
            raise ValueError("Missing label option")
        if command == "fastx_getsubseq":
            if params.opt_subseq_start < 1 or params.opt_subseq_end < 1:
                raise ValueError("The argument to options subseq_start and "
                                 "subseq_end must be at least 1")
            if params.opt_subseq_start > params.opt_subseq_end:
                raise ValueError("The argument to option subseq_start must "
                                 "be equal or less than to subseq_end")
    else:
        n_opts = sum(x is not None for x in (
            params.opt_label, params.opt_labels, params.opt_label_word,
            params.opt_label_words))
        if n_opts != 1:
            raise ValueError("Specify one label option (label, labels, "
                             "label_word or label_words)")
        if params.opt_labels is not None:
            labels = _read_labels_file(params.opt_labels, params)
        if params.opt_label_words is not None:
            labels = _read_labels_file(params.opt_label_words, params)

    is_fq = fastx_io.is_fastq(filename)
    if (params.opt_fastqout is not None
            or params.opt_notmatchedfq is not None) and not is_fq:
        raise ValueError("Cannot write FASTQ output from FASTA input")

    fp_fa = open_output(params.opt_fastaout, "--fastaout") if params.opt_fastaout else None
    fp_fq = open_output(params.opt_fastqout, "--fastqout") if params.opt_fastqout else None
    fp_nm = open_output(params.opt_notmatched, "--notmatched") \
        if params.opt_notmatched else None
    fp_nmfq = open_output(params.opt_notmatchedfq, "--notmatchedfq") \
        if params.opt_notmatchedfq else None

    kept = 0
    discarded = 0
    from ..utils.progress import Progress
    extract_progress = Progress("Extracting sequences", 1, params)
    try:
        for rec in fastx_io.read_fastx(filename, params):
            extract_progress.update()
            if _match(rec.header, params, labels):
                kept += 1
                start, end = 1, len(rec.sequence)
                if command == "fastx_getsubseq":
                    start = max(params.opt_subseq_start, start)
                    end = min(params.opt_subseq_end, end)
                if end < start:
                    seq, qual = b"", b""
                else:
                    seq = rec.sequence[start - 1:end]
                    qual = (rec.quality or b"")[start - 1:end]
                if fp_fa is not None:
                    fastx_io.fasta_print_general(fp_fa, params, seq,
                                                 rec.header, rec.abundance,
                                                 kept)
                if fp_fq is not None:
                    fastx_io.fastq_print_general(fp_fq, params, seq,
                                                 rec.header, qual,
                                                 rec.abundance, kept)
            else:
                discarded += 1
                if fp_nm is not None:
                    fastx_io.fasta_print_general(fp_nm, params, rec.sequence,
                                                 rec.header, rec.abundance,
                                                 discarded)
                if fp_nmfq is not None:
                    fastx_io.fastq_print_general(fp_nmfq, params,
                                                 rec.sequence, rec.header,
                                                 rec.quality or b"",
                                                 rec.abundance, discarded)
    finally:
        for h in (fp_fa, fp_fq, fp_nm, fp_nmfq):
            if h is not None:
                h.close()

    extract_progress.done()

    def report(out) -> None:
        total = kept + discarded
        msg = "%d of %d sequences extracted" % (kept, total)
        if total > 0:
            msg += " (%.1f%%)" % (100.0 * kept / total)
        print(msg, file=out)

    if not params.opt_quiet:
        report(sys.stderr)
    if params.fp_log is not None:
        import io as _io
        buf = _io.StringIO()
        report(buf)
        params.fp_log.write(buf.getvalue().encode())
