"""FASTA/FASTQ utility commands: fastx_mask, maskfasta, fastx_revcomp,
fastx_subsample, rereplicate.

reference: src/commands/{fastx_mask,maskfasta,fastx_revcomp,
fastx_subsample,rereplicate}.cpp
"""

from __future__ import annotations

import sys
from contextlib import ExitStack
from typing import IO, Optional

from ..params import Masking, Parameters
from ..db import Database
from ..io import fastx as fastx_io
from ..core import mask as mask_mod
from ..utils.maps import reverse_complement
from ..utils.random import MT19937_64, random_base_seed


from ..io.openfile import open_output_opt as _open  # noqa: E402


def fastx_mask(params: Parameters) -> None:
    """reference: fastx_mask.cpp (:70-200)."""
    if params.opt_fastaout is None and params.opt_fastqout is None:
        raise ValueError("Specify output files for masking with --fastaout "
                         "and/or --fastqout")
    with ExitStack() as stack:
        fp_fastaout = _open(stack, params.opt_fastaout, "--fastaout")
        fp_fastqout = _open(stack, params.opt_fastqout, "--fastqout")
        db = Database()
        db.read(params.opt_fastx_mask, params)
        if fp_fastqout is not None and not db.fastq_format:
            raise ValueError("Cannot write FASTQ output with a FASTA input "
                             "file, lacking quality scores")
        if params.opt_qmask == Masking.dust:
            mask_mod.dust_all(db, params)
        elif params.opt_qmask == Masking.soft and params.opt_hardmask:
            mask_mod.hardmask_all(db)

        from ..utils.progress import Progress, message_both
        kept = 0
        wprog = Progress("Writing output", db.seqcount, params)
        for i in range(db.seqcount):
            wprog.update()
            seq = db.getsequence(i)
            length = len(seq)
            if params.opt_qmask == Masking.none:
                unmasked = length
            elif params.opt_hardmask:
                unmasked = length - seq.count(b"N")
            else:
                unmasked = sum(1 for c in seq if 65 <= c <= 90)
            unmasked_pct = 100.0 * unmasked / length if length else 0.0
            if unmasked_pct < params.opt_min_unmasked_pct:
                continue
            if unmasked_pct > params.opt_max_unmasked_pct:
                continue
            kept += 1
            if fp_fastaout is not None:
                fastx_io.fasta_print_general(fp_fastaout, params, seq,
                                             db.getheader(i),
                                             db.getabundance(i), kept)
            if fp_fastqout is not None:
                fastx_io.fastq_print_general(fp_fastqout, params, seq,
                                             db.getheader(i),
                                             db.getquality(i) or b"",
                                             db.getabundance(i), kept)
        wprog.done()
        message_both(params, "%d sequences kept\n" % kept)


def maskfasta(params: Parameters) -> None:
    """reference: maskfasta.cpp (:66-100)."""
    with ExitStack() as stack:
        out = _open(stack, params.opt_output, "--output")
        db = Database()
        db.read(params.opt_maskfasta, params)
        if params.opt_qmask == Masking.dust:
            mask_mod.dust_all(db, params)
        elif params.opt_qmask == Masking.soft and params.opt_hardmask:
            mask_mod.hardmask_all(db)
        from ..utils.progress import Progress
        with Progress("Writing output", db.seqcount, params) as prog:
            for i in range(db.seqcount):
                prog.update()
                fastx_io.fasta_print_general(out, params, db.getsequence(i),
                                             db.getheader(i),
                                             db.getabundance(i), i + 1)


def fastx_revcomp(params: Parameters) -> None:
    """reference: fastx_revcomp.cpp (:76-200); headers untruncated."""
    if params.opt_fastaout is None and params.opt_fastqout is None:
        raise ValueError("No output files specified")
    is_fq = fastx_io.is_fastq(params.opt_fastx_revcomp)
    if params.opt_fastqout is not None and not is_fq:
        raise ValueError("Cannot write FASTQ output with a FASTA input "
                         "file, lacking quality scores")
    with ExitStack() as stack:
        fp_fastaout = _open(stack, params.opt_fastaout, "--fastaout")
        fp_fastqout = _open(stack, params.opt_fastqout, "--fastqout")
        from ..utils.progress import Progress
        count = 0
        rc_progress = Progress(
            "Reading FASTQ file" if is_fq else "Reading FASTA file", 1,
            params)
        if (fp_fastqout is None and not is_fq
                and fastx_io._plain_fasta_emit(params)
                and _revcomp_fast(params, fp_fastaout)):
            rc_progress.done()
            return
        for rec in fastx_io.read_fastx(params.opt_fastx_revcomp, params,
                                       truncateatspace=False):
            rc_progress.update()
            count += 1
            seq = reverse_complement(rec.sequence)
            qual = rec.quality[::-1] if rec.quality is not None else None
            if fp_fastaout is not None:
                fastx_io.fasta_print_general(fp_fastaout, params, seq,
                                             rec.header, rec.abundance,
                                             count)
            if fp_fastqout is not None:
                fastx_io.fastq_print_general(fp_fastqout, params, seq,
                                             rec.header, qual or b"",
                                             rec.abundance, count)
        rc_progress.done()


def _revcomp_fast(params: Parameters, out) -> bool:
    """Buffer-level FASTA reverse-complement: one native scan, one
    complement LUT over the whole packed buffer, one global reversal
    (record i's reverse-complement is the reversed buffer's slice at the
    mirrored offsets — no per-record work), one native bulk emit."""
    from .. import native
    import numpy as np
    from ..utils.maps import CHRMAP_COMPLEMENT
    if not native.available():
        return False
    with fastx_io.open_maybe_compressed(params.opt_fastx_revcomp) as fh:
        data = fh.read()
    res = native.scan_fasta(data, False, False)
    if res is None:
        return False
    nrec, seq_out, seq_off, head_off, head_len, sizes, stripped = res
    total = int(seq_off[nrec])
    rc_buf = np.ascontiguousarray(CHRMAP_COMPLEMENT[seq_out[:total]][::-1])
    rc_start = total - seq_off[1:nrec + 1]
    rec_len = np.diff(seq_off[:nrec + 1])
    data_arr = np.frombuffer(data, dtype=np.uint8)
    CHUNK = 65536
    for lo in range(0, max(nrec, 1), CHUNK):
        sel = np.arange(lo, min(lo + CHUNK, nrec), dtype=np.int32)
        blob = native.emit_fasta(data_arr, head_off[:nrec],
                                 head_len[:nrec], rc_buf, rc_start,
                                 rec_len, sel,
                                 int(params.opt_fasta_width))
        if blob is None:
            return False
        out.write(blob)
    fastx_io._warn_stripped(params, stripped.astype(np.int64), False)
    return True


def rereplicate(params: Parameters) -> None:
    """reference: rereplicate.cpp (:77-139)."""
    from ..io.attributes import header_get_size
    with ExitStack() as stack:
        out = _open(stack, params.opt_output, "--output")
        n_amplicons = 0
        n_reads = 0
        missing = False
        from ..utils.progress import Progress
        rprog = Progress("Rereplicating", 1, params)
        for rec in fastx_io.read_fastx(params.opt_rereplicate, params):
            rprog.update()
            n_amplicons += 1
            abundance = header_get_size(rec.header)
            if abundance == 0:
                missing = True
                abundance = 1
            for _ in range(abundance):
                n_reads += 1
                fastx_io.fasta_print_general(out, params, rec.sequence,
                                             rec.header, 1, n_reads)
        rprog.done()
        from ..utils.progress import message_both
        if missing:
            message_both(params,
                         "WARNING: Missing abundance information for some "
                         "input sequences, assumed 1\n")
        message_both(params, "Rereplicated %d reads from %d amplicons\n"
                     % (n_reads, n_amplicons))


def fastx_subsample(params: Parameters) -> None:
    """reference: fastx_subsample.cpp subsample() (:355-401) — mass-based
    random subsampling with the reproducible mt19937_64 stream."""
    from ..utils.random import random_bounded

    db = Database()
    db.read(params.opt_fastx_subsample, params)
    if (params.opt_fastqout is not None
            or params.opt_fastqout_discarded is not None) \
            and not db.fastq_format:
        raise ValueError("Cannot write FASTQ output with a FASTA input "
                         "file, lacking quality scores")

    original = [db.getabundance(i) if params.opt_sizein else 1
                for i in range(db.seqcount)]
    mass_total = sum(original)
    subsampled = [0] * db.seqcount

    from ..utils.progress import Progress, message_both
    message_both(params, "Got %d reads from %d amplicons\n"
                 % (mass_total, db.seqcount))

    if params.opt_sample_size != 0:
        n_reads = params.opt_sample_size
    else:
        n_reads = int(mass_total * params.opt_sample_pct / 100.0)
    if n_reads > mass_total:
        raise ValueError("Cannot subsample more reads than in the original "
                         "sample")

    # random_subsampling (:221-263): one uniform draw per read slot, loop
    # exits as soon as the requested count is reached (RNG-stream exact)
    gen = MT19937_64(random_base_seed(params))
    subsample_progress = Progress("Subsampling", mass_total, params)
    n_reads_left = n_reads
    amplicon_number = 0
    n_read_being_checked = 0
    accumulated_mass = 0
    amplicon_mass = original[0] if original else 0
    while n_reads_left > 0:
        random = random_bounded(gen, mass_total - n_read_being_checked)
        if random < n_reads_left:
            subsampled[amplicon_number] += 1
            n_reads_left -= 1
        n_read_being_checked += 1
        accumulated_mass += 1
        if accumulated_mass >= amplicon_mass:
            amplicon_number += 1
            if amplicon_number < db.seqcount:
                amplicon_mass = original[amplicon_number]
            accumulated_mass = 0

    subsample_progress.done()

    def write_deck(deck, fp_fasta, fp_fastq):
        printed = 0
        for i, ab in enumerate(deck):
            if ab == 0:
                continue
            printed += 1
            if fp_fasta is not None:
                fastx_io.fasta_print_general(fp_fasta, params,
                                             db.getsequence(i),
                                             db.getheader(i), ab, printed)
            if fp_fastq is not None:
                fastx_io.fastq_print_general(fp_fastq, params,
                                             db.getsequence(i),
                                             db.getheader(i),
                                             db.getquality(i) or b"", ab,
                                             printed)

    with ExitStack() as stack:
        fp_fastaout = _open(stack, params.opt_fastaout, "--fastaout")
        fp_fastqout = _open(stack, params.opt_fastqout, "--fastqout")
        fp_fastaout_d = _open(stack, params.opt_fastaout_discarded, "--fastaout_discarded")
        fp_fastqout_d = _open(stack, params.opt_fastqout_discarded, "--fastqout_discarded")
        if fp_fastaout is not None:
            with Progress("Writing fasta output", 1, params):
                write_deck(subsampled, fp_fastaout, None)
        if fp_fastqout is not None:
            with Progress("Writing fastq output", 1, params):
                write_deck(subsampled, None, fp_fastqout)
        if fp_fastaout_d is not None or fp_fastqout_d is not None:
            discarded = [o - s for o, s in zip(original, subsampled)]
            if fp_fastaout_d is not None:
                with Progress("Writing fasta output", 1, params):
                    write_deck(discarded, fp_fastaout_d, None)
            if fp_fastqout_d is not None:
                with Progress("Writing fastq output", 1, params):
                    write_deck(discarded, None, fp_fastqout_d)

    samples = sum(1 for s in subsampled if s)
    message_both(params, "Subsampled %d reads from %d amplicons\n"
                 % (n_reads, samples))
