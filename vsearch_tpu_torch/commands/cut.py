"""cut command: split sequences at IUPAC restriction-site pattern matches.

reference: src/commands/cut.cpp — pattern carries '^' (forward cut) and '_'
(reverse cut); a site matches when every coded pattern nibble overlaps the
sequence nibble (maps.cpp is_equivalent_4bit_rhs, :424-428).
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from ..params import Parameters
from ..io import fastx as fastx_io
from ..utils.maps import CHRMAP_4BIT, reverse_complement


def cut(params: Parameters) -> None:
    if (params.opt_fastaout is None
            and params.opt_fastaout_discarded is None
            and params.opt_fastaout_rev is None
            and params.opt_fastaout_discarded_rev is None):
        raise ValueError("No output files specified")

    raw = params.opt_cut_pattern or ""
    if raw.count("^") == 0:
        raise ValueError("No forward sequence cut site (^) found in pattern")
    if raw.count("^") > 1:
        raise ValueError("Multiple cut sites not supported")
    if raw.count("_") == 0:
        raise ValueError("No reverse sequence cut site (_) found in pattern")
    if raw.count("_") > 1:
        raise ValueError("Multiple cut sites not supported")
    cut_fwd = raw.replace("_", "").index("^")
    cut_rev = raw.replace("^", "").index("_")
    pattern = raw.replace("^", "").replace("_", "")
    if not pattern:
        raise ValueError("Empty cut pattern string")
    coded = CHRMAP_4BIT[np.frombuffer(pattern.encode(), dtype=np.uint8)]
    if (coded == 0).any():
        raise ValueError("Illegal character in cut pattern")
    plen = len(pattern)

    from ..io.openfile import open_output

    def _open(path: Optional[str]):
        return open_output(path) if path else None

    fp_cut = _open(params.opt_fastaout)
    fp_cut_rev = _open(params.opt_fastaout_rev)
    fp_disc = _open(params.opt_fastaout_discarded)
    fp_disc_rev = _open(params.opt_fastaout_discarded_rev)

    n_cut = n_uncut = n_matches = 0
    frag_no = frag_rev_no = disc_no = disc_rev_no = 0
    from ..utils.progress import Progress
    cut_progress = Progress("Cutting sequences", 1, params)
    try:
        for rec in fastx_io.read_fastx(params.opt_cut, params,
                                       truncateatspace=False):
            cut_progress.update()
            seq = rec.sequence
            slen = len(seq)
            seq4 = CHRMAP_4BIT[np.frombuffer(seq, dtype=np.uint8)]
            rc = reverse_complement(seq)

            if slen >= plen:
                win = np.lib.stride_tricks.sliding_window_view(seq4, plen)
                hits = np.flatnonzero(((win & coded) != 0).all(axis=1))
            else:
                hits = np.array([], dtype=np.int64)

            frag_start = 0
            rc_start = slen
            for i in hits.tolist():
                frag_length = i + cut_fwd - frag_start
                rc_length = rc_start - (slen - (i + cut_rev))
                rc_start -= rc_length
                if frag_length > 0 and fp_cut is not None:
                    frag_no += 1
                    fastx_io.fasta_print_general(
                        fp_cut, params, seq[frag_start:frag_start
                                            + frag_length],
                        rec.header, rec.abundance, frag_no)
                if rc_length > 0 and fp_cut_rev is not None:
                    frag_rev_no += 1
                    fastx_io.fasta_print_general(
                        fp_cut_rev, params, rc[rc_start:rc_start + rc_length],
                        rec.header, rec.abundance, frag_rev_no)
                frag_start += frag_length

            if len(hits):
                n_cut += 1
                n_matches += len(hits)
                frag_length = slen - frag_start
                if frag_length > 0 and fp_cut is not None:
                    frag_no += 1
                    fastx_io.fasta_print_general(
                        fp_cut, params, seq[frag_start:], rec.header,
                        rec.abundance, frag_no)
                if rc_start > 0 and fp_cut_rev is not None:
                    frag_rev_no += 1
                    fastx_io.fasta_print_general(
                        fp_cut_rev, params, rc[:rc_start], rec.header,
                        rec.abundance, frag_rev_no)
            else:
                n_uncut += 1
                if fp_disc is not None:
                    disc_no += 1
                    fastx_io.fasta_print_general(fp_disc, params, seq,
                                                 rec.header, rec.abundance,
                                                 disc_no)
                if fp_disc_rev is not None:
                    disc_rev_no += 1
                    fastx_io.fasta_print_general(fp_disc_rev, params, rc,
                                                 rec.header, rec.abundance,
                                                 disc_rev_no)
    finally:
        for h in (fp_cut, fp_cut_rev, fp_disc, fp_disc_rev):
            if h is not None:
                h.close()

    # reference quirk (cut.cpp:451-466): the summary is printed while the
    # "Cutting sequences" progress is still open, so the " 100%" tail lands
    # after the summary line
    msg = ("%d sequence(s) cut %d times, %d sequence(s) never cut.\n"
           % (n_cut, n_matches, n_uncut))
    if not params.opt_quiet:
        sys.stderr.write(msg)
    cut_progress.done()
    if params.fp_log is not None:
        params.fp_log.write(msg.encode())
