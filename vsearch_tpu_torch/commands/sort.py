"""sortbysize / sortbylength / shuffle commands.

reference: src/commands/sortbysize.cpp, sortbylength.cpp, shuffle.cpp.
"""

from __future__ import annotations

import sys
from typing import List

from ..params import Parameters
from ..db import Database
from ..io import fastx as fastx_io
from ..utils.random import MT19937_64, random_base_seed, random_shuffle
from ..utils.progress import Progress, message_both, phase
from ..io.openfile import open_output_ctx


def _print_db_relabel(out, params: Parameters, db, seqno: int,
                      ordinal: int) -> None:
    """reference: fasta.cpp fasta_print_db_relabel (:629-648)."""
    fastx_io.fasta_print_general(out, params, db.getsequence(seqno),
                                 db.getheader(seqno), db.getabundance(seqno),
                                 ordinal)


def _median_msg(sizes: List[int], params: Parameters) -> None:
    if not sizes:
        median = 0.0
    else:
        mid = len(sizes) // 2
        if len(sizes) % 2 != 0:
            median = float(sizes[mid])
        else:
            median = sizes[mid] + (sizes[mid - 1] - sizes[mid]) * 0.5
    message_both(params, "Median abundance: %.0f\n" % median)


def sortbysize(params: Parameters) -> None:
    """reference: sortbysize.cpp (:238-256); deck filtered by
    minsize/maxsize, stable sort by (size desc, label asc), topn cut."""
    # reference opens --output before reading the database
    # (sortbysize.cpp open_mandatory_output_file precedes db.read)
    out_ctx = open_output_ctx(params.opt_output, "--output")
    db = Database()
    db.read(params.opt_sortbysize, params)
    phase(params, "Getting sizes")
    deck = [i for i in range(db.seqcount)
            if params.opt_minsize <= db.getabundance(i) <= params.opt_maxsize]
    with Progress("Sorting", 1, params):
        deck.sort(key=lambda i: (-db.getabundance(i), db.getheader(i), i))
    _median_msg([db.getabundance(i) for i in deck], params)
    deck = deck[:params.opt_topn]
    with out_ctx as out, \
            Progress("Writing output", len(deck), params) as prog:
        for ordinal, seqno in enumerate(deck, 1):
            prog.update()
            _print_db_relabel(out, params, db, seqno, ordinal)


def sortbylength(params: Parameters) -> None:
    """reference: sortbylength.cpp — stable sort by (length desc, size desc,
    label asc), topn cut (no min/max size filter)."""
    # reference opens --output before reading the database
    # (sortbylength.cpp open_mandatory_output_file precedes db.read)
    out_ctx = open_output_ctx(params.opt_output, "--output")
    db = Database()
    db.read(params.opt_sortbylength, params)
    phase(params, "Getting lengths")
    deck = list(range(db.seqcount))
    with Progress("Sorting", 1, params):
        deck.sort(key=lambda i: (-db.getsequencelen(i), -db.getabundance(i),
                                 db.getheader(i), i))
    # median of deck lengths (sortbylength.cpp:137-173)
    lens = [db.getsequencelen(i) for i in deck]
    if not lens:
        median = 0.0
    else:
        mid = len(lens) // 2
        median = (float(lens[mid]) if len(lens) % 2 else
                  lens[mid] + (lens[mid - 1] - lens[mid]) * 0.5)
    message_both(params, "Median length: %.0f\n" % median)
    deck = deck[:params.opt_topn]
    with out_ctx as out, \
            Progress("Writing output", len(deck), params) as prog:
        for ordinal, seqno in enumerate(deck, 1):
            prog.update()
            _print_db_relabel(out, params, db, seqno, ordinal)


def shuffle(params: Parameters) -> None:
    """reference: shuffle.cpp — Fisher-Yates with mt19937_64(randseed)."""
    # reference opens --output before reading the database
    # (shuffle.cpp open_mandatory_output_file precedes db.read)
    out_ctx = open_output_ctx(params.opt_output, "--output")
    db = Database()
    db.read(params.opt_shuffle, params)
    deck = list(range(db.seqcount))
    gen = MT19937_64(random_base_seed(params))
    with Progress("Shuffling", 1, params):
        random_shuffle(deck, gen)
    deck = deck[:params.opt_topn]
    with out_ctx as out, \
            Progress("Writing output", len(deck), params) as prog:
        for ordinal, seqno in enumerate(deck, 1):
            prog.update()
            _print_db_relabel(out, params, db, seqno, ordinal)
