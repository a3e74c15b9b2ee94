"""sintax command: naive-Bayes-like bootstrapped taxonomy classifier.

reference: src/commands/sintax.cpp — 100 bootstraps of up to 32 distinct
random query k-mers, top DB hit per bootstrap via the shared-kmer counter
(ties: shortest, then lowest seqno; or random with --sintax_random),
rank-wise consensus voting with prefix constraint.
"""

from __future__ import annotations

from contextlib import ExitStack
from typing import List

import numpy as np

from ..params import Masking, Parameters
from ..index import KmerIndex
from ..io import fastx as fastx_io
from ..ops import kmer as kmer_ops
from ..core.tax import tax_split, TAX_LEVELS, TAXONOMIC_FIELDS
from ..utils.maps import reverse_complement
from ..utils.random import (SplitMix64, random_base_seed, random_bounded,
                            random_substream_seed)
from ..io.openfile import open_output

SUBSET_SIZE = 32
BOOTSTRAP_COUNT = 100


def _search_topscore(index: KmerIndex, db, kmers: np.ndarray,
                     rng: SplitMix64, params: Parameters):
    """reference: sintax.cpp sintax_search_topscores (:299-402)."""
    if not params.opt_sintax_random:
        # best by (count desc, length asc, seqno asc) with count > 1 —
        # exactly the candidate heap's total order
        cands = index.candidates_for_query(kmers, 1, 2)
        if cands:
            seqno, count = cands[0]
            return count, seqno
        return None
    counts = index.counts_for_query(kmers)
    best_count = 0
    best_seqno = 0
    best_length = 0
    tophit_count = 0
    for i in range(index.count):
        count = int(counts[i])
        seqno = index.mapping[i]
        length = index.lengths[i]
        if count > best_count:
            best_count, best_seqno, best_length = count, seqno, length
            tophit_count = 1
        elif count == best_count:
            if params.opt_sintax_random:
                tophit_count += 1
                if random_bounded(rng, tophit_count) == 0:
                    best_seqno, best_length = seqno, length
            else:
                if length < best_length:
                    best_seqno, best_length = seqno, length
                elif length == best_length:
                    best_seqno = min(seqno, best_seqno)
    if best_count > 1:
        return best_count, best_seqno
    return None


def _analyse(params: Parameters, db, out, query_head: bytes, strand: int,
             all_seqno: List[int], stats, tax_cache: dict) -> None:
    """reference: sintax.cpp sintax_analyse (:139-296)."""
    count = len(all_seqno)
    is_enough = count >= (BOOTSTRAP_COUNT + 1) // 2

    level_best = [-1] * TAX_LEVELS
    level_matchcount = [0] * TAX_LEVELS
    cand_names: List[List[bytes]] = []

    if is_enough:
        for seqno in all_seqno:
            names = tax_cache.get(seqno)
            if names is None:
                names = tax_split(db.getheader(seqno))
                tax_cache[seqno] = names
            cand_names.append(names)
        # vectorized replay of the reference's O(count^2) vote loops:
        # per level, cand_match[i] = first included j <= i with the same
        # name; winner = first index with the max match count; the next
        # level keeps only candidates matching the winner
        included = np.ones(count, dtype=bool)
        lower = np.tril(np.ones((count, count), dtype=bool))
        for k in range(TAX_LEVELS):
            name_ids: dict = {}
            ids = np.fromiter(
                (name_ids.setdefault(cand_names[i][k], len(name_ids))
                 for i in range(count)), dtype=np.int64, count=count)
            eq = (ids[:, None] == ids[None, :]) & included[None, :] & lower
            match = np.where(included, np.argmax(eq, axis=1), -1)
            matchcount = np.bincount(match[included], minlength=count)
            level_matchcount[k] = int(matchcount.max(initial=0))
            if level_matchcount[k] > 0:
                level_best[k] = int(np.argmax(matchcount))
            else:
                level_best[k] = -1
            included = match == level_best[k]

    out.write(query_head + b"\t")
    stats["queries"] += 1
    if is_enough:
        stats["classified"] += 1
        comma = False
        for k in range(TAX_LEVELS):
            best = level_best[k]
            name = cand_names[best][k]
            if len(name) > 0:
                out.write((b"," if comma else b"")
                          + TAXONOMIC_FIELDS[k:k + 1] + b":" + name
                          + b"(%.2f)" % (1.0 * level_matchcount[k] / count))
                comma = True
        out.write(b"\t%c" % (ord("-") if strand else ord("+")))
        if params.opt_sintax_cutoff > 0.0:
            out.write(b"\t")
            comma = False
            for k in range(TAX_LEVELS):
                best = level_best[k]
                name = cand_names[best][k]
                if (len(name) > 0 and 1.0 * level_matchcount[k] / count
                        >= params.opt_sintax_cutoff):
                    out.write((b"," if comma else b"")
                              + TAXONOMIC_FIELDS[k:k + 1] + b":" + name)
                    comma = True
    else:
        out.write(b"\t\t" if params.opt_sintax_cutoff > 0.0 else b"\t")
    out.write(b"\n")


def sintax(params: Parameters) -> None:
    if params.opt_tabbedout is None:
        # reference: open_mandatory_output_file (open_file.cpp:140-143)
        raise ValueError("output file must be specified with --tabbedout")

    with ExitStack() as stack:
        # reference opens --tabbedout before the database (sintax.cpp:704)
        out = stack.enter_context(
            open_output(params.opt_tabbedout, "--tabbedout"))

        from ..core.search import load_db_and_index
        db, index = load_db_and_index(params, params.opt_db, do_mask=False)

        base_seed = random_base_seed(params)
        stats = {"queries": 0, "classified": 0}
        tax_cache: dict = {}

        # query open failure surfaces before the progress meter
        # (reference: fastx_open at sintax.cpp:730)
        fastx_io.check_readable(params.opt_sintax)
        from ..utils.progress import Progress
        classify_progress = Progress("Classifying sequences", 1, params)
        # deferred stripped-char warning: the reference emits it at
        # fastx_close, after the progress meter AND the Classified summary
        # (sintax.cpp:755-796) — collect it here and flush at the end
        deferred_warn = []
        for rec in fastx_io.read_fastx(params.opt_sintax, params,
                                       warn_out=deferred_warn):
            classify_progress.update()
            rng = SplitMix64(random_substream_seed(base_seed, rec.seqno))
            strands = 2 if params.opt_strand else 1
            all_seqno = [[], []]
            best_count = [0, 0]
            for s in range(strands):
                seq = rec.sequence if s == 0 else \
                    reverse_complement(rec.sequence)
                kmersample = kmer_ops.unique_kmers(
                    seq, index.wordlength, Masking.none)
                kmersamplecount = int(kmersample.size)
                if kmersamplecount < SUBSET_SIZE:
                    continue
                # all bootstrap draws for this strand at once (bit-identical
                # sequence to the scalar loop); the random tie-break path
                # consumes extra draws mid-stream, so it stays scalar
                if not params.opt_sintax_random:
                    from ..utils.random import random_bounded_block
                    draws = random_bounded_block(
                        rng, BOOTSTRAP_COUNT * SUBSET_SIZE,
                        kmersamplecount).reshape(BOOTSTRAP_COUNT,
                                                 SUBSET_SIZE)
                    # duplicate draw indices are skipped by the reference
                    # loop, and the kmer sample has no duplicate values —
                    # so each bootstrap's probe set is just the unique
                    # draws; dedup all bootstraps with one sort + shift
                    # compare, then run all 100 probes as ONE native
                    # top-k batch in the raw (buf, offsets) wire format
                    sd = np.sort(draws, axis=1)
                    keep = np.ones_like(sd, dtype=bool)
                    keep[:, 1:] = sd[:, 1:] != sd[:, :-1]
                    vals = np.ascontiguousarray(kmersample[sd[keep]])
                    off = np.zeros(BOOTSTRAP_COUNT + 1, dtype=np.int64)
                    np.cumsum(keep.sum(axis=1), out=off[1:])
                    klists = [vals[off[b]:off[b + 1]]
                              for b in range(BOOTSTRAP_COUNT)]
                    cand_lists = index.candidates_for_query_batch(
                        klists, 1, [2] * BOOTSTRAP_COUNT,
                        raw=(vals, off))
                    for cands in cand_lists:
                        if cands:
                            seqno, count = cands[0]
                            all_seqno[s].append(seqno)
                            best_count[s] = max(count, best_count[s])
                    continue
                for b in range(BOOTSTRAP_COUNT):
                    used = set()
                    subset = []
                    for i in range(SUBSET_SIZE):
                        x = random_bounded(rng, kmersamplecount)
                        if x not in used:
                            subset.append(int(kmersample[x]))
                            used.add(x)
                    result = _search_topscore(
                        index, db, np.array(subset, dtype=np.uint32), rng,
                        params)
                    if result is not None:
                        count, seqno = result
                        all_seqno[s].append(seqno)
                        best_count[s] = max(count, best_count[s])

            if not params.opt_strand:
                best_strand = 0
            elif best_count[0] > best_count[1]:
                best_strand = 0
            elif best_count[1] > best_count[0]:
                best_strand = 1
            else:
                best_strand = 0 if len(all_seqno[0]) >= len(all_seqno[1]) \
                    else 1
            _analyse(params, db, out, rec.header, best_strand,
                     all_seqno[best_strand], stats, tax_cache)

        classify_progress.done()
        from ..utils.progress import message_both
        msg = "Classified %d of %d sequences" % (stats["classified"],
                                                 stats["queries"])
        if stats["queries"] > 0:
            msg += " (%.2f%%)" % (100.0 * stats["classified"]
                                  / stats["queries"])
        message_both(params, msg + "\n")
        for stripped, is_fq in deferred_warn:
            fastx_io._warn_stripped(params, stripped, is_fq)
