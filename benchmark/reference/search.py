"""vsearch --usearch_global, plain: the uc line of every sampled query.

For each query (src/core/searchcore.cpp search_onequery):

1. Both the query and every reference sequence are DUST-masked
   (--qmask dust, --dbmask dust); a word of ``wordlength`` bases that
   overlaps a masked base is not counted.
2. A reference sequence's score is the number of distinct query words it
   holds; those with at least min(minwordmatches, the query's distinct
   words) are candidates, best first: score descending, then length
   ascending, then sequence number ascending.
3. Candidates are aligned in that order (nwalign.py) and accepted when
   their identity (--iddef 2) reaches --id; the walk stops after
   maxaccepts accepts or maxrejects rejects, and takes at most
   maxaccepts + maxrejects - 1 candidates.
4. The uc line is H with the best accepted hit (identity descending, then
   sequence number), or N without one; the userout line (fields
   query+target+id+raw) is that hit's labels, identity and alignment
   score, and there is none without a hit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import dust, nwalign


def words(codes: torch.Tensor, masked: torch.Tensor, k: int):
    """(codes of every word (S, L - k + 1) int64, valid (S, L - k + 1))."""
    S, L = codes.shape
    c = codes.to(torch.int64)
    w = torch.zeros((S, L - k + 1), dtype=torch.int64, device=codes.device)
    bad = torch.zeros((S, L - k + 1), dtype=torch.bool, device=codes.device)
    for t in range(k):
        w = w * 4 + c[:, t:L - k + 1 + t]
        bad |= masked[:, t:L - k + 1 + t]
    return w, ~bad


def distinct(w: torch.Tensor, valid: torch.Tensor):
    """Per row: sorted words with each distinct valid word once; returns
    (sorted words, keep mask)."""
    big = torch.iinfo(torch.int64).max
    sw, _ = torch.where(valid, w, big).sort(dim=1)
    keep = sw != big
    keep[:, 1:] &= sw[:, 1:] != sw[:, :-1]
    return sw, keep


class WordIndex:
    """Which reference sequences hold each word (postings by word)."""

    def __init__(self, codes: torch.Tensor, k: int, chunk: int = 16384):
        S, L = codes.shape
        self.n = S
        self.k = k
        parts_w, parts_s = [], []
        for lo in range(0, S, chunk):
            blk = codes[lo:lo + chunk]
            w, ok = words(blk, dust.mask(blk), k)
            sw, keep = distinct(w, ok)
            rows = torch.arange(lo, lo + blk.shape[0],
                                device=codes.device)[:, None].expand_as(sw)
            parts_w.append(sw[keep])
            parts_s.append(rows[keep])
        allw = torch.cat(parts_w)
        alls = torch.cat(parts_s)
        order = torch.argsort(allw * S + alls)
        self.post = alls[order]
        cnt = torch.bincount(allw, minlength=4 ** k)
        self.start = torch.cumsum(cnt, 0) - cnt
        self.cnt = cnt

    def scores(self, qwords: torch.Tensor, qkeep: torch.Tensor
               ) -> torch.Tensor:
        """(Q, n) number of distinct query words each sequence holds."""
        Q = qwords.shape[0]
        qi = torch.arange(Q, device=qwords.device)[:, None].expand_as(
            qwords)[qkeep]
        wd = qwords[qkeep]
        lens = self.cnt[wd]
        total = int(lens.sum())
        seg = torch.repeat_interleave(torch.arange(lens.numel(),
                                                   device=wd.device), lens)
        within = (torch.arange(total, device=wd.device)
                  - (torch.cumsum(lens, 0) - lens)[seg])
        seqs = self.post[self.start[wd][seg] + within]
        flat = torch.bincount(qi[seg] * self.n + seqs,
                              minlength=Q * self.n)
        return flat.view(Q, self.n)


def candidates(index: WordIndex, q: torch.Tensor, lengths: torch.Tensor,
               opts: dict, take: int, qchunk: int = 64) -> List[List[int]]:
    """Best-first candidates of each query (at most ``take``)."""
    k = index.k
    mwm = int(opts["minwordmatches"])
    out: List[List[int]] = []
    n = index.n
    seqno = torch.arange(n, device=q.device, dtype=torch.int64)
    for lo in range(0, q.shape[0], qchunk):
        blk = q[lo:lo + qchunk]
        w, ok = words(blk, dust.mask(blk), k)
        sw, keep = distinct(w, ok)
        sample = keep.sum(dim=1)
        sc = index.scores(sw, keep)
        minm = torch.clamp(sample, max=mwm)[:, None]
        eligible = sc >= minm
        # score desc, length asc, seqno asc as one descending key
        key = ((sc.to(torch.int64) << 42)
               | (((1 << 21) - 1 - lengths.to(torch.int64)) << 21)[None, :]
               | ((1 << 21) - 1 - seqno)[None, :])
        key = torch.where(eligible, key, -1)
        top = torch.topk(key, min(take, n), dim=1)
        for vals, idx in zip(top.values.cpu().tolist(),
                             top.indices.cpu().tolist()):
            out.append([i for v, i in zip(vals, idx) if v >= 0])
    return out


def uc_lines(opts: dict, db_codes: np.ndarray, db_labels: Sequence[str],
             q_codes: np.ndarray, q_labels: Sequence[str],
             sample: Sequence[int], device, saturate=None,
             index: Optional[WordIndex] = None
             ) -> Dict[int, Tuple[str, Optional[str]]]:
    """(uc line, userout line or None), without newlines, of each sampled
    query index."""
    scheme = nwalign.Scheme.from_dict(opts["scheme"])
    maxaccepts = int(opts["maxaccepts"])
    maxrejects = int(opts["maxrejects"])
    idmin = 100.0 * float(opts["id"])
    seqcount = db_codes.shape[0]
    pops = min(maxaccepts + maxrejects - 1, seqcount)
    if index is None:
        index = WordIndex(torch.from_numpy(db_codes).to(device),
                          int(opts["wordlength"]))
    lengths = torch.full((seqcount,), db_codes.shape[1], dtype=torch.int64,
                         device=device)
    sample = list(sample)
    qsel = torch.from_numpy(q_codes[sample]).to(device)
    cands = candidates(index, qsel, lengths, opts, pops)

    results: Dict[tuple, nwalign.HitFields] = {}
    cigars: Dict[tuple, str] = {}
    scores: Dict[tuple, int] = {}

    def run(pairs):
        alns = nwalign.align_codes(scheme, [q_codes[sample[s]]
                                            for s, _ in pairs],
                                   [db_codes[t] for _, t in pairs], device,
                                   saturate=saturate)
        for key, aln in zip(pairs, alns):
            results[key] = nwalign.hit_fields(aln)
            cigars[key] = aln.cigar
            scores[key] = aln.score

    # the first candidate of every query, then the rest where it is needed
    run([(s, c[0]) for s, c in enumerate(cands) if c])
    rest = [(s, t) for s, c in enumerate(cands) if c
            and not (maxaccepts == 1 and results[(s, c[0])].identity >= idmin)
            for t in c[1:]]
    run(rest)

    lines: Dict[int, Tuple[str, Optional[str]]] = {}
    for s, c in enumerate(cands):
        accepted = []
        acc = rej = 0
        for t in c:
            if acc >= maxaccepts or rej >= maxrejects:
                break
            f = results[(s, t)]
            if f.identity >= idmin:
                acc += 1
                accepted.append((-f.identity, t))
            else:
                rej += 1
        qi = sample[s]
        if not accepted:
            lines[qi] = ("N\t*\t*\t*\t.\t*\t*\t*\t%s\t*" % q_labels[qi],
                         None)
            continue
        _, t = min(accepted)
        f = results[(s, t)]
        cigar = "=" if f.matches == f.aligned else cigars[(s, t)]
        lines[qi] = ("H\t%d\t%d\t%.1f\t+\t0\t0\t%s\t%s\t%s" % (
            t, q_codes.shape[1], f.identity, cigar, q_labels[qi],
            db_labels[t]),
            "%s\t%s\t%.1f\t%d" % (q_labels[qi], db_labels[t], f.identity,
                                  scores[(s, t)]))
    return lines
