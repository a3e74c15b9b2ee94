"""Global alignment as vsearch computes it, over many pairs at once.

vsearch (src/core/align_simd.cpp) aligns with affine gaps whose penalties
depend on the gap's place: a gap before the first or after the last
position of the other sequence (an end gap) costs ``open_end`` for its
first position and ``ext_end`` for each further one; an interior gap
``open_int`` and ``ext_int``.  A gap that consumes query positions
(``D``) takes the target's classes, one that consumes target positions
(``I``) the query's.  Ties are broken by the engine's direction bits:

* H = max(diag + s, F, E), F winning over the diagonal only when greater,
  E winning only when greater than both;
* a gap extends only when extending is strictly better than opening;
* the walk back from the last cell prefers to continue an I run, then a D
  run, then to leave by E, then by F, then along the diagonal.

Plain PyTorch over anti-diagonals: every cell of diagonal d depends only
on diagonals d - 1 and d - 2, so one step computes a whole diagonal of
every pair.  ``saturate=(lo, hi)`` clamps every value as saturating
integer lanes of that range would (the lower-precision control).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

OP_M, OP_D, OP_I = 1, 2, 3
_OP_CHAR = {OP_M: "M", OP_D: "D", OP_I: "I"}

# direction bits of one cell
UP, LEFT, EXTUP, EXTLEFT = 1, 2, 4, 8


@dataclasses.dataclass(frozen=True)
class Scheme:
    """Scores as the user gives them (vsearch --match --mismatch --gapopen
    --gapext), the query and the target taking the same penalties."""
    match: int = 2
    mismatch: int = -4
    open_int: int = 20
    ext_int: int = 2
    open_end: int = 2
    ext_end: int = 1

    @classmethod
    def from_dict(cls, d: dict) -> "Scheme":
        return cls(**{k: int(v) for k, v in d.items()})


@dataclasses.dataclass
class Alignment:
    """One pair's alignment: the engine's score and its operations."""
    score: int
    ops: np.ndarray          # forward order, OP_M / OP_D / OP_I
    matches: int

    @property
    def cigar(self) -> str:
        """Run-length operations, a run of one without its count."""
        if self.ops.size == 0:
            return ""
        cut = np.flatnonzero(np.diff(self.ops)) + 1
        starts = np.concatenate([[0], cut])
        lens = np.diff(np.concatenate([starts, [self.ops.size]]))
        return "".join(("%d%s" % (n, _OP_CHAR[int(self.ops[s])])) if n > 1
                       else _OP_CHAR[int(self.ops[s])]
                       for s, n in zip(starts, lens))


@dataclasses.dataclass
class HitFields:
    """The fields vsearch derives from an alignment (searchcore.cpp
    align_trim and the identity definitions)."""
    aligned: int
    matches: int
    mismatches: int
    gaps: int
    internal_aligned: int
    internal_gaps: int
    identity: float          # --iddef 2, in percent


def hit_fields(aln: Alignment) -> HitFields:
    ops = aln.ops
    aligned = int(ops.size)
    n_m = int(np.count_nonzero(ops == OP_M))
    mismatches = n_m - aln.matches
    gap_start = (ops != OP_M) & np.concatenate(
        [[True], ops[1:] != ops[:-1]]) if aligned else np.zeros(0, bool)
    gaps = int(np.count_nonzero(gap_start))
    left = right = 0
    left_q = left_t = 0
    if aligned:
        runs = np.flatnonzero(np.diff(ops)) + 1
        first_len = int(runs[0]) if runs.size else aligned
        last_len = aligned - int(runs[-1]) if runs.size else aligned
        if ops[0] != OP_M:
            left = first_len
            left_q, left_t = ((first_len, 0) if ops[0] == OP_D
                              else (0, first_len))
        if ops[-1] != OP_M:
            right_q, right_t = ((last_len, 0) if ops[-1] == OP_D
                                else (0, last_len))
            # a single run at both ends is trimmed once
            if left_q >= aligned:
                right_q = 0
            if left_t >= aligned:
                right_t = 0
            right = right_q + right_t
    internal = aligned - left - right
    internal_gaps = gaps - (1 if left > 0 else 0) - (1 if right > 0 else 0)
    identity = 100.0 * aln.matches / internal if internal > 0 else 0.0
    return HitFields(aligned, aln.matches, mismatches, gaps, internal,
                     internal_gaps, identity)


def align(scheme: Scheme, q: torch.Tensor, qlen: torch.Tensor,
          t: torch.Tensor, tlen: torch.Tensor,
          saturate: Optional[Tuple[int, int]] = None) -> List[Alignment]:
    """Align pair b: q[b, :qlen[b]] against t[b, :tlen[b]] (base codes
    0..3, int64 lengths, all on one device; every length at least 1)."""
    dev = q.device
    B, M = q.shape
    N = t.shape[1]
    qlen = qlen.to(dev, torch.int64)
    tlen = tlen.to(dev, torch.int64)
    I32 = torch.int32

    def sat(x):
        return x.clamp(saturate[0], saturate[1]) if saturate else x

    go_i, ge_i = scheme.open_int - scheme.ext_int, scheme.ext_int
    go_e, ge_e = scheme.open_end - scheme.ext_end, scheme.ext_end
    ar = torch.arange(M, device=dev)
    # the query's classes by row, the target's by column (right end gaps)
    q_right = ar[None, :] == (qlen - 1)[:, None]
    QRq = torch.where(q_right, scheme.open_end, scheme.open_int).to(I32)
    Rq = torch.where(q_right, scheme.ext_end, scheme.ext_int).to(I32)
    # boundaries: H above row 0 (a leading D run... of target positions,
    # by the query's left class) and left of column 0 (the target's)
    jj = torch.arange(-1, N, device=dev)
    h_top = sat(-(go_e + (jj + 1) * ge_e)).to(I32)      # H[-1][j], j >= -1
    h_top[0] = 0
    ii = torch.arange(-1, M, device=dev)
    h_left = sat(-(go_e + (ii + 1) * ge_e)).to(I32)     # H[i][-1], i >= -1
    h_left[0] = 0

    D = M + N - 1
    dirs = torch.zeros((B, D, M), dtype=torch.uint8, device=dev)
    neg = torch.full((B, M), -(1 << 30), dtype=I32, device=dev)
    H1, H2, F1, E1 = neg.clone(), neg.clone(), neg.clone(), neg.clone()
    score = torch.zeros(B, dtype=I32, device=dev)
    dend = qlen + tlen - 2
    qi32 = q.to(I32)
    for d in range(D):
        j = d - ar                                   # column of row i
        jc = j.clamp(0, N - 1)
        tj = t.index_select(1, jc).to(I32)
        s = torch.where(qi32 == tj, scheme.match, scheme.mismatch).to(I32)
        t_right = j[None, :] == (tlen - 1)[:, None]
        QRt = torch.where(t_right, scheme.open_end, scheme.open_int).to(I32)
        Rt = torch.where(t_right, scheme.ext_end, scheme.ext_int).to(I32)
        # diagonal input H[i-1][j-1]
        diag = torch.empty_like(H2)
        diag[:, 1:] = H2[:, :-1]
        diag[:, 0] = h_top[(j[0] - 1).clamp(-1, N - 1) + 1]
        diag = torch.where((j == 0)[None, :],
                           h_left[ar][None, :].expand(B, M), diag)
        # F entering row i from row i-1 of this column
        fin = torch.empty_like(F1)
        fin[:, 1:] = F1[:, :-1]
        fin[:, 0] = sat(h_top[jc[0] + 1] - QRt[:, 0])
        # E entering column j from column j-1 of this row
        ein = torch.where((j == 0)[None, :],
                          sat(h_left[ar + 1][None, :] - QRq), E1)
        h = sat(diag + s)
        up = fin > h
        h = torch.maximum(h, fin)
        left = ein > h
        h = torch.maximum(h, ein)
        hf = sat(h - QRt)
        fx = sat(fin - Rt)
        extup = fx > hf
        fnext = torch.maximum(fx, hf)
        he = sat(h - QRq)
        ex = sat(ein - Rq)
        extleft = ex > he
        enext = torch.maximum(ex, he)
        dirs[:, d, :] = (up.to(torch.uint8) | (left.to(torch.uint8) << 1)
                         | (extup.to(torch.uint8) << 2)
                         | (extleft.to(torch.uint8) << 3))
        at_end = dend == d
        if bool(at_end.any()):
            last = h.gather(1, (qlen - 1)[:, None])[:, 0]
            score = torch.where(at_end, last, score)
        H2, H1, F1, E1 = H1, h, fnext, enext
    return _backtrack(dirs, q, qlen, t, tlen, score)


def _backtrack(dirs, q, qlen, t, tlen, score) -> List[Alignment]:
    """Walk every pair back from its last cell (align_simd backtrack16),
    one step of all pairs at a time."""
    dev = q.device
    B, M = q.shape
    N = t.shape[1]
    i = qlen - 1
    j = tlen - 1
    op = torch.zeros(B, dtype=torch.int64, device=dev)
    matches = torch.zeros(B, dtype=torch.int64, device=dev)
    steps = M + N
    rev = torch.zeros((B, steps), dtype=torch.int8, device=dev)
    rows = torch.arange(B, device=dev)
    for s in range(steps):
        live = (i >= 0) & (j >= 0)
        if not bool(live.any()):
            break
        ic, jc = i.clamp(min=0), j.clamp(min=0)
        dd = dirs[rows, (ic + jc).clamp(max=dirs.shape[1] - 1), ic].to(
            torch.int64)
        ext_i = (op == OP_I) & ((dd & EXTLEFT) != 0)
        ext_d = (op == OP_D) & ((dd & EXTUP) != 0) & ~ext_i
        rest = ~ext_i & ~ext_d
        go_i = rest & ((dd & LEFT) != 0)
        go_d = rest & ~go_i & ((dd & UP) != 0)
        new = torch.full_like(op, OP_M)
        new = torch.where(ext_i | go_i, OP_I, new)
        new = torch.where(ext_d | go_d, OP_D, new)
        new = torch.where(live, new, torch.zeros_like(new))
        is_m = new == OP_M
        eq = q[rows, ic] == t[rows, jc]
        matches += (is_m & eq).to(torch.int64)
        rev[:, s] = new.to(torch.int8)
        i = i - ((new == OP_M) | (new == OP_D)).to(torch.int64)
        j = j - ((new == OP_M) | (new == OP_I)).to(torch.int64)
        op = torch.where(live, new, op)
    rev_h = rev.cpu().numpy()
    i_h = i.cpu().numpy()
    j_h = j.cpu().numpy()
    out = []
    for b, (sc, mt) in enumerate(zip(score.cpu().tolist(),
                                     matches.cpu().tolist())):
        loop_ops = rev_h[b][rev_h[b] != 0][::-1]
        lead = np.concatenate([np.full(j_h[b] + 1, OP_I, np.int8),
                               np.full(i_h[b] + 1, OP_D, np.int8)])
        out.append(Alignment(int(sc), np.concatenate([lead, loop_ops]),
                             int(mt)))
    return out


def align_codes(scheme: Scheme, pairs_q: List[np.ndarray],
                pairs_t: List[np.ndarray], device, batch: int = 2048,
                saturate=None) -> List[Alignment]:
    """align() over lists of code arrays, in batches of pairs."""
    out: List[Alignment] = []
    for lo in range(0, len(pairs_q), batch):
        qs, ts = pairs_q[lo:lo + batch], pairs_t[lo:lo + batch]
        M = max(len(x) for x in qs)
        N = max(len(x) for x in ts)
        qa = np.zeros((len(qs), M), np.uint8)
        ta = np.zeros((len(ts), N), np.uint8)
        for k, (x, y) in enumerate(zip(qs, ts)):
            qa[k, :len(x)] = x
            ta[k, :len(y)] = y
        ql = torch.tensor([len(x) for x in qs], dtype=torch.int64)
        tl = torch.tensor([len(y) for y in ts], dtype=torch.int64)
        out.extend(align(scheme, torch.from_numpy(qa).to(device), ql,
                         torch.from_numpy(ta).to(device), tl,
                         saturate=saturate))
    return out
