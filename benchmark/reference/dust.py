"""vsearch's DUST low-complexity masking (src/core/mask.cpp), plain torch.

A sequence is scanned in windows of 64 bases that start every 32 bases.
In a window, for every start i and end p (at least 8 bases apart), the
score is 10 * S // (p - i), where S counts the pairs of equal 3-mers
among the 3-mers that end at i + 2 .. p; the best score (the first (i, p)
in row order among equals) masks bases i .. p when it passes 20.  A masked
region ending in the first half of its window moves the next window's
start on by 32 - end.

Every window of every sequence at its current start is scored in one
step, so the steps are as many as a sequence has windows.
"""

from __future__ import annotations

import torch

WINDOW = 64
HALF = WINDOW // 2
LEVEL = 20
WORD = 3


def _best(words: torch.Tensor, lens: torch.Tensor):
    """(v, a, b) of windows (W, WINDOW): words[w, x] is the 3-mer ending at
    x (x >= 2), or a value unique to x where there is none; lens[w] the
    window's length."""
    W, L = words.shape
    dev = words.device
    x = torch.arange(L, device=dev)
    eq = (words[:, :, None] == words[:, None, :]) & (x[:, None] < x[None, :])
    # T[a, p] = pairs (a', p') with a' >= a, a' < p' <= p
    T = eq.to(torch.int32).cumsum(2).flip(1).cumsum(1).flip(1)
    # S[i, p] = T[i + 2, p]
    idx = (x + 2).clamp(max=L - 1)
    S = T.index_select(1, idx)
    jgrid = x[None, :] - x[:, None]                       # p - i
    l1 = lens - WORD + 1 - 5
    ok = ((jgrid >= 2)[None] & (x[None, None, :] < lens[:, None, None])
          & (x[None, :, None] < l1[:, None, None]))
    v = torch.where(ok, (10 * S) // jgrid.clamp(min=1)[None], 0)
    flat = v.reshape(W, L * L)
    best = flat.max(dim=1).values
    arg = flat.argmax(dim=1)        # the first maximum
    a = arg // L
    b = arg % L
    return best, a, b


def mask(codes: torch.Tensor, chunk: int = 8192) -> torch.Tensor:
    """Masked positions (S, L) bool of sequences codes (S, L), base codes
    0..3, all of length L."""
    S, L = codes.shape
    dev = codes.device
    c = codes.to(torch.int64)
    out = torch.zeros((S, L), dtype=torch.bool, device=dev)
    start = torch.zeros(S, dtype=torch.int64, device=dev)
    xw = torch.arange(WINDOW, device=dev)
    while True:
        live = torch.nonzero(start < L).flatten()
        if live.numel() == 0:
            break
        for lo in range(0, live.numel(), chunk):
            rows = live[lo:lo + chunk]
            st = start[rows]
            lens = (L - st).clamp(max=WINDOW)
            pos = (st[:, None] + xw[None, :]).clamp(max=L - 1)
            win = c[rows[:, None], pos]
            words = torch.full_like(win, -1) - xw[None, :]
            w3 = 16 * win[:, :-2] + 4 * win[:, 1:-1] + win[:, 2:]
            words[:, 2:] = w3
            words = torch.where(xw[None, :] < lens[:, None], words,
                                -1000 - xw[None, :])
            v, a, b = _best(words, lens)
            hit = v > LEVEL
            if bool(hit.any()):
                for r, s0, aa, bb in zip(rows[hit].tolist(),
                                         st[hit].tolist(), a[hit].tolist(),
                                         b[hit].tolist()):
                    out[r, s0 + aa:s0 + bb + 1] = True
            step = torch.full_like(st, HALF)
            step = torch.where(hit & (b < HALF), step + HALF - b, step)
            start[rows] = st + step
    return out
