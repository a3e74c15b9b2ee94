"""vsearch --allpairs_global --blast6out, plain: the row of a pair.

Sequence q is aligned against every later sequence t (nwalign.py); the
pair is reported when its identity (--iddef 2) reaches --id.  The blast6
row is query label, target label, identity with one decimal, the
alignment's length without its end gaps, mismatches, interior gap
openings, 1, the query's length, 1, the target's length, -1 and 0.  A
query's rows come in order of identity descending, then target.
DUST masking (--qmask dust) changes only the letters' case, which the
alignment does not see, so it is left out here.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from . import nwalign


def rows(opts: dict, codes: np.ndarray, labels: Sequence[str],
         pairs: Sequence[Tuple[int, int]], device, saturate=None
         ) -> Dict[Tuple[int, int], Optional[Tuple[str, str]]]:
    """The blast6 row and the userout row (fields query+target+raw), each
    without its newline, of each pair (q, t), or None where the pair is
    not reported."""
    scheme = nwalign.Scheme.from_dict(opts["scheme"])
    idmin = 100.0 * float(opts["id"])
    pairs = list(pairs)
    alns = nwalign.align_codes(scheme, [codes[q] for q, _ in pairs],
                               [codes[t] for _, t in pairs], device,
                               saturate=saturate)
    out: Dict[Tuple[int, int], Optional[str]] = {}
    for (q, t), aln in zip(pairs, alns):
        f = nwalign.hit_fields(aln)
        if f.identity >= idmin:
            out[(q, t)] = (
                "%s\t%s\t%.1f\t%d\t%d\t%d\t1\t%d\t1\t%d\t-1\t0" % (
                    labels[q], labels[t], f.identity, f.internal_aligned,
                    f.mismatches, f.internal_gaps, codes.shape[1],
                    codes.shape[1]),
                "%s\t%s\t%d" % (labels[q], labels[t], aln.score))
        else:
            out[(q, t)] = None
    return out
