"""Helpers shared by the port's tests (tests/test_torch_*.py).

Imports nothing of jax, so that tests/test_torch_kernels.py, which runs as
it is on a machine with a card and no jax, can use them too.
"""


def longest_gap_run(ops) -> int:
    """The longest run of one gap op (D or I) in any lane of a flat ops
    wire."""
    best = 0
    for col in ops.t().tolist():
        run, last = 0, 0
        for op in col:
            run = (run + 1 if op == last else 1) if op in (2, 3) else 0
            last = op
            best = max(best, run)
    return best


# The accept cascade's terms (search_acceptable_aligned), each set to bite
# on accept_rows: every option the cascade reads, away from its default.
ACCEPT_TERMS = {"opt_id": 0.97, "opt_weak_id": 0.9, "opt_maxid": 0.995,
                "opt_mid": 95.0, "opt_query_cov": 0.6,
                "opt_target_cov": 0.55, "opt_maxsubs": 15,
                "opt_maxgaps": 3, "opt_mincols": 200, "opt_leftjust": 1,
                "opt_rightjust": 1, "opt_maxdiffs": 20}
# the options with every term off (an identity of 0 passes, but NaN)
ACCEPT_OFF = {"opt_id": 0.0, "opt_weak_id": 0.0, "opt_maxid": 1.0,
              "opt_mid": 0.0, "opt_query_cov": 0.0, "opt_target_cov": 0.0,
              "opt_maxsubs": 2 ** 31 - 1, "opt_maxgaps": 2 ** 31 - 1,
              "opt_mincols": 0, "opt_leftjust": 0, "opt_rightjust": 0,
              "opt_maxdiffs": 2 ** 31 - 1}
# coverage rows where the product of the option and the length rounds to
# another side of the aligned columns in float32 than in float64:
# 0.6 x 400 is 240 in float64 and above it in float32, 0.55 x 100 above
# 55 in float64 and 55 in float32
COVERAGE_TRAPS = (("opt_query_cov", 0.6, 400, 240),
                  ("opt_target_cov", 0.55, 100, 55))


def accept_options(params_cls, iddef: int, **opts):
    """A Parameters of ``params_cls`` (the port's or the JAX package's)
    with ACCEPT_OFF, then ``opts``, and --iddef."""
    p = params_cls()
    for k, v in {**ACCEPT_OFF, **opts, "opt_iddef": iddef}.items():
        setattr(p, k, v)
    return p


def _row(qlen, tlen, aligned, matches, indels, gap_opens, first=(1, 1),
         last=(1, 1)):
    return ([aligned, matches, indels, gap_opens, first[0], first[1],
             last[0], last[1]], qlen, tlen)


def accept_rows(seed: int, n: int = 4096):
    """Stats rows [aligned, matches, indels, gap_opens, first_op,
    first_len, last_op, last_len] (P, 8) int32 and the pairs' qlen, tlen
    (P,) int64 for the accept cascade: the edge rows below, then n rows
    drawn from ``seed`` around every term's threshold of ACCEPT_TERMS."""
    import numpy as np
    edge = []
    # 400 columns without gaps, identity 96.75, 97.0 and 97.25 % under
    # every --iddef: one count either side of 100 x --id 0.97 and on it
    for d in (-1, 0, 1):
        edge.append(_row(400, 400, 400, 388 + d, 0, 0, (1, 400),
                         (1, 400)))
    # zero denominators: no column, gaps alone (matches + mism 0), and a
    # terminal gap as long as the alignment (int_alnlen 0) on either side
    edge.append(_row(120, 130, 0, 0, 0, 0, (0, 0), (0, 0)))
    edge.append(_row(10, 10, 20, 0, 20, 2, (2, 10), (3, 10)))
    edge.append(_row(50, 1, 50, 1, 49, 1, (2, 50), (1, 1)))
    edge.append(_row(1, 50, 50, 1, 49, 1, (3, 50), (1, 1)))
    edge.append(_row(0, 0, 0, 0, 0, 0, (0, 0), (0, 0)))
    # first and last runs that are gaps, on either side
    for f in (2, 3):
        for la in (2, 3):
            edge.append(_row(400, 400, 412, 394, 12, 2, (f, 6), (la, 6)))
    # the float32 coverage traps: every column a match, all else passing
    edge.append(_row(400, 240, 400, 240, 160, 1, (1, 240), (2, 160)))
    edge.append(_row(55, 100, 100, 55, 45, 1, (1, 55), (3, 45)))
    rng = np.random.default_rng(seed)
    qlen = rng.integers(150, 450, n)
    tlen = np.where(rng.random(n) < 0.7, qlen + rng.integers(-8, 9, n),
                    rng.integers(150, 450, n))
    tlen = np.maximum(tlen, 1)
    first_op = rng.choice([1, 1, 2, 3], n)
    last_op = rng.choice([1, 1, 2, 3], n)
    first_len = np.where(first_op == 1, rng.integers(1, 300, n),
                         rng.integers(1, 40, n))
    last_len = np.where(last_op == 1, rng.integers(1, 300, n),
                        rng.integers(1, 40, n))
    term = (np.where(first_op != 1, first_len, 0)
            + np.where(last_op != 1, last_len, 0))
    internal = rng.integers(0, 14, n) * (rng.random(n) < 0.6)
    cols = np.minimum(qlen, tlen) - rng.integers(0, 4, n)
    cols = np.where(rng.random(n) < 0.1, cols * rng.uniform(0.4, 0.7, n),
                    cols).astype(np.int64)
    idf = np.clip(rng.normal(0.97, 0.02, n), 0.8, 1.0)
    matches = np.round(cols * idf).astype(np.int64)
    indels = term + internal
    aligned = cols + indels
    gap_opens = ((first_op != 1).astype(np.int64) + (last_op != 1)
                 + np.minimum(internal, rng.integers(0, 6, n)))
    drawn = np.stack([aligned, matches, indels, gap_opens, first_op,
                      first_len, last_op, last_len], axis=1)
    stats = np.concatenate([np.array([r[0] for r in edge]), drawn])
    ql = np.concatenate([[r[1] for r in edge], qlen]).astype(np.int64)
    tl = np.concatenate([[r[2] for r in edge], tlen]).astype(np.int64)
    return stats.astype(np.int32), ql, tl
