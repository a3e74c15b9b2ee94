"""The port's C-ABI shim (vsearch_tpu_torch/csrc/capi.c) driven through
ctypes from a running interpreter: tests/test_torch_capi.py runs it in a
subprocess against vsearch_tpu.api, and chip_smoke.py's capi phase in
process on the card.  Imports neither jax nor vsearch_tpu.
"""

FIELDS = ("target", "id", "matches", "mismatches", "gaps",
          "alignment_length", "query_length", "target_length", "strand")
MAXHITS = 16

# the demo's parameters (csrc/capi_demo.c) with the word length set, as
# the reference's api_examples do: a default Parameters leaves every
# k-mer of a query required
OPTIONS = {"id": 0.9, "minseqlength": 1, "wordlength": 8}


def hit_json(hit) -> dict:
    """A vstpu_hit_t as JSON values, the strings as latin-1 text."""
    out = {k: getattr(hit, k) for k in FIELDS}
    out["target_label"] = hit.target_label.decode("latin-1")
    out["cigar"] = hit.cigar.decode("latin-1")
    return out


def search(lib, db_path, queries, options=OPTIONS, nested=False,
           times=None):
    """One session of the shim: params, begin, open the DB, one
    vstpu_search_single call a (header, sequence) query, close, end.
    Returns each query's hits and, with `nested`, what a second
    vstpu_session_begin inside the session returned.  Appends each call's
    seconds to the list `times` where one is given."""
    import time
    from vsearch_tpu_torch.capi import Hit
    p = lib.vstpu_params_new()
    if not p:
        raise RuntimeError("vstpu_params_new failed")
    for name, value in options.items():
        if lib.vstpu_params_set_num(p, name.encode(), value) != 0:
            raise RuntimeError("vstpu_params_set_num %s failed" % name)
    if lib.vstpu_session_begin(p) != 0:
        raise RuntimeError("vstpu_session_begin failed")
    nested_rc = lib.vstpu_session_begin(p) if nested else None
    h = lib.vstpu_search_open(p, str(db_path).encode())
    if not h:
        raise RuntimeError("vstpu_search_open failed")
    hits = (Hit * MAXHITS)()
    results = []
    for head, seq in queries:
        t0 = time.perf_counter()
        n = lib.vstpu_search_single(h, head, seq, hits, MAXHITS)
        if times is not None:
            times.append(time.perf_counter() - t0)
        if n < 0:
            raise RuntimeError("vstpu_search_single failed on %r" % head)
        results.append([hit_json(hits[i]) for i in range(n)])
    lib.vstpu_search_close(h)
    if lib.vstpu_session_end() != 0:
        raise RuntimeError("vstpu_session_end failed")
    lib.vstpu_params_free(p)
    return results, nested_rc


def tsv(queries, results) -> str:
    """The rows capi_demo prints for these results."""
    return "".join(
        "%s\t%s\t%.1f\t%d\t%d\t%d\n" % (
            head.decode("latin-1"), h["target_label"], h["id"],
            h["matches"], h["mismatches"], h["gaps"])
        for (head, _), hits in zip(queries, results) for h in hits)


def dust(lib, seqs):
    """vstpu_dust_single of each sequence, as text."""
    import ctypes
    out = []
    for seq in seqs:
        buf = ctypes.create_string_buffer(len(seq) + 1)
        n = lib.vstpu_dust_single(seq, buf, len(buf))
        if n != len(seq):
            raise RuntimeError("vstpu_dust_single returned %d" % n)
        out.append(buf.value.decode("latin-1"))
    return out
