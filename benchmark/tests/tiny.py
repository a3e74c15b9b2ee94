"""Tiny sizes of the cells, for the program's plain versions on the CPU,
and a helper that runs a cell in process and returns its result line."""

import json

TINY = {
    "allpairs_v34.related": {
        "config": {"generator": {"length": 100,
                                 "branching": [2, 1, 1, 2, 2, 2, 2],
                                 "subs": [2, 2, 2, 4, 2, 0.5, 0.3],
                                 "indels": [1, 0, 0, 1, 0, 0, 0]},
                   "judge": {"sample_rows": 400, "sample_pairs": 600}},
        "cell": {"traffic": {"pool": 2}}},
    "search_otutab.novel50": {
        "config": {"generator": {"genera": 16, "members": 32, "length": 120,
                                 "member_subs": 4},
                   "judge": {"sample_reads": 96}},
        "cell": {"traffic": {"pool": 2, "reads": 64, "novel": 32,
                             "read_subs": 1}}},
}


# the search cell's metrics, as BENCHMARK.json would list them if it held
# the cell (it does not yet: its rate spreads too widely to be bounded)
SEARCH_METRICS = {
    "end_to_end": [{"name": "queries_per_s", "unit": "queries/s",
                    "workloads": ["search_otutab.novel50"]}],
    "per_layer": [{"name": n, "unit": u, "workloads": ["search_otutab.novel50"]}
                  for n, u in (("device_idle_share.search", "share"),
                               ("device_ms_per_kread.search", "ms"),
                               ("walk_ms_per_kread.search", "ms"),
                               ("front_ms_per_kread.search", "ms"))]}


def with_search_metrics(spec):
    """BENCHMARK.json's spec with the search cell's metrics added."""
    out = dict(spec)
    for key, extra in SEARCH_METRICS.items():
        names = {m["name"] for m in spec[key]}
        out[key] = spec[key] + [m for m in extra if m["name"] not in names]
    return out


def run_cell(capsys, workload, seed, trace=0, seconds=0.5, overrides=None):
    """run.main on the CPU at the cell's tiny size; (rc, result or None)."""
    from benchmark import run
    capsys.readouterr()
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", str(seconds), "--trace", str(trace)],
                  device="cpu",
                  overrides=overrides if overrides is not None
                  else TINY[workload])
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
