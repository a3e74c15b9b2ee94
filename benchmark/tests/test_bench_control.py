"""The control, the reference in saturating 8-bit lanes in the program's
place, fails the entry's own judge; the exact reference in the same place
passes it.  At a size a test run holds; benchmark/control.py runs it on
the card at the cells' own sizes."""

import pytest

from benchmark import control

from .tiny import TINY

# 300 nt, so that an alignment's score passes 8 bits
SIZES = {
    "allpairs_v34.related": {
        "config": {"generator": dict(
            TINY["allpairs_v34.related"]["config"]["generator"], length=300),
            "judge": {"sample_rows": 64, "sample_pairs": 120}},
        "cell": TINY["allpairs_v34.related"]["cell"]},
    "search_otutab.novel50": TINY["search_otutab.novel50"],
}


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_control_fails_and_reference_holds(workload):
    r = control.reading(workload, 13, "cpu", jobs=3,
                        overrides=SIZES[workload])
    assert r["exact"]["correct"], r
    assert set(r["exact"]["checks"].values()) == {0}
    assert not r["control"]["correct"], r
