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
