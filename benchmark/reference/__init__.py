"""The plain reference: vsearch's semantics in plain PyTorch and numpy.

It imports nothing of the program (vsearch_tpu_torch) and nothing of the
JAX package, takes nothing that the program made, and works every answer
out again from the generated inputs.
"""
