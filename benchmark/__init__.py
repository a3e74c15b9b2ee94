"""The benchmark of vsearch_tpu_torch: data-driven cells run on one card.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``; see README.md.  Nothing here imports jax or the JAX
package.
"""
