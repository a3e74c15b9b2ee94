"""Multi-process scale-out: one torch.distributed rank a shard.

Counterpart of vsearch_tpu/parallel.  ``distributed`` starts the process
group from torchrun's environment and tears it down at exit, ``mesh``
the ranks as a 1-D mesh and its collectives, ``sharded_index`` the static k-mer index sharded over the
ranks (the growing index's sharded form is ops/score_grow.py's
ShardedGrowingKmerIndex, the pair-sharded aligner ops/nw_batch.py's).
"""
