"""vsearch_tpu_torch: the PyTorch/CUDA port of vsearch_tpu.

The same amplicon search engine as vsearch_tpu, with its device tier in
PyTorch and hand-written CUDA kernels for the NVIDIA H100 (csrc/).  This
package imports nothing of jax or vsearch_tpu: host code it shares with
vsearch_tpu is carried as its own copy.

Every verb of vsearch_tpu's CLI is ported: the device verbs
(--usearch_global, --cluster_fast/size/smallmem/unoise,
--allpairs_global, --uchime_denovo/uchime2_denovo/uchime3_denovo,
--uchime_ref, --chimeras_denovo) and the host-only ones (merging,
filtering, dereplication, sorting, masking, --search_exact, --sintax,
--orient, format conversion, statistics, --cut, --sff_convert and the
UDB verbs).  So is the session API (``api``: SearchSession,
ClusterSession, ChimeraSession, DerepSession, MergeSession,
dust_single).  So is the multi-process scale-out of vsearch_tpu.parallel
(``parallel``: one torch.distributed rank a shard, started by torchrun;
``python -m torch.distributed.run --standalone --nproc_per_node N -m
vsearch_tpu_torch <verb> ...``).

Entry point: ``python -m vsearch_tpu_torch --usearch_global q.fa --db
db.fa --id 0.9 --uc out.uc`` (on cuda; VSEARCH_TPU_TORCH_DEVICE=cpu, or
``cli.main(argv, device="cpu")``, runs the kernels' plain versions).
Sessions select their device the same way:
``api.session_begin(params, device="cpu")``.
"""

__version__ = "0.1.0"
