"""Distribution layer: device meshes, sharded rescoring, deterministic merge.

The reference's only parallelism is cluster-job file fan-out
(patchChain.perl:196-254); here work units (blocks of chains, gap regions)
are sharded data-parallel over a jax.sharding.Mesh, with genomes replicated
in device memory and results all-gathered for deterministic host-side serialization
(SURVEY.md section 5.8).
"""
