"""Graph-axis multi-device execution on torch.distributed (port of
han_tpu/parallel/): the mesh and its autograd collectives (``mesh.py``),
process-group start-up (``launch.py``), the edge-partitioned flash backend
(``flash_shard.py``), the ring backend over BCSR tiles (``ring_bcsr.py``)
and the multi-process dry run (``dryrun.py``)."""
