"""Multi-device execution on torch.distributed (port of han_tpu/parallel/):
the (mp, graph, heads) mesh and its autograd collectives (``mesh.py``),
process-group start-up (``launch.py``), the edge-partitioned flash backend
(``flash_shard.py``), the ring over BCSR tiles (``ring_bcsr.py``), the
sharded csr backend (``edge_partition.py``, ``shard_attn.py``), the csr
ring (``ring_attn.py``) and the multi-process dry run (``dryrun.py``)."""
