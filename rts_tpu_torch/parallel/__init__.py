from rts_tpu_torch.parallel.sharding import make_mesh, regather_lanes, shard_batch, trace_cpi_sharded

__all__ = ["make_mesh", "regather_lanes", "shard_batch", "trace_cpi_sharded"]
