from rts_tpu_torch.ops.cluster_trace import closest_hit_clustered, mt_traverse, mt_traverse_reference

__all__ = ["closest_hit_clustered", "mt_traverse", "mt_traverse_reference"]
