from rts_tpu_torch.accel.cluster import cluster_aabbs, cluster_reorder, morton_order

__all__ = ["cluster_aabbs", "cluster_reorder", "morton_order"]
