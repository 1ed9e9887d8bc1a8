from rts_tpu_torch.physics.receiver_geom import rx_sphere_geometry

__all__ = ["rx_sphere_geometry"]
