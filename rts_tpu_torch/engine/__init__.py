from rts_tpu_torch.engine.types import DeviceScene, RxGeomDevice, TraceConfig

__all__ = ["DeviceScene", "RxGeomDevice", "TraceConfig"]
