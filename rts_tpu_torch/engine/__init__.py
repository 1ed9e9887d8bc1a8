from rts_tpu_torch.engine.types import DeviceScene, RxGeomDevice, TraceConfig, scene_to_device

__all__ = ["DeviceScene", "RxGeomDevice", "TraceConfig", "scene_to_device"]
