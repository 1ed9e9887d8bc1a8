from rts_tpu_torch.sim.paths import AttitudePath, Path, RotationPath
from rts_tpu_torch.sim.waveform import RadarSignal, TransmitterPulse
from rts_tpu_torch.sim.response import InterpPoint, Response
from rts_tpu_torch.sim.world import Receiver, Target, Transmitter, World
from rts_tpu_torch.sim.driver import run
from rts_tpu_torch.sim.cpi import PRESETS, check_replay_overflow, prepare_cpi, run_all_cpi, run_cpi
from rts_tpu_torch.sim.render import RenderGrid, range_doppler_map, render_cpi_result, synthesize_cpi
from rts_tpu_torch.sim.config_io import load_world, world_from_dict, world_from_xml

__all__ = [
    "AttitudePath",
    "Path",
    "RotationPath",
    "RadarSignal",
    "TransmitterPulse",
    "InterpPoint",
    "Response",
    "Receiver",
    "Target",
    "Transmitter",
    "World",
    "PRESETS",
    "RenderGrid",
    "check_replay_overflow",
    "load_world",
    "prepare_cpi",
    "range_doppler_map",
    "render_cpi_result",
    "run",
    "run_all_cpi",
    "run_cpi",
    "synthesize_cpi",
]
