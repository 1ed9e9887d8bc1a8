from rts_tpu_torch.sim.paths import AttitudePath, Path, RotationPath
from rts_tpu_torch.sim.waveform import RadarSignal, TransmitterPulse
from rts_tpu_torch.sim.response import InterpPoint, Response
from rts_tpu_torch.sim.world import Receiver, Target, Transmitter, World
from rts_tpu_torch.sim.driver import run
from rts_tpu_torch.sim.cpi import PRESETS, check_replay_overflow, prepare_cpi, run_all_cpi, run_cpi

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
    "check_replay_overflow",
    "prepare_cpi",
    "run",
    "run_all_cpi",
    "run_cpi",
]
