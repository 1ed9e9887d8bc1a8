"""Waveforms and pulse schedules.

Stands in for the external ``RadarSignal`` / ``TransmitterPulse``
(ray_tracer.cpp:811-815, 843-847, §2.3): the tracer only needs the
carrier, the per-pulse start time, and the noise temperature; power,
length and the complex envelope feed the downstream response rendering.

Waveform families (FERS' RadarSignal carries arbitrary waveforms; the
tracer is waveform-agnostic, rendering is where they matter):
  * analytic CW pulse — rectangular envelope;
  * analytic LFM — rectangular envelope with quadratic phase;
  * STORED waveform — arbitrary complex baseband samples at ``rate``,
    linearly interpolated onto the receive fast-time grid
    (``RadarSignal.from_samples`` / ``from_file``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RadarSignal:
    name: str = "pulse"
    carrier: float = 10e9  # Hz
    power: float = 1.0  # transmit power Pt [W] — applied at rendering
    length: float = 1e-6  # pulse length [s]
    rate: float = 0.0  # sample rate of the stored waveform (0 = analytic)
    chirp_rate: float = 0.0  # LFM sweep rate [Hz/s]; 0 = plain CW pulse
    temperature: float = 0.0  # added to receiver noise temperature
    # stored complex baseband envelope (None = analytic CW/LFM)
    samples: object = dataclasses.field(default=None, compare=False)

    @property
    def bandwidth(self) -> float:
        if self.samples is not None:
            return float(self.rate)  # stored waveforms span their sample rate
        return abs(self.chirp_rate) * self.length

    @classmethod
    def from_samples(cls, iq, rate: float, **kw) -> "RadarSignal":
        """A stored waveform from complex baseband samples at ``rate``."""
        iq = np.ascontiguousarray(np.asarray(iq, np.complex64))
        kw.setdefault("length", iq.shape[0] / float(rate))
        return cls(rate=float(rate), samples=iq, **kw)

    @classmethod
    def from_file(cls, path: str, rate: float, **kw) -> "RadarSignal":
        """Load a stored waveform: ``.npy`` (complex array) or text with
        one "I Q" pair per line."""
        if str(path).endswith(".npy"):
            iq = np.load(path)
        else:
            raw = np.loadtxt(path, dtype=np.float64)
            raw = raw.reshape(-1, 2)
            iq = raw[:, 0] + 1j * raw[:, 1]
        return cls.from_samples(iq, rate, **kw)

    def envelope(self, rel, xp=np):
        """Complex envelope at times ``rel`` since pulse start (0 outside).

        Analytic: rect(length) x exp(j*pi*chirp_rate*rel^2).  Stored:
        linear interpolation of the sample array at rel*rate.  A tensor
        ``rel`` is evaluated in torch on its device (``xp`` unused); other
        array-likes through ``xp``.
        """
        if torch.is_tensor(rel):
            return self._envelope_torch(rel)
        rel = xp.asarray(rel)
        if self.samples is None:
            env = ((rel >= 0.0) & (rel < self.length)).astype(xp.float32)
            if self.chirp_rate:
                return env * xp.exp(1j * (xp.pi * self.chirp_rate) * rel * rel)
            return env.astype(xp.complex64)
        iq = xp.asarray(self.samples)
        n = iq.shape[0]
        pos = rel * self.rate
        inside = (pos >= 0) & (pos <= n - 1)
        i0c = xp.clip(xp.floor(pos), 0, n - 2).astype(xp.int32)
        frac = (pos - i0c).astype(xp.float32)  # in [0, 1]; 1 at the last sample
        out = iq[i0c] * (1.0 - frac) + iq[i0c + 1] * frac
        return xp.where(inside, out, xp.asarray(0.0 + 0.0j, out.dtype))

    def _envelope_torch(self, rel):
        """``envelope`` on a tensor, with the types of the array path: a
        float32 rect (complex64), the chirp in the complex type of the
        times, complex64 stored samples."""
        if self.samples is None:
            env = ((rel >= 0.0) & (rel < self.length)).to(torch.float32)
            if self.chirp_rate:
                return env * torch.exp(1j * (math.pi * self.chirp_rate) * rel * rel)
            return env.to(torch.complex64)
        iq = torch.as_tensor(self.samples, device=rel.device)
        n = iq.shape[0]
        pos = rel * self.rate
        inside = (pos >= 0) & (pos <= n - 1)
        i0c = torch.clamp(torch.floor(pos), 0, n - 2).long()
        frac = (pos - i0c).to(torch.float32)  # in [0, 1]; 1 at the last sample
        out = iq[i0c] * (1.0 - frac) + iq[i0c + 1] * frac
        return torch.where(inside, out, out.new_zeros(()))

    def GetCarrier(self):  # noqa: N802
        return self.carrier

    def GetTemp(self):  # noqa: N802
        return self.temperature

    def GetPower(self):  # noqa: N802
        return self.power


@dataclasses.dataclass
class TransmitterPulse:
    wave: RadarSignal = None
    time: float = 0.0
