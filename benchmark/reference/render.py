"""The range-Doppler map of one receiver, rendered plainly in complex128.

Each emitted path adds sqrt(power) times the transmit envelope (a
rectangle of the pulse length with the LFM phase pi k t^2), delayed by its
delay and turned by its phase plus its Doppler over the time since its
arrival, to the pulse's fast-time samples; each pulse is compressed by
correlation with the replica (an FFT product); a Hann window and an FFT
over the pulses give the Doppler axis, zero Doppler in row P // 2.
"""

from __future__ import annotations

import math

import torch


def render_map(agg, received, rx: int, grid: dict, pulse_length: float, chirp_rate: float,
               compress: bool, window_start: float, dtype=torch.complex128):
    """[P, Ns] map magnitude from per-pulse aggregates ([P, R] fields)."""
    p = received.shape[0]
    dev = received.device
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    ns, fs = int(grid["num_samples"]), float(grid["sample_rate"])
    times = window_start + torch.arange(ns, dtype=torch.float64, device=dev) / fs
    rows = []
    for k in range(p):
        lanes = torch.nonzero(agg.emit[k] & (received[k] == rx)).reshape(-1)
        s = torch.zeros(ns, dtype=dtype, device=dev)
        for chunk in lanes.split(64):
            rel = (times[None, :] - agg.delay[k, chunk].double()[:, None]).to(real)
            env = ((rel >= 0) & (rel < pulse_length)).to(dtype)
            if chirp_rate:
                env = env * torch.exp(1j * (math.pi * chirp_rate) * rel ** 2).to(dtype)
            volt = torch.sqrt(torch.clamp(agg.power[k, chunk].to(real), min=0.0))
            turn = torch.exp(1j * (agg.phase[k, chunk].to(real)[:, None]
                                   + 2 * math.pi * agg.doppler[k, chunk].to(real)[:, None] * rel)).to(dtype)
            s = s + (volt[:, None] * env * turn).sum(0)
        rows.append(s)
    samples = torch.stack(rows)
    if compress:
        rel = torch.arange(ns, dtype=torch.float64, device=dev) / fs
        replica = ((rel < pulse_length).to(torch.float64) * torch.exp(1j * math.pi * chirp_rate * rel ** 2)).to(dtype)
        samples = torch.fft.ifft(torch.fft.fft(samples, dim=-1) * torch.conj(torch.fft.fft(replica)), dim=-1)
    k = torch.arange(p, dtype=torch.float64, device=dev)
    w = (0.5 - 0.5 * torch.cos(2 * math.pi * k / p)).to(real)
    return torch.abs(torch.fft.fftshift(torch.fft.fft(samples * w[:, None], dim=0), dim=0))
