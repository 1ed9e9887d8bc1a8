"""Signal rendering: responses -> baseband samples -> range/Doppler maps
(counterpart of ``rts_tpu.sim.render``).

The reference stops at handing ``Response`` objects to the external
simulator's renderer ("Pt applied downstream in rsresponse",
ray_tracer.cpp:1247).  This module completes the chain (BASELINE.md
config 5: "full range/Doppler synthesis, 256-pulse CPI"):

  * each unique-path response contributes a delayed, phase-rotated,
    Doppler-shifted copy of the transmit envelope to its receiver's
    fast-time sample grid, scaled by sqrt(Pt * power_gain) (voltage);
  * pulses stack into a [P, Ns] slow-time x fast-time matrix;
  * windowed FFT over slow time gives the range-Doppler map.

Every function works on the device of its tensor inputs, FFTs through
``torch.fft``, with the types of ``rts_tpu`` in 64-bit mode: the
fast-time axis is computed in float64 and taken in the lanes' type (a
weakly typed array there), so float32 lanes render complex64 samples; the
replica is complex64; a range window's float64 weights widen the
compressed samples to complex128.  ``rts_tpu`` sums every lane of a pulse,
a masked lane adding zero; ``synthesize_cpi`` here gathers each pulse's
valid lanes first, so only the order of the sum differs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from rts_tpu_torch.utils.timing import trace_annotation

# elements of one [pulses, lanes, samples] intermediate of synthesize_cpi
# (complex128: 64 MiB); longer CPIs render in chunks of pulses
_SYNTH_CHUNK_ELEMS = 1 << 22


@dataclasses.dataclass(frozen=True)
class RenderGrid:
    """Fast-time sampling of the receive window."""

    sample_rate: float  # complex baseband sample rate [Hz]
    num_samples: int  # fast-time samples per pulse
    window_start: float  # receive-window open time after pulse start [s]

    @property
    def times(self) -> np.ndarray:
        return self.window_start + np.arange(self.num_samples) / self.sample_rate


def _fast_time(grid: RenderGrid, like) -> torch.Tensor:
    """The receive window's sample times, computed in float64 and taken in
    ``like``'s type on its device."""
    ts = grid.window_start + torch.arange(grid.num_samples, dtype=torch.float64, device=like.device) / grid.sample_rate
    return ts.to(like.dtype)


def synthesize_pulse(
    power,  # [..., K] response power gains (radar-equation product, no Pt)
    delay,  # [..., K] path delays [s]
    phase,  # [..., K] carrier phases [rad]
    doppler,  # [..., K] Doppler shifts [Hz]
    valid,  # [..., K] bool mask
    grid: RenderGrid,
    *,
    tx_power: float = 1.0,
    pulse_length: float = 1e-6,
    chirp_rate: float = 0.0,
    wave=None,  # RadarSignal — overrides pulse_length/chirp_rate (stored OK)
):
    """Complex baseband fast-time samples [..., Ns] for one pulse (or a
    batch of pulses on the leading axes).

    Default: rectangular envelope of ``pulse_length`` with optional LFM
    quadratic phase.  Passing ``wave`` uses its complex envelope instead
    — including STORED sampled waveforms (linear interpolation onto the
    grid).  Every lane contributes; masked lanes contribute zero.
    """
    rel = _fast_time(grid, delay) - delay[..., None]  # [..., K, Ns] time since path arrival
    volt = torch.sqrt(torch.clamp(power, min=0.0) * tx_power)
    carrier_phs = torch.exp(1j * (phase[..., None] + 2.0 * math.pi * doppler[..., None] * rel))
    if wave is not None:
        env = wave.envelope(rel)
    else:
        env = ((rel >= 0.0) & (rel < pulse_length)).to(power.dtype)
        if chirp_rate:
            env = env * torch.exp(1j * (math.pi * chirp_rate) * rel**2)
    contrib = volt[..., None] * env * carrier_phs
    contrib = torch.where(valid[..., None], contrib, contrib.new_zeros(()))
    return contrib.sum(dim=-2)


def waveform_replica(grid: RenderGrid, *, pulse_length: float = 1e-6, chirp_rate: float = 0.0, wave=None,
                     device="cuda"):
    """Unit-amplitude transmit replica on the fast-time grid (delay 0), on
    ``device`` (the card unless the caller asks for another): complex64,
    its phase evaluated on float64 times."""
    rel = torch.arange(grid.num_samples, dtype=torch.float64, device=device) / grid.sample_rate
    if wave is not None:
        return wave.envelope(rel).to(torch.complex64)
    env = (rel < pulse_length).to(torch.float32)
    return (env * torch.exp(1j * (math.pi * chirp_rate * rel**2))).to(torch.complex64)


def taylor_window(n: int, nbar: int = 4, sll_db: float = 35.0, xp=np):
    """Taylor taper: near-uniform aperture efficiency with the first
    ``nbar`` sidelobes held at -``sll_db`` dB (the standard radar range
    window).  Classic closed form, in NumPy float64; ``xp.asarray`` of it
    (``xp=torch`` for a CPU tensor)."""
    a = np.arccosh(10.0 ** (sll_db / 20.0)) / np.pi
    sigma2 = nbar**2 / (a**2 + (nbar - 0.5) ** 2)
    m = np.arange(1, nbar)
    f = np.zeros(nbar - 1)
    for mi in range(1, nbar):
        num = np.prod(1.0 - (mi**2 / sigma2) / (a**2 + (m - 0.5) ** 2))
        den = np.prod([1.0 - mi**2 / k**2 for k in range(1, nbar) if k != mi])
        f[mi - 1] = ((-1) ** (mi + 1) * num) / (2.0 * den)
    x = (np.arange(n) - (n - 1) / 2.0) / n
    w = 1.0 + 2.0 * sum(f[mi - 1] * np.cos(2.0 * np.pi * mi * x) for mi in range(1, nbar))
    return xp.asarray(w / w.max())


def hamming_window(n: int, xp=np):
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))
    return xp.asarray(w)


def _band_weighting(replica_np: np.ndarray, window: str) -> np.ndarray:
    """Frequency-domain sidelobe weighting over the replica's OWN band.

    The occupied band is detected from the replica's power spectrum (so
    the weighting is correct for any waveform convention — this library's
    LFM sweeps [0, B] at baseband, stored waveforms can sit anywhere):
    bins within -20 dB of the spectral peak, taken contiguous on the
    fftshifted axis, carry the taper; everything else is zeroed (the
    matched filter already bandlimits).  Host NumPy, as ``rts_tpu``."""
    n = replica_np.shape[-1]
    h = np.fft.fft(replica_np, n)
    mag2 = np.fft.fftshift(np.abs(h) ** 2)
    inband = mag2 >= mag2.max() * 1e-2  # -20 dB occupancy
    first, last = int(np.argmax(inband)), n - 1 - int(np.argmax(inband[::-1]))
    pos = np.clip((np.arange(n) - first) / max(last - first, 1), 0.0, 1.0)
    if window == "taylor":
        taper = np.interp(pos, np.linspace(0, 1, 4096), taylor_window(4096))
    elif window == "hamming":
        taper = 0.54 - 0.46 * np.cos(2.0 * np.pi * pos)
    else:
        raise ValueError(f"unknown range window {window!r}")
    w = np.zeros(n)
    w[first : last + 1] = taper[first : last + 1]
    return np.fft.ifftshift(w)


def pulse_compress(samples, replica, *, window: str | None = None,
                   sample_rate: float | None = None, bandwidth: float | None = None):
    """Matched filter along fast time via FFT correlation.

    ``samples``: [..., Ns]; output the same shape, peak at the path's
    leading-edge bin (circular correlation — the receive window must be
    long enough that wrap-around energy is out of the scene).

    ``window``: optional range-sidelobe taper ("taylor" or "hamming")
    applied across the replica's occupied band in the frequency domain.
    ``sample_rate``/``bandwidth`` are accepted for API symmetry; the band
    itself is detected from the replica spectrum.
    """
    n = samples.shape[-1]
    s = torch.fft.fft(samples, dim=-1)
    h = torch.conj(torch.fft.fft(replica, n))
    if window is not None:
        h = h * torch.as_tensor(_band_weighting(replica.cpu().numpy(), window), device=h.device)
    return torch.fft.ifft(s * h, dim=-1)


def _valid_lanes(valid):
    """(idx, mask) [P, Kmax]: each pulse's valid lanes in lane order, padded
    (mask False) to the most any pulse has, at least one.  Built from the
    valid lanes alone, so it holds no [P, K] index array."""
    p = valid.shape[0]
    rows, cols = torch.nonzero(valid, as_tuple=True)  # row-major: lane order within a pulse
    counts = torch.bincount(rows, minlength=p)
    kmax = max(int(counts.max()) if p else 0, 1)
    slot = torch.arange(rows.numel(), device=valid.device) - (torch.cumsum(counts, 0) - counts)[rows]
    idx = torch.zeros((p, kmax), dtype=torch.int64, device=valid.device)
    mask = torch.zeros((p, kmax), dtype=torch.bool, device=valid.device)
    idx[rows, slot] = cols
    mask[rows, slot] = True
    return idx, mask


def synthesize_cpi(
    power,  # [P, K]
    delay,  # [P, K]
    phase,  # [P, K]
    doppler,  # [P, K]
    valid,  # [P, K]
    grid: RenderGrid,
    *,
    tx_power: float = 1.0,
    pulse_length: float = 1e-6,
    chirp_rate: float = 0.0,
    wave=None,
):
    """Slow-time x fast-time matrix [P, Ns] for a CPI, on the device of the
    inputs (complex64 for float32 lanes).

    Only the lanes ``valid`` selects contribute: they are gathered per
    pulse in lane order and padded (with masked lanes) to the most any
    pulse has, at least one, and the [P, Kmax, Ns] intermediates are
    evaluated in chunks of pulses of at most ``_SYNTH_CHUNK_ELEMS``
    elements.
    """
    idx, mask = _valid_lanes(valid)
    fields = [torch.gather(a, 1, idx) for a in (power, delay, phase, doppler)] + [mask]
    step = max(1, _SYNTH_CHUNK_ELEMS // (idx.shape[1] * grid.num_samples))
    kw = dict(tx_power=tx_power, pulse_length=pulse_length, chirp_rate=chirp_rate, wave=wave)
    return torch.cat([synthesize_pulse(*(a[p0:p0 + step] for a in fields), grid, **kw)
                      for p0 in range(0, max(idx.shape[0], 1), step)])


BOLTZMANN = 1.380649e-23


def add_thermal_noise(samples, noise_temperature, bandwidth, generator: torch.Generator):
    """Complex AWGN for a receiver noise temperature (the quantity each
    Response carries from Receiver.GetNoiseTemperature, ray_tracer.cpp:1318).

    Noise power = k_B * T * B per complex sample, drawn from ``generator``
    (a ``torch.Generator`` on the samples' device; ``rts_tpu`` takes a
    ``jax.random`` key), in the samples' real type."""
    sigma = float(np.sqrt(BOLTZMANN * noise_temperature * bandwidth / 2.0))
    real = samples.real.dtype if samples.is_complex() else samples.dtype
    draw = lambda: torch.randn(samples.shape, generator=generator, dtype=real, device=samples.device)
    return samples + sigma * torch.complex(draw(), draw())


def range_doppler_map(cpi_samples, *, window: str = "hann"):
    """[P, Ns] slow/fast matrix -> [P, Ns] range-Doppler magnitude.

    FFT over slow time (pulse axis) with an optional window; Doppler bins
    are fftshifted so zero Doppler sits at row P//2.
    """
    p = cpi_samples.shape[0]
    k = torch.arange(p, dtype=torch.float64, device=cpi_samples.device)
    if window == "hann":  # float64 weights taken in the samples' type, as rts_tpu's weak ones
        w = (0.5 - 0.5 * torch.cos(2.0 * math.pi * k / p)).to(cpi_samples.real.dtype)
    elif window == "rect":  # rts_tpu's float64 ones widen complex64 samples
        w = torch.ones_like(k)
    else:
        raise ValueError(f"unknown window {window!r}")
    spec = torch.fft.fftshift(torch.fft.fft(cpi_samples * w[:, None], dim=0), dim=0)
    return torch.abs(spec)


def render_cpi_result(
    out,  # CpiResult from trace_cpi
    rx_index: int,
    grid: RenderGrid,
    *,
    tx_power: float = 1.0,
    pulse_length: float = 1e-6,
    chirp_rate: float = 0.0,
    wave=None,
    compress: bool = False,
    range_window: str | None = None,
):
    """Render one receiver's range-Doppler map from a traced CPI, on its
    device: (map [P, Ns] float64, samples [P, Ns] complex128).

    Uses the emit-masked unique-path lanes — the equivalent of looping
    over Response objects (ray_tracer.cpp:1290-1321).  All four
    quantities are the path-group aggregates (aggregation.cu:89-93,169;
    ray_tracer.cpp:1310-1316); the phase is ``agg.phase`` alone, as in
    ``rts_tpu``.  The call is the ``rts.render`` span.
    """
    with trace_annotation("rts.render"):
        valid = out.agg.emit & (out.received == rx_index)
        samples = synthesize_cpi(
            out.agg.power, out.agg.delay, out.agg.phase, out.agg.doppler, valid, grid,
            tx_power=tx_power, pulse_length=pulse_length, chirp_rate=chirp_rate, wave=wave,
        )
        if compress:
            replica = waveform_replica(grid, pulse_length=pulse_length, chirp_rate=chirp_rate, wave=wave,
                                       device=samples.device)
            bw = wave.bandwidth if wave is not None else abs(chirp_rate) * pulse_length
            samples = pulse_compress(samples, replica, window=range_window, sample_rate=grid.sample_rate,
                                     bandwidth=bw)
        return range_doppler_map(samples), samples


def responses_to_map(
    responses: Sequence,
    pulse_times: Sequence[float],
    grid: RenderGrid,
    *,
    tx_power: float = 1.0,
    pulse_length: float = 1e-6,
    device="cuda",
):
    """Render from host-side Response objects (driver path): the points
    are gathered per pulse on the host in float64, then synthesised and
    transformed on ``device`` (the card unless the caller asks for
    another)."""
    p = len(pulse_times)
    k = max((len(r.points) for r in responses), default=0)
    arrs = {n: np.zeros((p, max(k, 1) * max(len(responses), 1))) for n in ("power", "delay", "phase", "doppler")}
    valid = np.zeros_like(arrs["power"], dtype=bool)
    t_index = {round(float(t), 12): i for i, t in enumerate(pulse_times)}
    counts = [0] * p
    for r in responses:
        for pt in r.points:
            i = t_index.get(round(pt.time - pt.delay, 12))
            if i is None:
                continue
            j = counts[i]
            counts[i] += 1
            arrs["power"][i, j] = pt.power
            arrs["delay"][i, j] = pt.delay
            arrs["phase"][i, j] = pt.phase
            arrs["doppler"][i, j] = pt.doppler
            valid[i, j] = True
    t = lambda a: torch.as_tensor(a, device=device)
    samples = synthesize_cpi(
        t(arrs["power"]), t(arrs["delay"]), t(arrs["phase"]), t(arrs["doppler"]), t(valid), grid,
        tx_power=tx_power, pulse_length=pulse_length,
    )
    return range_doppler_map(samples), samples
