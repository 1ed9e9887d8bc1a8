"""Terrain imaging demo on rts_tpu_torch: 1M-triangle heightfield, 64-pulse
CPI, chirped waveform, compressed range-Doppler map (BASELINE configs 4+5;
examples/terrain_imaging.py on the PyTorch/CUDA port).

Run:  PYTHONPATH=. python examples/torch_terrain_imaging.py [--tris 200000] [--device cpu]
"""

import argparse
import math

import numpy as np

from rts_tpu_torch import Parameters
from rts_tpu_torch.sim import (
    AttitudePath,
    Path,
    RadarSignal,
    Receiver,
    RenderGrid,
    RotationPath,
    Target,
    Transmitter,
    World,
    render_cpi_result,
    run_cpi,
)

C = 299792458.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tris", type=int, default=200000)
    ap.add_argument("--pulses", type=int, default=64)
    ap.add_argument("--rays", type=int, default=15)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    n = max(2, round(math.sqrt(args.tris / 2)) + 1)
    alt = 4000.0
    w = World()
    w.add(
        Transmitter(
            path=Path.fixed(0, 0, alt),
            rotation=RotationPath(elevation=-math.pi / 2),
            wave=RadarSignal(carrier=10e9, chirp_rate=5e12, length=4e-6),
            pulse_count=args.pulses,
            prf=2000.0,
            tx_span=(0.15, 0.15, 0.0),
        )
    )
    w.add(
        Receiver(
            path=Path.fixed(0, 0, alt),
            rotation=RotationPath(elevation=-math.pi / 2),
            sphere=(30.0, 1.2, 1.2),
        )
    )
    w.add(Target(shape="terrain", terrain=(n, 12000.0, 300.0, 3), refl_coeff=0.9))
    # a moving vehicle-like plate above the terrain
    w.add(
        Target(
            shape="rect",
            rect=(2.0, 30.0, 30.0),
            attitude=AttitudePath(pitch=math.pi / 2),
            path=Path.linear([(0.0, (0.0, 0.0, 400.0)), (1.0, (12.0, 0.0, 400.0))]),
            refl_coeff=0.9,
        )
    )

    params = Parameters(num_rays=args.rays, max_refl_depth=2)
    out = run_cpi(w, params, accel="cluster", attach_responses=False, device=args.device)
    received = int((out.received >= 0).sum())
    print(f"traced {params.rays_per_fan} rays x {args.pulses} pulses over "
          f"{2*(n-1)**2} terrain tris; received {received}")

    fs = 50e6
    grid = RenderGrid(sample_rate=fs, num_samples=1024, window_start=2 * (alt - 450.0) / C)
    rd, _ = render_cpi_result(out, 0, grid, pulse_length=4e-6, chirp_rate=5e12, compress=True)
    rd = rd.cpu().numpy()
    row, col = np.unravel_index(np.argmax(rd), rd.shape)
    rng = (grid.window_start + col / fs) * C / 2
    fd = (row - args.pulses // 2) * 2000.0 / args.pulses
    print(f"strongest compressed return: range ~{rng:.0f} m, Doppler {fd:+.0f} Hz")


if __name__ == "__main__":
    main()
