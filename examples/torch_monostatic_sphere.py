"""Minimal end-to-end example on rts_tpu_torch: monostatic radar, moving
sphere, one CPI (examples/monostatic_sphere.py on the PyTorch/CUDA port).

Run:  PYTHONPATH=. python examples/torch_monostatic_sphere.py [--device cpu]
"""

import argparse
import os
import tempfile

import numpy as np

from rts_tpu_torch import Parameters
from rts_tpu_torch.sim import (
    Path,
    RadarSignal,
    Receiver,
    RenderGrid,
    Target,
    Transmitter,
    World,
    render_cpi_result,
    run_cpi,
)
from rts_tpu_torch.sim.export import save_cpi

C = 299792458.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    world = World()
    world.add(
        Transmitter(
            name="tx0",
            path=Path.fixed(0, 0, 0),
            wave=RadarSignal(carrier=10e9),
            pulse_count=32,
            prf=1000.0,
            tx_span=(0.1, 0.1, 0.0),
        )
    )
    world.add(Receiver(name="rx0", path=Path.fixed(0, 0, 0), sphere=(10.0, 1.0, 1.0)))
    world.add(
        Target(
            name="ball",
            shape="sphere",
            sphere_params=(4, 20.0),
            path=Path.linear([(0.0, (900.0, 0.0, 0.0)), (1.0, (905.0, 0.0, 0.0))]),
            refl_coeff=0.9,
        )
    )

    params = Parameters(num_rays=9, max_refl_depth=2)
    out = run_cpi(world, params, attach_responses=False, device=args.device)

    received = int((out.received >= 0).sum())
    print(f"received rays across CPI: {received}")

    grid = RenderGrid(sample_rate=50e6, num_samples=512, window_start=5.5e-6)
    rd, _ = render_cpi_result(out, rx_index=0, grid=grid, pulse_length=2e-8)
    rd = rd.cpu().numpy()
    row, col = np.unravel_index(np.argmax(rd), rd.shape)
    rng_m = (grid.window_start + col / grid.sample_rate) * C / 2
    prf, p = 1000.0, rd.shape[0]
    fd = (row - p // 2) * prf / p
    print(f"range-Doppler peak: ~{rng_m:.0f} m, {fd:+.0f} Hz Doppler")

    path = os.path.join(tempfile.gettempdir(), "cpi_result.npz")
    save_cpi(path, out)
    print(f"saved {path}")


if __name__ == "__main__":
    main()
