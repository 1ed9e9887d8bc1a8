"""Load a declarative XML scene and run the sequential driver on
rts_tpu_torch (examples/from_xml.py on the PyTorch/CUDA port).

Run:  PYTHONPATH=. python examples/torch_from_xml.py [--device cpu]
"""

import argparse
import os
import tempfile

from rts_tpu_torch.sim import load_world, run
from rts_tpu_torch.sim.export import save_responses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scene.xml")
    world, params = load_world(path)
    summary = run(world, params, verbose=True, device=args.device)
    print(f"total responses: {summary.total_responses}")
    for rx in world.receivers:
        print(f"  {rx.name}: {len(rx.responses)} responses")
    out = os.path.join(tempfile.gettempdir(), "responses.npz")
    save_responses(out, world)
    print(f"saved {out}")


if __name__ == "__main__":
    main()
