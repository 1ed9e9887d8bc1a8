"""Command-line front-end: run scene files, inspect results.

    python -m rts_tpu_torch run scene.xml [--cpi] [--accel cluster] [--refine]
                                [--out responses.npz] [--device cpu]
    python -m rts_tpu_torch info scene.xml

The counterpart of ``python -m rts_tpu``.  Every trace runs on
``--device``, the card unless asked for another; ``--refine`` is the
float64 precision replay of the float32 engine.
"""

from __future__ import annotations

import argparse
import sys


def _cmd_run(args) -> int:
    from rts_tpu_torch.sim import load_world, run, run_all_cpi
    from rts_tpu_torch.sim.export import save_responses

    world, params = load_world(args.scene)
    if args.cpi:
        run_all_cpi(world, params, device=args.device, accel=args.accel, refine=args.refine)
    else:
        run(world, params, device=args.device, verbose=args.verbose)
    total = sum(len(rx.responses) for rx in world.receivers)
    print(f"responses: {total}")
    for rx in world.receivers:
        print(f"  {rx.name}: {len(rx.responses)}")
    if args.out:
        save_responses(args.out, world)
        print(f"saved {args.out}")
    return 0


def _cmd_info(args) -> int:
    from rts_tpu_torch.sim import load_world

    world, params = load_world(args.scene)
    print(f"parameters: {params}")
    print(f"transmitters ({len(world.transmitters)}):")
    for t in world.transmitters:
        print(f"  {t.name}: {t.GetPulseCount()} pulses @ {t.prf} Hz, carrier {t.wave.GetCarrier():.3e} Hz")
    print(f"receivers ({len(world.receivers)}):")
    for r in world.receivers:
        print(f"  {r.name}: sphere {r.sphere}")
    print(f"targets ({len(world.targets)}):")
    for g in world.targets:
        mesh = g.base_mesh()
        print(f"  {g.name}: {g.shape}, {mesh.num_tris} tris, refl {g.refl_coeff}, refr {g.refr_index}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rts_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    run_p = sub.add_parser("run", help="simulate a scene file")
    run_p.add_argument("scene", help=".json / .toml / .xml scene document")
    run_p.add_argument("--cpi", action="store_true", help="whole-CPI path (prepare_cpi + trace_cpi)")
    run_p.add_argument("--accel", choices=("brute", "cluster"), default="brute")
    run_p.add_argument(
        "--refine", action="store_true",
        help="float64 path replay (f32 engine at the 1e-6 power/phase contract)",
    )
    run_p.add_argument("--out", help="write responses to this .npz or .h5")
    run_p.add_argument("--device", default="cuda", help="torch device to trace on (default: cuda)")
    run_p.add_argument("--verbose", action="store_true")
    run_p.set_defaults(fn=_cmd_run)

    info_p = sub.add_parser("info", help="describe a scene file")
    info_p.add_argument("scene")
    info_p.set_defaults(fn=_cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
