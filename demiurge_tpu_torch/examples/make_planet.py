"""End-to-end planet generation: noise -> tectonics -> erosion -> render.

Counterpart of ``examples/make_planet.py`` (the reference's interactive
workflow, GradientNoise -> Tectonics -> cpufilter -> appearance render, as
a script), with the same arguments and defaults plus ``--device``:

    python -m demiurge_tpu_torch.examples.make_planet --size 512 256 \\
        --erosion-iters 20 --out planet.png [--device cpu]

Writes the rendered RGBA PNG plus a lossless .npz session next to it.
"""

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, nargs=2, default=(512, 256),
                    metavar=("W", "H"))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--tectonics-steps", type=int, default=0,
                    help="plate-tectonics steps before erosion (0 = skip)")
    ap.add_argument("--erosion-iters", type=int, default=20)
    ap.add_argument("--projection", default="equirectangular",
                    choices=["equirectangular", "mollweide", "hammer",
                             "robinson", "sinusoidal", "goode", "eckert4",
                             "mercator", "orthographic"])
    ap.add_argument("--out", default="planet.png")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    from demiurge_tpu_torch.api import Project
    from demiurge_tpu_torch.ops.noise import NoiseParams
    from demiurge_tpu_torch.viz import appearance

    W, H = args.size
    p = Project(W, H, device=args.device)

    print(f"[1/4] fbm terrain {W}x{H} (ridged, seed {args.seed})")
    p.gradient_noise(NoiseParams(mode="ridged", octaves=8, scale=1.5,
                                 min=-4.0, max=6.0, seed=args.seed))

    if args.tectonics_steps:
        print(f"[2/4] tectonics x{args.tectonics_steps}")
        p.tectonics(steps=args.tectonics_steps)
    else:
        print("[2/4] tectonics skipped")

    print(f"[3/4] landscape evolution x{args.erosion_iters} "
          "(flow routing + stream-power erosion)")
    p.landscape_evolution(iterations=args.erosion_iters)

    print(f"[4/4] render ({args.projection}: elevation + hillshade)")
    layers = [appearance.ElevationMap(), appearance.Hillshade()]
    img = p.render(layers=layers, projection=args.projection,
                   out_w=2 * W, out_h=W)
    appearance.to_png(img, args.out)
    p.save(os.path.splitext(args.out)[0] + ".npz")
    print(f"wrote {args.out} and {os.path.splitext(args.out)[0]}.npz")
    return p, img


if __name__ == "__main__":
    main()
