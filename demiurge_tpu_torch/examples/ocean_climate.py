"""Ocean currents + seasonal climate on a generated planet, with a
vector-field overlay render.

Counterpart of ``examples/ocean_climate.py`` (the reference's OceanCurrents
and Temperature filters seen through the VectorField appearance layer),
with the same arguments and defaults plus ``--device``:

    python -m demiurge_tpu_torch.examples.ocean_climate --size 360 180 \\
        --ocean-steps 5 --climate-substeps 100 --out currents.png \\
        [--device cpu]
"""

import argparse

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, nargs=2, default=(360, 180),
                    metavar=("W", "H"))
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--ocean-steps", type=int, default=5)
    ap.add_argument("--jacobi", type=int, default=500)
    ap.add_argument("--climate-substeps", type=int, default=100)
    ap.add_argument("--out", default="currents.png")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    from demiurge_tpu_torch.api import Project
    from demiurge_tpu_torch.ops.noise import NoiseParams
    from demiurge_tpu_torch.ops.ocean import OceanConfig
    from demiurge_tpu_torch.viz import appearance

    W, H = args.size
    p = Project(W, H, device=args.device)
    print(f"[1/4] terrain {W}x{H}")
    p.gradient_noise(NoiseParams(mode="default", octaves=6, scale=2.0,
                                 min=-3.0, max=4.0, seed=args.seed))

    print(f"[2/4] ocean currents x{args.ocean_steps} "
          f"(jacobi {args.jacobi}, Coriolis on)")
    u, v = p.ocean_currents(
        steps=args.ocean_steps,
        cfg=OceanConfig(jacobi_iters=args.jacobi, diffusion_iters=50))
    speed = torch.sqrt(u * u + v * v)
    print(f"      max current speed: {float(speed.max()):.3f}")

    print(f"[3/4] climate x{args.climate_substeps} substeps")
    T = p.temperature_sim(substeps=args.climate_substeps,
                          write_terrain=False)
    print(f"      mean T: {float(T.mean()):.1f} C, "
          f"equator-pole contrast: "
          f"{float(T[H // 2].mean() - T[-1].mean()):.1f} C")

    print("[4/4] render with current arrows")
    layers = [appearance.ElevationMap(), appearance.Hillshade(),
              appearance.VectorField(spacing=12, scale=6.0)]
    img = p.render(layers=layers, uv=(u, v), out_w=2 * W, out_h=W)
    appearance.to_png(img, args.out)
    print(f"wrote {args.out}")
    return p, img


if __name__ == "__main__":
    main()
