"""Device milliseconds a step of the operations launched inside the
program's ``ocean.viscosity.coefficients`` and
``ocean.pressure.coefficients`` spans: the two Jacobi solves' per-pixel
coefficient builds (``kernels.jacobi.diffusion_coefficients``,
``coefficients``), plain torch ahead of K3 and K2."""


def read(t):
    s = t.time_under("ocean.viscosity.coefficients") \
        + t.time_under("ocean.pressure.coefficients")
    return 1e3 * s / t.steps if s and t.steps else None
