"""The comparison that decides ``correct``: the program's fields against
the plain reference's, each as the share of pixels that disagree.

A pixel disagrees where |program - reference| > rtol * |reference| + atol *
scale, or where exactly one of the two is not finite.  The scale is the
median |reference| over the finite nonzero pixels: a typical magnitude,
which neither land's zero velocities nor the climate's overflowing
pixels move.  Where both are not finite the pixel agrees:
the explicit climate overflows at the finest grids (T^4 past float32),
and the program must overflow where the reference does.  A compared
number is a field's largest share over the compared steps; each has a
limit of its own in the configuration's file.
"""

from __future__ import annotations

import torch


def mismatch_share(prog: torch.Tensor, ref: torch.Tensor, rtol: float,
                   atol: float) -> float:
    p = prog.to(torch.float32)
    r = ref.to(device=p.device, dtype=torch.float32)
    fp, fr = torch.isfinite(p), torch.isfinite(r)
    typical = r.abs()[fr & (r != 0)]
    scale = float(typical.median()) if typical.numel() else 1.0
    both = fp & fr
    gap = torch.where(both, (p - r).abs(), 0.0)
    bad = (fp != fr) | (gap > rtol * r.abs().nan_to_num(0.0, 0.0, 0.0)
                        + atol * scale)
    return float(bad.to(torch.float64).mean())


def compare_steps(pairs, check: dict):
    """``pairs``: (program fields, reference fields) of each compared step;
    ``check``: the configuration's ``check`` (rtol, atol, limits by
    field).  Returns ({field: {"value": largest share, "limit": limit}},
    the number of steps with a field over its limit)."""
    shares = [{f: mismatch_share(p[f], r[f], check["rtol"], check["atol"])
               for f in check["limits"]} for p, r in pairs]
    compared = {f: {"value": max(s[f] for s in shares), "limit": limit}
                for f, limit in check["limits"].items()}
    failed = sum(any(s[f] > check["limits"][f] for f in s) for s in shares)
    return compared, failed


def passed(compared: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in compared.values())
