"""The one generator of traffic: a mix's data file, read with the
configuration it runs on.

A mix is a closed loop of one client: runs of ``run_steps`` steps back to
back, each from a fresh start on the seeded terrain.  ``run_steps`` is a
number, or ``"config"`` for the configuration's own ``run_steps`` (the
length its CLI runs by default).
"""

from __future__ import annotations

from typing import NamedTuple


class Plan(NamedTuple):
    run_steps: int


def plan(traffic: dict, cfg: dict) -> Plan:
    n = traffic["run_steps"]
    n = cfg["run_steps"] if n == "config" else int(n)
    if n < 1:
        raise ValueError(f"run_steps {n} < 1")
    return Plan(run_steps=n)
