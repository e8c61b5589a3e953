"""A test helper: run a module of the port with XLA's float32 sin, cos,
asin, acos, atan2, sqrt, log, exp and pow in place of torch's.

torch's and XLA's CPU implementations of these functions differ by an ulp
at a few percent of their inputs (and torch's CPU sqrt is not always
correctly rounded).  A nearest fetch at a coordinate computed from them
can then land on the neighbouring pixel.  With XLA's functions swapped in,
the port evaluates every other op itself, so a test can hold it bit for
bit to the reference: where the inputs of a tap are equal, so is its
output.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import torch

_XLA = {"sin": jnp.sin, "cos": jnp.cos, "asin": jnp.arcsin,
        "acos": jnp.arccos, "atan2": jnp.arctan2, "sqrt": jnp.sqrt,
        "log": jnp.log, "exp": jnp.exp, "pow": jnp.power}


def _through_xla(fn):
    def call(*args):
        device = args[0].device
        out = fn(*(jnp.asarray(a.detach().cpu().numpy())
                   if isinstance(a, torch.Tensor) else a for a in args))
        return torch.from_numpy(np.array(out)).to(device)
    return call


class _TorchWithXlaLibm:
    """``torch``, but for the functions in ``_XLA``."""

    def __getattr__(self, name):
        return getattr(torch, name)


for _name, _fn in _XLA.items():
    setattr(_TorchWithXlaLibm, _name, staticmethod(_through_xla(_fn)))


@contextlib.contextmanager
def xla_libm(*modules):
    """Within the block, each module's ``torch`` is the proxy."""
    saved = [m.torch for m in modules]
    for m in modules:
        m.torch = _TorchWithXlaLibm()
    try:
        yield
    finally:
        for m, t in zip(modules, saved):
            m.torch = t
