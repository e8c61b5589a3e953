"""End-to-end scripts of the port, the counterparts of ``examples/``:
``python -m demiurge_tpu_torch.examples.make_planet`` and
``python -m demiurge_tpu_torch.examples.ocean_climate``."""
