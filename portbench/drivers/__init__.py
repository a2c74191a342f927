"""Drivers: the general code that turns a traffic mix into a run. A mix
names its driver (``"driver"`` in ``traffic/<mix>.json``); every driver has
``run(cell, seed, seconds, trace, device, t_start) -> harness.Outcome``."""
