"""Multi-device search and build over a single-controller mesh of torch
devices (the JAX package's ``parallel`` package): :mod:`.mesh`,
:mod:`.sharded`, :mod:`.dynamic`."""
