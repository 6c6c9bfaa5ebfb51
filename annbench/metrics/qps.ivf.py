"""Queries answered in the window over the window's wall seconds, in the
IVF cells: their device-bound loop spreads far less than the host-bound
Vamana cells' ``qps``, so they keep a bound of their own."""

from annbench.readers import qps as read  # noqa: F401
