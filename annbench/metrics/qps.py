"""Queries answered in the window over the window's wall seconds."""

from annbench.readers import qps as read  # noqa: F401
