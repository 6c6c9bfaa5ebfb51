"""The device's idle share of a traced stretch of the window."""

from annbench.readers import device_idle_pct as read  # noqa: F401
