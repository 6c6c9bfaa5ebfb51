"""The library build of the vamana index: host clock around the call,
ending in a device synchronise."""

from annbench.readers import build_s


def read(record: dict):
    return build_s(record, "vamana")
