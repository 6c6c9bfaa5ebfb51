"""The device memory allocated at its peak during the window
(``torch.cuda.max_memory_allocated`` after a reset at the window's
start), in GB: the program's serving footprint."""


def read(record: dict):
    peak = record.get("window_peak_bytes")
    return None if peak is None else peak / 1e9
