"""Everything before the window: the process's start, the data, the
build, serving preparation and the warm-up calls."""


def read(record: dict):
    return record["setup_s"]
