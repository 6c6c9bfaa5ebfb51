"""The 95th percentile of every call's time in the window, from entering
``search_async`` until ``result()`` returns."""

import numpy as np


def read(record: dict):
    return float(np.percentile([(done - enter) * 1e-6 for enter, _d, done, _t
                                in record["calls"]], 95))
