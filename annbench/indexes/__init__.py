"""One module per index kind, named by a configuration's ``index.kind``.

Each has ``build(config, rows, device) -> (index, facts)``, which builds
the index through the port's public entry points and returns it with what
the metrics may read of it, and ``configure(index, search)``, which sets
the search parameters of the configuration's ``index.search``.  The index
answers ``search_async(queries, k).result()``.
"""

import torch


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
