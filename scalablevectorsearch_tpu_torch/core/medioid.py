"""Entry-point computation for graph indexes.

PyTorch counterpart of ``scalablevectorsearch_tpu/core/medioid.py``: the
component-wise mean of the dataset, then the id of the row nearest to it,
both as tiled loops over the dataset protocol (``get_f32`` for the sum,
``tile_keys`` for the arg-min), so compressed datasets decode tile by tile;
sums accumulate tile by tile in f32, as in the JAX package.
"""

from __future__ import annotations

import torch


def compute_medioid(dataset, tile: int = 16384) -> int:
    """Return the internal id of the dataset medioid (argmin L2 to the mean)."""
    tile = min(tile, dataset.capacity)
    while dataset.capacity % tile != 0:
        tile //= 2
    num_tiles = dataset.capacity // tile
    device = dataset.device
    total = torch.zeros(dataset.padded_dim, dtype=torch.float32,
                        device=device)
    for t in range(num_tiles):
        ids = t * tile + torch.arange(tile, device=device)
        rows = dataset.get_f32(ids)
        total += torch.where((ids < dataset.n)[:, None], rows, 0.0).sum(0)
    mean = (total / dataset.n)[None, :]
    mean_norm = mean.square().sum(-1)

    best_key, best_id = float("inf"), 0
    for t in range(num_tiles):
        keys = dataset.tile_keys(mean, mean_norm, t * tile, tile, "L2")[0]
        ids = t * tile + torch.arange(tile, device=device)
        keys = torch.where(ids < dataset.n, keys, float("inf"))
        pos = int(torch.argmin(keys))
        if float(keys[pos]) < best_key:
            best_key, best_id = float(keys[pos]), t * tile + pos
    return best_id
