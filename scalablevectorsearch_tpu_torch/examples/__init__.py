"""The examples of the port, one module each, counterparts of the JAX
package's ``examples/example_<name>.py``:

- ``example_vamana``: build, recall sweep, calibration, save / assemble;
- ``example_compression``: f32, SQ-int8, LVQ-8 and LeanVec under Vamana;
- ``example_dynamic``: add, delete, consolidate, compact;
- ``example_ivf``: k-means, the probe sweep, LVQ postings with a rerank;
- ``example_serving``: packed serving, blocking against pipelined QPS,
  batch latency;
- ``example_multichip``: the multi-device package over a mesh.

Each runs on the card as

    python -m scalablevectorsearch_tpu_torch.examples.example_<name>

and has ``run(device="cuda", <sizes>) -> dict``, which returns every
number its ``main()`` prints; the sizes default to the JAX example's.
``run(device="cpu")`` runs it on the CPU; there is no fallback to the CPU.
"""

from __future__ import annotations

import subprocess

import torch


def on_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises where it is not present
    (``"cuda"`` without a card), so an example never runs elsewhere."""
    device = torch.device(device)
    torch.empty(0, device=device)
    return device


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
