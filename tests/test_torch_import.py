"""The PyTorch port imports no JAX.

Runs in a subprocess: this test session has imported jax already
(``tests/conftest.py``).
"""

import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the package itself, and the modules its __init__ does not import
PORT_MODULES = [
    "scalablevectorsearch_tpu_torch",
    "scalablevectorsearch_tpu_torch.interop, "
    "scalablevectorsearch_tpu_torch.index.vamana.entry, "
    "scalablevectorsearch_tpu_torch.index.vamana.packed, "
    "scalablevectorsearch_tpu_torch.lib.transfer",
    "scalablevectorsearch_tpu_torch.core.translation, "
    "scalablevectorsearch_tpu_torch.index.dynamic_flat, "
    "scalablevectorsearch_tpu_torch.index.vamana.dynamic, "
    "scalablevectorsearch_tpu_torch.index.vamana.multi, "
    "scalablevectorsearch_tpu_torch.orchestrators.dynamic_vamana, "
    "scalablevectorsearch_tpu_torch.utils.dynamic_helper",
    "scalablevectorsearch_tpu_torch.quantization.leanvec, "
    "scalablevectorsearch_tpu_torch.index.vamana.iterator, "
    "scalablevectorsearch_tpu_torch.index.vamana.calibrate",
    "scalablevectorsearch_tpu_torch.core.kmeans, "
    "scalablevectorsearch_tpu_torch.index.ivf.params, "
    "scalablevectorsearch_tpu_torch.index.ivf.kmeans, "
    "scalablevectorsearch_tpu_torch.index.ivf.clustering, "
    "scalablevectorsearch_tpu_torch.index.ivf.index, "
    "scalablevectorsearch_tpu_torch.index.ivf.dynamic, "
    "scalablevectorsearch_tpu_torch.index.ivf.iterator, "
    "scalablevectorsearch_tpu_torch.orchestrators.ivf, "
    "scalablevectorsearch_tpu_torch.index.inverted.index, "
    "scalablevectorsearch_tpu_torch.orchestrators.inverted",
]


@pytest.mark.parametrize("module", PORT_MODULES)
def test_port_imports_no_jax(module):
    code = (f"import {module}, sys; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'scalablevectorsearch_tpu.'))]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_default_device_is_cuda_without_fallback():
    """Constructors default to the GPU; with no card they raise instead of
    moving to the CPU."""
    from scalablevectorsearch_tpu_torch import VectorDataset
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        VectorDataset.from_array([[1.0, 2.0]])
