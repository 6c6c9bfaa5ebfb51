"""scalablevectorsearch_tpu_torch: the PyTorch/CUDA port of
scalablevectorsearch_tpu.

Static Vamana build and batched search over f32/bf16/float16/int8/uint8,
scalar-quantized (SQ) and LVQ-compressed datasets; LeanVec
(``LeanVecDataset`` / ``LeanVecVamana``: search over projected LVQ codes
with a full-dimension rerank); paged retrieval (``BatchIterator``) and
search-parameter calibration (``calibrate``); the dynamic indexes
(``MutableVamanaIndex`` / ``DynamicVamana``: add, soft delete, consolidate,
compact; ``DynamicFlatIndex`` / ``DynamicFlat``; the multi-vector
``MultiMutableVamanaIndex``); flat exhaustive search for ground truth,
recall, and checkpoints in the JAX package's format (a
checkpoint either package saves loads in the other), in PyTorch on one
NVIDIA H100.  The
per-iteration beam step is a CUDA kernel written for Hopper
(``csrc/beam_step.cu``: beam_step, beam_step_lvq, and beam_update for
candidates scored beforehand by ``csrc/gather_distance.cu``).  The JAX package stays the reference this port is
tested against.  Tensors are created on ``device="cuda"`` unless a caller
passes another device; nothing moves to the CPU by itself.
"""

__version__ = "0.1.0"

from .core.data import VectorDataset
from .core.graph import NeighborGraph
from .core.loading import dispatch_load
from .core.io import (generate_test_dataset, read_npy, read_vecs, write_npy,
                      write_vecs)
from .core.query_result import QueryResult
from .core.recall import k_recall_at_n
from .core.translation import IDTranslator
from .index.dynamic_flat import DynamicFlatIndex
from .index.flat import FlatIndex, exhaustive_search
from .index.vamana.calibrate import CalibrationParameters, calibrate
from .index.vamana.dynamic import MutableVamanaIndex
from .index.vamana.index import VamanaIndex
from .index.vamana.iterator import (BatchIterator, DefaultSchedule,
                                    LinearSchedule)
from .index.vamana.multi import MultiMutableVamanaIndex
from .index.vamana.params import (SearchBufferConfig, VamanaBuildParameters,
                                  VamanaSearchParameters)
from .ops.distance import DistanceType, as_distance
from .orchestrators.dynamic_vamana import DynamicFlat, DynamicVamana
from .orchestrators.flat import Flat
from .orchestrators.vamana import Vamana
from .quantization.leanvec import LeanVecDataset, LeanVecVamana
from .quantization.lvq import LVQDataset
from .quantization.scalar import SQDataset
from .utils.dynamic_helper import ReferenceDataset

L2 = DistanceType.L2
MIP = DistanceType.MIP
Cosine = DistanceType.Cosine

__all__ = [
    "VectorDataset", "NeighborGraph", "QueryResult",
    "read_vecs", "write_vecs", "read_npy", "write_npy",
    "generate_test_dataset", "k_recall_at_n",
    "DistanceType", "as_distance", "L2", "MIP", "Cosine",
    "FlatIndex", "exhaustive_search", "Flat", "dispatch_load",
    "VamanaIndex", "VamanaBuildParameters", "VamanaSearchParameters",
    "SearchBufferConfig", "Vamana", "LVQDataset", "SQDataset",
    "MutableVamanaIndex", "MultiMutableVamanaIndex", "DynamicVamana",
    "DynamicFlat", "DynamicFlatIndex", "IDTranslator", "ReferenceDataset",
    "LeanVecDataset", "LeanVecVamana", "BatchIterator", "DefaultSchedule",
    "LinearSchedule", "CalibrationParameters", "calibrate",
]
