"""Scene data of the port: the single-scene SAPIEN loader (``sapien``) and the
multi-instance articulated one (``sapien_multi``) with their scene AABB
(``aabb``) and occupancy-grid intervals (``occgrid``), and small in-memory
scenes (``analytic``) for smoke runs and tests."""

from aon_tpu_torch.data.sapien import SapienDataset
from aon_tpu_torch.data.sapien_multi import SapienDatasetMulti

dataset_dict = {
    "sapien": SapienDataset,
    "sapien_multi": SapienDatasetMulti,
}

__all__ = ["SapienDataset", "SapienDatasetMulti", "dataset_dict"]
