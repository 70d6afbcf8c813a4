"""Scene data of the port: the single-scene SAPIEN loader (``sapien``) with
its scene AABB (``aabb``) and occupancy-grid intervals (``occgrid``), and
small in-memory scenes (``analytic``) for smoke runs and tests.  The
articulated loader waits for ROADMAP.md slice 6b."""

from aon_tpu_torch.data.sapien import SapienDataset


class SapienDatasetMulti:
    """``dataset_name="sapien_multi"``: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "dataset_name='sapien_multi' is not ported yet (ROADMAP.md slice 6b: "
            "data/sapien_multi.py, models/joint_state.py and the multi-instance test)"
        )


dataset_dict = {
    "sapien": SapienDataset,
    "sapien_multi": SapienDatasetMulti,
}

__all__ = ["SapienDataset", "SapienDatasetMulti", "dataset_dict"]
