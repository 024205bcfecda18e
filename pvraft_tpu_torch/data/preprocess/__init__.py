"""Offline preprocessing: raw FlyingThings3D and KITTI -> pc1/pc2.npy
scenes (port of ``pvraft_tpu/data/preprocess``). Run once on the host;
numpy only, no device."""

from pvraft_tpu_torch.data.preprocess.flyingthings3d import (
    process_flyingthings3d,
)
from pvraft_tpu_torch.data.preprocess.io_formats import (
    read_flo,
    read_pfm,
    read_png16,
)
from pvraft_tpu_torch.data.preprocess.kitti import process_kitti

__all__ = ["read_flo", "read_pfm", "read_png16", "process_flyingthings3d",
           "process_kitti"]
