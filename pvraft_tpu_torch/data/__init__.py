"""Scene-flow data of the port: the synthetic, FT3D and KITTI datasets,
batch collation, the serial, threaded and native loaders, and the copy to
the device."""

from pvraft_tpu_torch.data.flyingthings3d import FT3D
from pvraft_tpu_torch.data.generic import Item, SceneFlowDataset, collate
from pvraft_tpu_torch.data.kitti import KITTI
from pvraft_tpu_torch.data.loader import (
    PrefetchLoader,
    device_prefetch,
    first_batch,
    to_device,
)
from pvraft_tpu_torch.data.synthetic import SyntheticDataset

__all__ = ["FT3D", "KITTI", "Item", "PrefetchLoader", "SceneFlowDataset",
           "SyntheticDataset", "collate", "device_prefetch",
           "first_batch", "to_device"]
