"""Scene-flow data of the port: the synthetic dataset, batch collation,
the serial epoch iterator and the copy to the device."""

from pvraft_tpu_torch.data.generic import Item, SceneFlowDataset, collate
from pvraft_tpu_torch.data.loader import batches, to_device
from pvraft_tpu_torch.data.synthetic import SyntheticDataset

__all__ = ["Item", "SceneFlowDataset", "SyntheticDataset", "batches",
           "collate", "to_device"]
