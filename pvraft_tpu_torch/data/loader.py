"""The serial epoch iterator and the copy to the device (port of the
serial path of ``pvraft_tpu/data/loader.py``).

:func:`batches` yields the same batches in the same order as the JAX
package's ``batches``/``PrefetchLoader(num_workers=0)``: the epoch order
is a ``data.shuffle``-stream permutation of the dataset when
``shuffle``, the dataset's epoch is set first. :func:`to_device` turns a
numpy batch into tensors on the device, through pinned host memory and a
non-blocking copy when the device is a GPU. The threaded and native
loaders arrive with the data slice.
"""

from __future__ import annotations

from typing import Dict, Iterator, Union

import numpy as np
import torch

from pvraft_tpu_torch.data.generic import Item, SceneFlowDataset, collate
from pvraft_tpu_torch.rng import host_rng


def batches(dataset: SceneFlowDataset, batch_size: int, shuffle: bool = False,
            drop_last: bool = True, seed: int = 0,
            epoch: int = 0) -> Iterator[Item]:
    """Lazy serial epoch iterator; one collated batch at a time."""
    dataset.set_epoch(epoch)
    order = np.arange(len(dataset))
    if shuffle:
        host_rng(seed, "data.shuffle", epoch).shuffle(order)
    for s in range(0, len(order), batch_size):
        idx = order[s:s + batch_size]
        if drop_last and len(idx) < batch_size:
            return
        yield collate([dataset[int(i)] for i in idx])


def to_device(batch: Item, device: Union[str, torch.device]
              ) -> Dict[str, torch.Tensor]:
    """Numpy batch -> tensors on ``device``. To a GPU the copy goes from
    pinned host memory with ``non_blocking=True``, so it overlaps work
    already queued on the card."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.to(device)
    return out
