"""FlyingThings3D (HPLFlowNet preprocessing) dataset (port of
``pvraft_tpu/data/flyingthings3d.py``).

Scenes are directories of ``pc1.npy``/``pc2.npy`` written by the offline
preprocessing (``pvraft_tpu_torch.data.preprocess``):

  * train and val both list ``train/0*`` (19,640 scenes); val is 2,000
    indices from ``np.linspace`` over the sorted list, train the rest;
    test is ``val/0*`` (3,824). A tree with fewer train scenes takes
    ``min(2000, max(1, total // 10))`` of them for val;
  * the x and z axes are sign-flipped on load;
  * points are index-aligned across frames: mask all ones, flow =
    pc2 - pc1.

``strict_sizes=False`` relaxes the dataset-size checks so that a subset
(a small local copy) can be used. The file lists, the split and the items
equal the JAX package's for the same tree and seed.
"""

from __future__ import annotations

import glob
import os
from typing import Optional

import numpy as np

from pvraft_tpu_torch.data.generic import SceneFlowDataset

FT3D_TRAIN_SIZE = 19640
FT3D_TEST_SIZE = 3824
FT3D_VAL_COUNT = 2000


class FT3D(SceneFlowDataset):
    def __init__(self, root_dir: str, nb_points: int, mode: str,
                 strict_sizes: bool = True, seed: Optional[int] = None):
        super().__init__(nb_points=nb_points, seed=seed)
        if mode not in ("train", "val", "test"):
            raise ValueError(f"unknown mode {mode!r}")
        self.mode = mode
        self.root_dir = root_dir
        self.filenames = self._file_list(strict_sizes)

    def _file_list(self, strict: bool):
        pattern = "train/0*" if self.mode in ("train", "val") else "val/0*"
        names = sorted(glob.glob(os.path.join(self.root_dir, pattern)))
        if self.mode in ("train", "val"):
            if strict and len(names) != FT3D_TRAIN_SIZE:
                raise RuntimeError(f"expected {FT3D_TRAIN_SIZE} train "
                                   f"scenes, found {len(names)}")
            total = len(names)
            n_val = (min(FT3D_VAL_COUNT, max(1, total // 10))
                     if total < FT3D_TRAIN_SIZE else FT3D_VAL_COUNT)
            val_idx = set(np.linspace(0, total - 1, n_val).astype(int).tolist())
            if self.mode == "val":
                keep = sorted(val_idx)
            else:
                keep = [i for i in range(total) if i not in val_idx]
            names = [names[i] for i in keep]
        elif strict and len(names) != FT3D_TEST_SIZE:
            raise RuntimeError(f"expected {FT3D_TEST_SIZE} test scenes, "
                               f"found {len(names)}")
        return names

    def __len__(self) -> int:
        return len(self.filenames)

    def native_paths(self, idx: int):
        """(pc1_path, pc2_path, flip_xz, filter_mode) for the native batch
        assembler (filter_mode 0: no row filter)."""
        scene = self.filenames[idx]
        return (os.path.join(scene, "pc1.npy"),
                os.path.join(scene, "pc2.npy"), True, 0)

    def load_sequence(self, idx: int):
        scene = self.filenames[idx]
        clouds = []
        for name in ("pc1.npy", "pc2.npy"):
            pc = np.load(os.path.join(scene, name)).astype(np.float32)
            pc[..., 0] *= -1.0
            pc[..., -1] *= -1.0
            clouds.append(pc)
        pc1, pc2 = clouds
        mask = np.ones((pc1.shape[0],), np.float32)
        return pc1, pc2, mask, pc2 - pc1
