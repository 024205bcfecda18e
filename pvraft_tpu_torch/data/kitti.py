"""KITTI scene-flow 2015 dataset, HPLFlowNet preprocessing (port of
``pvraft_tpu/data/kitti.py``).

200 preprocessed scene directories (the leaf directories under the root,
found with ``os.walk`` after ``realpath``), filtered to the 142 with a
non-empty line in the KITTI raw mapping; ground points (y < -1.4 in both
frames) and far points (z >= 35 m in either frame) are removed; mask all
ones, flow = pc2 - pc1.

Eval-only, as in the JAX package: the Trainer raises for KITTI, which is
evaluated zero-shot through the Evaluator and ``python -m
pvraft_tpu_torch.test``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from pvraft_tpu_torch.data.generic import SceneFlowDataset

KITTI_SCENES = 200

# Scene indices (of the 200 preprocessed directories) with a non-empty
# line in the KITTI raw-data mapping: the 142-scene evaluation subset.
# Only membership matters, so the index set stands in for the mapping
# text; ``mapping_path`` still takes a mapping file.
KITTI_EVAL_INDICES = frozenset(
    [2, 3]
    + list(range(7, 82))
    + [83, 84, 85, 86]
    + list(range(88, 99))
    + list(range(105, 133))
    + list(range(141, 151))
    + [155]
    + list(range(157, 165))
    + [168, 169, 199]
)


class KITTI(SceneFlowDataset):
    def __init__(self, root_dir: str, nb_points: int,
                 strict_sizes: bool = True,
                 mapping_path: Optional[str] = None,
                 seed: Optional[int] = None):
        super().__init__(nb_points=nb_points, seed=seed)
        self.root_dir = root_dir
        self.paths = self._scene_list(strict_sizes, mapping_path)

    def _scene_list(self, strict: bool, mapping_path: Optional[str]):
        root = os.path.realpath(os.path.expanduser(self.root_dir))
        leaves = sorted(d for d, subdirs, _ in os.walk(root) if not subdirs)
        if strict and len(leaves) != KITTI_SCENES:
            raise RuntimeError(f"expected {KITTI_SCENES} KITTI scenes, "
                               f"found {len(leaves)}")
        if mapping_path is not None:
            with open(mapping_path) as fd:
                lines = [ln.strip() for ln in fd.readlines()]
            keep = {i for i, ln in enumerate(lines) if ln != ""}
        else:
            keep = KITTI_EVAL_INDICES
        return [p for p in leaves if int(os.path.basename(p)) in keep]

    def __len__(self) -> int:
        return len(self.paths)

    def native_paths(self, idx: int):
        """(pc1_path, pc2_path, flip_xz, filter_mode) for the native batch
        assembler; filter_mode 1 applies :meth:`load_sequence`'s ground
        and far filter in the C++ assembler."""
        scene = self.paths[idx]
        return (os.path.join(scene, "pc1.npy"),
                os.path.join(scene, "pc2.npy"), False, 1)

    def load_sequence(self, idx: int):
        scene = self.paths[idx]
        pc1 = np.load(os.path.join(scene, "pc1.npy")).astype(np.float32)
        pc2 = np.load(os.path.join(scene, "pc2.npy")).astype(np.float32)
        not_ground = ~np.logical_and(pc1[:, 1] < -1.4, pc2[:, 1] < -1.4)
        pc1, pc2 = pc1[not_ground], pc2[not_ground]
        near = np.logical_and(pc1[:, 2] < 35.0, pc2[:, 2] < 35.0)
        pc1, pc2 = pc1[near], pc2[near]
        mask = np.ones((pc1.shape[0],), np.float32)
        return pc1, pc2, mask, pc2 - pc1
