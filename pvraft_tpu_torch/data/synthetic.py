"""Synthetic scene-flow dataset (port of ``pvraft_tpu/data/synthetic.py``).

Random clouds moved by random rigid transforms plus noise, with
index-aligned ground truth (flow = pc2 - pc1, mask all ones). Scenes come
from the ``data.synthetic`` stream of :mod:`pvraft_tpu_torch.rng` and are
bitwise-identical to the JAX package's for the same arguments.
"""

from __future__ import annotations

import numpy as np

from pvraft_tpu_torch.data.generic import SceneFlowDataset
from pvraft_tpu_torch.rng import host_rng


def _random_rotation(rng: np.random.Generator, max_angle: float) -> np.ndarray:
    angles = rng.uniform(-max_angle, max_angle, size=3)
    cx, cy, cz = np.cos(angles)
    sx, sy, sz = np.sin(angles)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (rx @ ry @ rz).astype(np.float32)


class SyntheticDataset(SceneFlowDataset):
    """``n_objects=1``: one global rigid transform. ``n_objects>1``:
    FT3D-like scenes, points clustered into blobs around random centres,
    each blob moved by its own rigid transform about its centre, so the
    flow field is only piecewise rigid."""

    def __init__(self, size: int = 64, nb_points: int = 2048,
                 extra_points: int = 0, max_angle: float = 0.1,
                 max_shift: float = 0.3, noise: float = 0.0, seed: int = 0,
                 n_objects: int = 1):
        super().__init__(nb_points=nb_points, seed=seed)
        self.size = size
        self.extra_points = extra_points
        self.max_angle = max_angle
        self.max_shift = max_shift
        self.noise = noise
        self.seed = seed
        if n_objects < 1:
            raise ValueError(f"n_objects must be >= 1, got {n_objects}")
        self.n_objects = n_objects

    def __len__(self) -> int:
        return self.size

    def load_sequence(self, idx: int):
        rng = host_rng(self.seed, "data.synthetic", idx)
        n = self.nb_points + (rng.integers(0, self.extra_points + 1)
                              if self.extra_points else 0)
        if self.n_objects == 1:
            pc1 = rng.uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)
            rot = _random_rotation(rng, self.max_angle)
            shift = rng.uniform(-self.max_shift, self.max_shift, size=3)
            pc2 = pc1 @ rot.T + shift.astype(np.float32)
        else:
            counts = np.full(self.n_objects, n // self.n_objects)
            counts[: n % self.n_objects] += 1
            parts1, parts2 = [], []
            for c in counts:
                center = rng.uniform(-0.8, 0.8, size=3).astype(np.float32)
                blob = (center + rng.normal(0, 0.2, size=(c, 3))).astype(
                    np.float32)
                rot = _random_rotation(rng, self.max_angle)
                shift = rng.uniform(-self.max_shift, self.max_shift, size=3)
                moved = (blob - center) @ rot.T + center + shift
                parts1.append(blob)
                parts2.append(moved.astype(np.float32))
            order = rng.permutation(n)  # no block structure in the index
            pc1 = np.concatenate(parts1)[order]
            pc2 = np.concatenate(parts2)[order]
        if self.noise:
            pc2 = pc2 + rng.normal(0, self.noise, size=pc2.shape).astype(
                np.float32)
        flow = (pc2 - pc1).astype(np.float32)
        mask = np.ones((n,), np.float32)
        return pc1.astype(np.float32), pc2.astype(np.float32), mask, flow
