"""Dataset base and batch collation (port of ``pvraft_tpu/data/generic.py``).

  * exact-N sampling: a seeded permutation subsample to ``nb_points``,
    and reject-and-advance (walk to the next index) when a sample has
    fewer points;
  * items are dicts of float32 numpy arrays: ``pc1 (N,3)``, ``pc2 (N,3)``,
    ``mask (N,)``, ``flow (N,3)``;
  * :func:`collate` stacks items along a new leading batch axis.

The subsample permutations come from the ``data.subsample`` stream of
:mod:`pvraft_tpu_torch.rng`, so items are bitwise-identical to the JAX
package's.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from pvraft_tpu_torch.rng import host_rng

Item = Dict[str, np.ndarray]


class SceneFlowDataset:
    """Base class: subclasses implement ``load_sequence(idx)`` returning
    ``(pc1, pc2, mask, flow)`` with variable point counts."""

    def __init__(self, nb_points: int, seed: Optional[int] = None):
        self.nb_points = int(nb_points)
        self._seed = 0 if seed is None else int(seed)
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Subsampling is seeded per (seed, epoch, idx): items are
        deterministic and resampled every epoch."""
        self._epoch = int(epoch)

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def load_sequence(self, idx: int):  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, idx: int) -> Item:
        for probe in range(len(self)):
            j = (idx + probe) % len(self)
            pc1, pc2, mask, flow = self.load_sequence(j)
            if pc1.shape[0] >= self.nb_points and pc2.shape[0] >= self.nb_points:
                break
        else:
            raise RuntimeError("no sample with enough points")

        n = self.nb_points
        rng = host_rng(self._seed, "data.subsample", self._epoch, j)
        perm1 = rng.permutation(pc1.shape[0])[:n]
        perm2 = rng.permutation(pc2.shape[0])[:n]
        return {
            "pc1": pc1[perm1].astype(np.float32),
            "pc2": pc2[perm2].astype(np.float32),
            "mask": mask[perm1].astype(np.float32),
            "flow": flow[perm1].astype(np.float32),
        }


def collate(items: Sequence[Item]) -> Item:
    """Stack items into (B, ...) arrays."""
    return {k: np.stack([it[k] for it in items], axis=0) for k in items[0]}
