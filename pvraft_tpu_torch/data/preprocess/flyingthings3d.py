"""FlyingThings3D-subset raw data -> index-aligned pc1/pc2.npy scenes (port
of ``pvraft_tpu/data/preprocess/flyingthings3d.py``).

    python -m pvraft_tpu_torch.data.preprocess.flyingthings3d \\
        --raw_data_path RAW --save_path OUT [--only_save_near_pts]
        [--workers 4]

Back-project the left camera's disparity into a camera-frame cloud
(f = -1050 px, cx = 479.5, cy = 269.5, unit baseline), advect the pixels
by the into-future optical flow and disparity change for the t+1 cloud,
drop pixels occluded in the disparity or the flow, and optionally keep
only near points (z > -35 m). Point i of pc1 corresponds to point i of
pc2, which the FT3D reader relies on (flow = pc2 - pc1). The files equal
the JAX package's byte for byte. Host code only: numpy, no device.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Optional, Tuple

import numpy as np

from pvraft_tpu_torch.data.preprocess.io_formats import (
    read_flo,
    read_pfm,
    read_png16,
)

F_PX = -1050.0
CX = 479.5
CY = 269.5


def backproject(disparity: np.ndarray, flow: Optional[np.ndarray] = None,
                f: float = F_PX, cx: float = CX, cy: float = CY) -> np.ndarray:
    """Disparity (and pixel flow) -> (H, W, 3) camera-frame points. With a
    unit baseline: depth = -f / disp, x = -(u - cx [+ flow_u]) / disp,
    y = (v - cy [+ flow_v]) / disp."""
    h, w = disparity.shape
    u = np.broadcast_to(np.arange(w, dtype=np.float32)[None, :], (h, w))
    v = np.broadcast_to(np.arange(h, dtype=np.float32)[:, None], (h, w))
    du = flow[..., 0] if flow is not None else 0.0
    dv = flow[..., 1] if flow is not None else 0.0
    depth = -f / disparity
    x = -(u - cx + du) / disparity
    y = (v - cy + dv) / disparity
    return np.stack([x, y, depth], axis=-1).astype(np.float32)


def process_scene(raw_root: str, save_root: str, split: str, name: str,
                  save_near: bool = False) -> Tuple[int, int]:
    """Convert one frame; returns the saved (n_points, n_points)."""
    base = os.path.join(raw_root, split)
    disp1 = read_pfm(os.path.join(base, "disparity", "left", name + ".pfm"))
    disp_occ = read_png16(os.path.join(base, "disparity_occlusions", "left",
                                       name + ".png"))
    disp_change = read_pfm(os.path.join(base, "disparity_change", "left",
                                        "into_future", name + ".pfm"))
    flow = read_flo(os.path.join(base, "flow", "left", "into_future",
                                 name + ".flo"))
    flow_occ = read_png16(os.path.join(base, "flow_occlusions", "left",
                                       "into_future", name + ".png"))

    pc1 = backproject(disp1)
    pc2 = backproject(disp1 + disp_change, flow)

    valid = np.logical_and(disp_occ == 0, flow_occ == 0)
    pc1, pc2 = pc1[valid], pc2[valid]
    if save_near:
        near = np.logical_and(pc1[..., -1] > -35.0, pc2[..., -1] > -35.0)
        pc1, pc2 = pc1[near], pc2[near]

    out = os.path.join(save_root, split, name)
    os.makedirs(out, exist_ok=True)
    np.save(os.path.join(out, "pc1.npy"), pc1)
    np.save(os.path.join(out, "pc2.npy"), pc2)
    return pc1.shape[0], pc2.shape[0]


def process_flyingthings3d(raw_root: str, save_root: str,
                           save_near: bool = False, workers: int = 4,
                           splits=("train", "val")) -> int:
    """Every frame of ``splits``, ``workers`` processes; returns the
    count."""
    jobs = []
    for split in splits:
        listing = os.path.join(raw_root, split, "disparity_change", "left",
                               "into_future")
        for item in sorted(os.listdir(listing)):
            jobs.append((split, item.split(".")[0]))
    with ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futs = [pool.submit(process_scene, raw_root, save_root, s, n,
                            save_near) for s, n in jobs]
        for f in futs:
            f.result()
    return len(jobs)


def main(argv=None) -> None:
    p = argparse.ArgumentParser("preprocess FlyingThings3D subset")
    p.add_argument("--raw_data_path", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("--only_save_near_pts", action="store_true")
    p.add_argument("--workers", type=int, default=4)
    a = p.parse_args(argv)
    n = process_flyingthings3d(a.raw_data_path, a.save_path,
                               a.only_save_near_pts, a.workers)
    print(f"processed {n} scenes")


if __name__ == "__main__":
    main()
