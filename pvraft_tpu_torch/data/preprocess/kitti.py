"""KITTI scene-flow 2015 raw data -> index-aligned pc1/pc2.npy scenes (port
of ``pvraft_tpu/data/preprocess/kitti.py``).

    python -m pvraft_tpu_torch.data.preprocess.kitti \\
        --raw_data_path RAW --calib_path CALIB --save_path OUT [--workers 4]

``RAW`` holds ``disp_occ_0``, ``disp_occ_1`` and ``flow_occ``; ``CALIB``
one ``<idx>.txt`` per frame with its ``P_rect_02`` line. Read the left
colour camera's projection, turn both disparities into depths (baseline
0.54 m), back-project pc1 at the pixel grid and pc2 at the flow-advected
grid, and keep the pixels valid in both disparities and in the flow. The
files equal the JAX package's byte for byte. Host code only.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from pvraft_tpu_torch.data.preprocess.io_formats import (
    read_kitti_disparity,
    read_kitti_flow,
)

BASELINE_M = 0.54


def read_calib(path: str) -> np.ndarray:
    """P_rect_02 (3, 4) from a KITTI calib_cam_to_cam-style file."""
    with open(path) as fd:
        lines = [ln for ln in fd.readlines() if ln.startswith("P_rect_02")]
    if len(lines) != 1:
        raise ValueError(f"{path}: expected exactly one P_rect_02 line")
    vals = np.array([float(x) for x in lines[0].split()[1:]], np.float32)
    p = vals.reshape(3, 4)
    if p[0, 0] != p[1, 1] or p[0, 1] != 0 or p[1, 0] != 0:
        raise ValueError(f"{path}: unexpected projection structure")
    return p


def disparity_to_depth(disp: np.ndarray, valid: np.ndarray,
                       focal_px: float) -> np.ndarray:
    depth = focal_px * BASELINE_M / (disp + 1e-5)
    depth[~valid] = -1.0
    return depth


def backproject_kitti(depth: np.ndarray, p_rect: np.ndarray, px=None,
                      py=None) -> np.ndarray:
    """Pinhole back-projection with the full P_rect (cx, cy and tx terms
    included), x and y sign-flipped into the dataset's frame."""
    f = p_rect[0, 0]
    h, w = depth.shape
    if px is None:
        px = np.broadcast_to(np.arange(w, dtype=np.float32)[None, :], (h, w))
    if py is None:
        py = np.broadcast_to(np.arange(h, dtype=np.float32)[:, None], (h, w))
    const_x = p_rect[0, 2] * depth + p_rect[0, 3]
    const_y = p_rect[1, 2] * depth + p_rect[1, 3]
    x = (px * (depth + p_rect[2, 3]) - const_x) / f
    y = (py * (depth + p_rect[2, 3]) - const_y) / f
    pc = np.stack([x, y, depth], axis=-1).astype(np.float32)
    pc[..., :2] *= -1.0
    return pc


def process_frame(disp0_root: str, disp1_root: str, flow_root: str,
                  calib_root: str, save_root: str, idx: int) -> int:
    """Convert frame ``idx``; returns the saved point count."""
    sidx = f"{idx:06d}"
    p_rect = read_calib(os.path.join(calib_root, sidx + ".txt"))
    focal = float(p_rect[0, 0])

    disp1, valid1 = read_kitti_disparity(os.path.join(disp0_root,
                                                      sidx + "_10.png"))
    disp2, valid2 = read_kitti_disparity(os.path.join(disp1_root,
                                                      sidx + "_10.png"))
    depth1 = disparity_to_depth(disp1, valid1, focal)
    depth2 = disparity_to_depth(disp2, valid2, focal)

    flow, valid_flow = read_kitti_flow(os.path.join(flow_root,
                                                    sidx + "_10.png"))
    ok = np.logical_and(np.logical_and(valid1, valid2), valid_flow)

    h, w = depth1.shape
    u = np.broadcast_to(np.arange(w, dtype=np.float32)[None, :], (h, w))
    v = np.broadcast_to(np.arange(h, dtype=np.float32)[:, None], (h, w))
    px2 = np.where(ok, u + flow[..., 0], 0.0).astype(np.float32)
    py2 = np.where(ok, v + flow[..., 1], 0.0).astype(np.float32)

    pc1 = backproject_kitti(depth1, p_rect)
    pc2 = backproject_kitti(depth2, p_rect, px=px2, py=py2)

    out = os.path.join(save_root, sidx)
    os.makedirs(out, exist_ok=True)
    np.save(os.path.join(out, "pc1.npy"), pc1[ok])
    np.save(os.path.join(out, "pc2.npy"), pc2[ok])
    return int(ok.sum())


def process_kitti(raw_root: str, calib_root: str, save_root: str,
                  workers: int = 4, n_frames: int = 200) -> int:
    """Frames 0 .. n_frames - 1, ``workers`` processes; returns
    ``n_frames``."""
    disp0 = os.path.join(raw_root, "disp_occ_0")
    disp1 = os.path.join(raw_root, "disp_occ_1")
    flow = os.path.join(raw_root, "flow_occ")
    with ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futs = [pool.submit(process_frame, disp0, disp1, flow, calib_root,
                            save_root, i) for i in range(n_frames)]
        for f in futs:
            f.result()
    return n_frames


def main(argv=None) -> None:
    p = argparse.ArgumentParser("preprocess KITTI scene flow 2015")
    p.add_argument("--raw_data_path", required=True,
                   help="directory holding disp_occ_0, disp_occ_1, flow_occ")
    p.add_argument("--calib_path", required=True)
    p.add_argument("--save_path", required=True)
    p.add_argument("--workers", type=int, default=4)
    a = p.parse_args(argv)
    n = process_kitti(a.raw_data_path, a.calib_path, a.save_path, a.workers)
    print(f"processed {n} frames")


if __name__ == "__main__":
    main()
