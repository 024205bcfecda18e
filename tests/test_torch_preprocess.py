"""The port's offline preprocessors against the JAX package's, on the CPU.

The port's PNG decoder (``zlib`` and ``struct``) reads 8- and 16-bit gray
and RGB PNGs that this file writes with each of the five row filters back
to their arrays exactly, and refuses interlaced and other images. The
PFM, ``.flo`` and KITTI readers, the FT3D back-projection
(``process_scene``, the CLI) and the KITTI calibration, depth,
back-projection and ``process_frame`` give the JAX package's values and
``.npy`` bytes on the same raw files (the JAX package reads PNG with
OpenCV).
"""

import os
import struct
import zlib

import numpy as np
import pytest

from pvraft_tpu.data.preprocess import flyingthings3d as jft3d
from pvraft_tpu.data.preprocess import io_formats as jio
from pvraft_tpu.data.preprocess import kitti as jkitti
from pvraft_tpu_torch.data.preprocess import flyingthings3d as tft3d
from pvraft_tpu_torch.data.preprocess import io_formats as tio
from pvraft_tpu_torch.data.preprocess import kitti as tkitti


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img, filters, colour=None, interlace=0, depth=None):
    """A PNG of ``img`` (uint8 or uint16, (H, W) or (H, W, 3)), row y
    filtered with ``filters[y % len(filters)]``."""
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    depth = depth or 8 * img.dtype.itemsize
    colour = {1: 0, 3: 2}[channels] if colour is None else colour
    bpp = channels * img.dtype.itemsize
    rows = img.astype(img.dtype.newbyteorder(">")).reshape(h, -1)
    rows = rows.view(np.uint8).reshape(h, w * bpp).astype(np.int64)
    raw = bytearray()
    prior = np.zeros(w * bpp, np.int64)
    for y in range(h):
        kind = filters[y % len(filters)]
        x = rows[y]
        out = []
        for i in range(len(x)):
            a = x[i - bpp] if i >= bpp else 0
            c = prior[i - bpp] if i >= bpp else 0
            pred = [0, a, prior[i], (a + prior[i]) // 2,
                    _paeth(a, prior[i], c)][kind]
            out.append((x[i] - pred) % 256)
        raw += bytes([kind] + out)
        prior = x
    header = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    return (tio.PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(bytes(raw)))
            + _chunk(b"IEND", b""))


def _image(depth, channels, seed=0, h=5, w=7):
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if depth == 8 else np.uint16
    shape = (h, w) if channels == 1 else (h, w, channels)
    return rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [4, 0, 3, 1, 2]],
                         ids=["none", "sub", "up", "average", "paeth",
                              "mixed"])
@pytest.mark.parametrize("channels", [1, 3], ids=["gray", "rgb"])
@pytest.mark.parametrize("depth", [8, 16])
def test_png_decoder_reads_every_filter(tmp_path, depth, channels, filters):
    img = _image(depth, channels, seed=depth + channels)
    path = tmp_path / "x.png"
    path.write_bytes(encode_png(img, filters))
    got = tio.read_png16(str(path))
    assert got.dtype == img.dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("depth,channels", [(8, 1), (16, 1), (8, 3), (16, 3)])
def test_png_decoder_matches_jax_on_opencv_files(tmp_path, depth, channels):
    """Files OpenCV writes (its own filter choice): the port's decoder
    returns the JAX reader's array, RGB in RGB order."""
    cv2 = pytest.importorskip("cv2")
    img = _image(depth, channels, seed=7, h=9, w=13)
    path = str(tmp_path / "cv.png")
    cv2.imwrite(path, img[..., ::-1] if channels == 3 else img)
    want = jio.read_png16(path)
    got = tio.read_png16(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)


def test_png_decoder_refuses_what_it_does_not_read(tmp_path):
    img = _image(8, 1)
    cases = {
        "interlaced": encode_png(img, [0], interlace=1),
        "colour type 3": encode_png(img, [0], colour=3),
        "colour type 6": encode_png(img, [0], colour=6),
        "bad CRC": encode_png(img, [0])[:-1] + b"\0",
        "not a PNG": b"GIF89a" + bytes(20),
    }
    for name, data in cases.items():
        path = tmp_path / "bad.png"
        path.write_bytes(data)
        with pytest.raises(ValueError) as err:
            tio.read_png16(str(path))
        assert str(path) in str(err.value), name
    bad_filter = bytearray(zlib.compress(bytes([7] + [0] * 7) * 5))
    path.write_bytes(tio.PNG_SIGNATURE + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", 7, 5, 8, 0, 0, 0, 0))
        + _chunk(b"IDAT", bytes(bad_filter)) + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="unknown filter type 7"):
        tio.read_png16(str(path))


def _write_pfm(path, img, scale=-1.0):
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if img.ndim == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(f"{scale}\n".encode())
        endian = "<" if scale < 0 else ">"
        f.write(np.flipud(img).astype(endian + "f4").tobytes())


def _write_flo(path, flow):
    h, w, _ = flow.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<f", 202021.25))
        f.write(struct.pack("<i", w))
        f.write(struct.pack("<i", h))
        f.write(flow.astype("<f4").tobytes())


@pytest.mark.parametrize("shape,scale", [((6, 9), -1.0), ((4, 5, 3), 1.0)])
def test_pfm_and_flo_match_jax(tmp_path, shape, scale):
    rng = np.random.default_rng(1)
    img = rng.normal(size=shape).astype(np.float32)
    p = str(tmp_path / "x.pfm")
    _write_pfm(p, img, scale)
    got = tio.read_pfm(p)
    np.testing.assert_array_equal(got, jio.read_pfm(p))
    np.testing.assert_array_equal(got, img)
    flow = rng.normal(size=(5, 7, 2)).astype(np.float32)
    f = str(tmp_path / "x.flo")
    _write_flo(f, flow)
    np.testing.assert_array_equal(tio.read_flo(f), jio.read_flo(f))
    with open(f, "r+b") as fh:
        fh.write(struct.pack("<f", 1.0))
    with pytest.raises(ValueError, match="bad .flo magic"):
        tio.read_flo(f)


def test_kitti_png_readers_match_jax(tmp_path):
    disp = np.zeros((4, 6), np.uint16)
    disp[1, 2] = 256 * 10
    disp[3, 4] = 777
    flow = np.zeros((4, 6, 3), np.uint16)
    flow[2, 3] = (2**15 + 64 * 3, 2**15 - 64 * 2, 1)
    flow[0, 5] = (2**15 + 5, 2**15 - 9, 1)
    d, f = str(tmp_path / "d.png"), str(tmp_path / "f.png")
    with open(d, "wb") as fh:
        fh.write(encode_png(disp, [1, 4]))
    with open(f, "wb") as fh:
        fh.write(encode_png(flow, [3, 2]))
    for got, want in ((tio.read_kitti_disparity(d),
                       jio.read_kitti_disparity(d)),
                      (tio.read_kitti_flow(f), jio.read_kitti_flow(f))):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    disp_out, valid = tio.read_kitti_disparity(d)
    assert disp_out[1, 2] == 10.0 and valid[1, 2] and disp_out[0, 0] == -1.0


FT3D_DIRS = ("disparity/left", "disparity_occlusions/left",
             "disparity_change/left/into_future", "flow/left/into_future",
             "flow_occlusions/left/into_future")


def make_raw_ft3d(raw, names=("0000000", "0000001"), split="train", h=12,
                  w=16):
    """A raw FT3D tree: PFM disparity and change, .flo flow, 8-bit PNG
    occlusions (row 0 occluded in the disparity, one pixel in the flow)."""
    rng = np.random.default_rng(3)
    base = raw / split
    for sub in FT3D_DIRS:
        (base / sub).mkdir(parents=True, exist_ok=True)
    for name in names:
        disp = rng.uniform(0.5, 20, (h, w)).astype(np.float32)
        _write_pfm(str(base / "disparity/left" / f"{name}.pfm"), disp)
        _write_pfm(str(base / "disparity_change/left/into_future"
                       / f"{name}.pfm"),
                   rng.uniform(-1, 1, (h, w)).astype(np.float32))
        _write_flo(str(base / "flow/left/into_future" / f"{name}.flo"),
                   rng.uniform(-2, 2, (h, w, 2)).astype(np.float32))
        occ = np.zeros((h, w), np.uint8)
        occ[0, :] = 255
        (base / "disparity_occlusions/left" / f"{name}.png").write_bytes(
            encode_png(occ, [0, 1, 2, 3, 4]))
        focc = np.zeros((h, w), np.uint8)
        focc[5, 7] = 255
        (base / "flow_occlusions/left/into_future" / f"{name}.png"
         ).write_bytes(encode_png(focc, [4]))
    return raw


def _same_scene_files(got_root, want_root, rel):
    for name in ("pc1.npy", "pc2.npy"):
        got = (got_root / rel / name).read_bytes()
        assert got == (want_root / rel / name).read_bytes(), rel / name


def test_ft3d_backproject_matches_jax():
    rng = np.random.default_rng(4)
    disp = rng.uniform(1, 30, (8, 10)).astype(np.float32)
    flow = rng.normal(size=(8, 10, 2)).astype(np.float32)
    for args in ((disp,), (disp, flow)):
        np.testing.assert_array_equal(tft3d.backproject(*args),
                                      jft3d.backproject(*args))


@pytest.mark.parametrize("save_near", [False, True])
def test_ft3d_process_scene_writes_the_jax_bytes(tmp_path, save_near):
    raw = make_raw_ft3d(tmp_path / "raw")
    got = tft3d.process_scene(str(raw), str(tmp_path / "port"), "train",
                              "0000000", save_near)
    want = jft3d.process_scene(str(raw), str(tmp_path / "jax"), "train",
                               "0000000", save_near)
    assert got == want
    if not save_near:
        assert got == (11 * 16 - 1,) * 2
    _same_scene_files(tmp_path / "port", tmp_path / "jax",
                      os.path.join("train", "0000000"))


def test_ft3d_cli_writes_every_scene(tmp_path, capsys):
    raw = make_raw_ft3d(tmp_path / "raw")
    make_raw_ft3d(raw, names=("0000005",), split="val")
    tft3d.main(["--raw_data_path", str(raw), "--save_path",
                str(tmp_path / "port"), "--workers", "1"])
    assert capsys.readouterr().out.strip() == "processed 3 scenes"
    for split, name in (("train", "0000000"), ("train", "0000001"),
                        ("val", "0000005")):
        jft3d.process_scene(str(raw), str(tmp_path / "jax"), split, name)
        _same_scene_files(tmp_path / "port", tmp_path / "jax",
                          os.path.join(split, name))


CALIB = ("P_rect_02: 721.5377 0.0 609.5593 44.85728 0.0 721.5377 172.854 "
         "0.2163791 0.0 0.0 1.0 0.002745884\n")


def test_kitti_calib_depth_and_backprojection_match_jax(tmp_path):
    calib = tmp_path / "000000.txt"
    calib.write_text("S_02: 1 2\n" + CALIB)
    p = tkitti.read_calib(str(calib))
    np.testing.assert_array_equal(p, jkitti.read_calib(str(calib)))
    rng = np.random.default_rng(5)
    disp = rng.uniform(1, 80, (6, 9)).astype(np.float32)
    valid = rng.uniform(size=(6, 9)) > 0.2
    depth = tkitti.disparity_to_depth(disp.copy(), valid, float(p[0, 0]))
    np.testing.assert_array_equal(
        depth, jkitti.disparity_to_depth(disp.copy(), valid, float(p[0, 0])))
    px = rng.uniform(0, 9, (6, 9)).astype(np.float32)
    py = rng.uniform(0, 6, (6, 9)).astype(np.float32)
    for kw in ({}, {"px": px, "py": py}):
        np.testing.assert_array_equal(tkitti.backproject_kitti(depth, p, **kw),
                                      jkitti.backproject_kitti(depth, p, **kw))
    calib.write_text(CALIB + CALIB)
    with pytest.raises(ValueError, match="exactly one P_rect_02"):
        tkitti.read_calib(str(calib))


def make_raw_kitti(raw, calib, frames=(0, 1), h=6, w=9):
    """16-bit disparity PNGs (0 where invalid) and flow PNGs (u, v,
    valid) with a calibration file per frame."""
    rng = np.random.default_rng(6)
    for sub in ("disp_occ_0", "disp_occ_1", "flow_occ"):
        (raw / sub).mkdir(parents=True, exist_ok=True)
    calib.mkdir(parents=True, exist_ok=True)
    for i in frames:
        sidx = f"{i:06d}"
        (calib / f"{sidx}.txt").write_text(CALIB)
        for sub in ("disp_occ_0", "disp_occ_1"):
            d = rng.integers(256, 256 * 90, (h, w)).astype(np.uint16)
            d[rng.uniform(size=(h, w)) < 0.2] = 0
            (raw / sub / f"{sidx}_10.png").write_bytes(
                encode_png(d, [0, 1, 2, 3, 4]))
        f = np.stack([rng.integers(2**15 - 640, 2**15 + 640, (h, w)),
                      rng.integers(2**15 - 640, 2**15 + 640, (h, w)),
                      rng.uniform(size=(h, w)) > 0.1], -1).astype(np.uint16)
        (raw / "flow_occ" / f"{sidx}_10.png").write_bytes(
            encode_png(f, [4, 3]))


def test_kitti_process_frame_writes_the_jax_bytes(tmp_path):
    raw, calib = tmp_path / "raw", tmp_path / "calib"
    make_raw_kitti(raw, calib)
    dirs = [str(raw / s) for s in ("disp_occ_0", "disp_occ_1", "flow_occ")]
    for i in (0, 1):
        got = tkitti.process_frame(*dirs, str(calib), str(tmp_path / "port"),
                                   i)
        want = jkitti.process_frame(*dirs, str(calib), str(tmp_path / "jax"),
                                    i)
        assert got == want and 0 < got < 6 * 9
        _same_scene_files(tmp_path / "port", tmp_path / "jax", f"{i:06d}")
    assert tkitti.process_kitti(str(raw), str(calib),
                                str(tmp_path / "again"), workers=1,
                                n_frames=2) == 2
    for i in (0, 1):
        _same_scene_files(tmp_path / "again", tmp_path / "jax", f"{i:06d}")
