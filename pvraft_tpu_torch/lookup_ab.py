"""Time general lookup kernel sources against each other on the card.

    python -m pvraft_tpu_torch.lookup_ab [--source NAME=PATH[@PLAN] ...]
        [--seed S]

Builds each ``.cu`` source that exports ``pvraft_corr_lookup_general``
(the C entry point of ``csrc/corr_lookup_general.cu``) with the port's
nvcc flags (``gru_ab.build_sources``, one ``nvcc`` each, all started
together) and times them against each other on the same inputs. The
checkout's own source is always one of them, named ``this``. ``@PLAN``
names the host plan that gives a source its launch ints and its argument
list:

  * ``this`` (the default): ``ops/cuda/corr_lookup.py::general_lookup_plan``
    (points per block, levels per pass, shared memory) and the vector-load
    and reciprocal flags, 20 arguments;
  * ``sort``: the plan of the earlier general kernel, which
    bitonic-sorted every candidate's distance in shared memory: the sort
    length (the power of two >= K with a kNN), points per block, shared
    memory, 18 arguments. Give it that kernel's source, e.g. from ``git
    show 4f36daf:pvraft_tpu_torch/csrc/corr_lookup_general.cu``.

At 1 x 8192 at every shape of ``chip_smoke.py::GENERAL_LOOKUPS`` (the
lookup, row 1g) and at each of them with knn = 0 and ``coords = None``
(the voxel-only pass, row 3g, on rel = xyz - coords), on
``chip_smoke.py::lookup_inputs``, it calls every source twice and reports
its max |err| against ``corr_lookup_plain`` (``voxel_bin_means`` for 3g),
whether its kNN indices equal the plain version's, whether the two
launches are bitwise equal and, where the source exports
``pvraft_corr_lookup_general_resident``, the warps per SM its launch keeps
resident. The plain version (``plain``) and every source are timed by
device time (``kernel_bench.device_ms``) in turns: in the order given,
then in the reverse order, so each has two readings. Prints one JSON line
with the card and each source's ptxas report (registers, shared memory,
spills), then one per shape with the bytes bound. Needs a CUDA device:
without one it exits with code 2.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

import numpy as np
import torch

from pvraft_tpu_torch.gru_ab import _time, build_sources
from pvraft_tpu_torch.ops import cuda as _cuda
from pvraft_tpu_torch.ops.cuda.corr_lookup import (
    corr_lookup_plain, general_lookup_plan)
from pvraft_tpu_torch.ops.voxel import voxel_bin_means

SYMBOL = "pvraft_corr_lookup_general"
PLANS = ("this", "sort")
N_POINTS = 8192
BASE_SCALE = 0.25
HBM_BYTES_PER_S = 3.35e12


def parse_sources(specs) -> dict:
    """``NAME=PATH[@PLAN]`` specs -> {name: (path, plan)}, with the
    checkout's own source as ``this``."""
    out = {}
    for spec in specs:
        name, sep, rest = spec.partition("=")
        if not sep or not name or not rest:
            raise ValueError(f"--source {spec!r}: expected NAME=PATH[@PLAN]")
        path, _, plan = rest.partition("@")
        plan = plan or "this"
        if plan not in PLANS:
            raise ValueError(f"--source {spec!r}: plan {plan!r} is not one "
                             f"of {PLANS}")
        if name in ("this", "plain") or name in out:
            raise ValueError(f"--source {spec!r}: the name {name!r} is taken")
        out[name] = (path, plan)
    out["this"] = (_cuda.sources()["corr_lookup_general"], "this")
    return out


def sort_plan(k: int, knn: int, resolution: int) -> tuple:
    """The sorting kernel's launch ints: (sort length, points per block,
    shared memory bytes); one point needs 4 * (2 * (R^3 + 1) * 33 + 2 *
    sort length) bytes, up to 4 points a block within 48 KB."""
    sort_len = 1 << (k - 1).bit_length() if knn > 0 else 0
    per_warp = 4 * (2 * (resolution**3 + 1) * 33 + 2 * sort_len)
    warps = max(1, min(4, _cuda.SMEM_DEFAULT // per_warp))
    return sort_len, warps, warps * per_warp


def entry(lib, plan: str):
    fn = getattr(lib, SYMBOL)
    n_ints = 7 if plan == "this" else 5
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                   + [ctypes.c_float] + [ctypes.c_int] * n_ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launch_ints(plan: str, corr, pts, k, knn, res, levels, scale) -> tuple:
    if plan == "sort":
        return sort_plan(k, knn, res)
    p = general_lookup_plan(k, knn, res, levels)
    return (p.levels_per_pass, p.warps, p.smem,
            int(_cuda.vector_loads(k, corr, pts)),
            int(_cuda.reciprocal_is_exact(scale, levels)))


def resident(lib, plan: str, k: int, knn: int, ints: tuple):
    """Warps per SM the launch keeps resident, where the source says."""
    fn = getattr(lib, f"{SYMBOL}_resident", None)
    if fn is None or plan != "this":
        return None
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    return fn(k, knn, ints[1], ints[2])


def run_case(libs, plans, order, name, args, dev) -> dict:
    """Every source on ``args`` (corr, pts, coords or None, levels, scale,
    R, knn) against the plain version; timed in turns."""
    corr, pts, coords, levels, scale, res, knn = args
    b, n, k = corr.shape
    r3 = res**3
    if coords is None:
        want = (voxel_bin_means(corr, pts, levels, scale, res),)
        calls = {"plain": lambda: voxel_bin_means(corr, pts, levels, scale,
                                                  res)}
    else:
        want = corr_lookup_plain(*args)
        calls = {"plain": lambda: corr_lookup_plain(*args)}
    bytes_ = 4 * b * n * (4 * k + (3 if coords is not None else 0)
                          + levels * r3 + 5 * knn)
    row = {"case": name, "shape": [b, n, k], "knn": knn, "resolution": res,
           "levels": levels, "bytes": bytes_,
           "bound_ms": 1e3 * bytes_ / HBM_BYTES_PER_S, "plain": {"ms": []}}
    for src in order:
        lib, plan = libs[src][0], plans[src]
        fn = entry(lib, plan)
        ints = launch_ints(plan, corr, pts, k, knn, res, levels, scale)
        outs = [(torch.empty(b, n, levels * r3, device=dev),
                 torch.empty(b, n, knn, device=dev),
                 torch.empty(b, n, knn, 3, device=dev),
                 torch.empty(b, n, knn, dtype=torch.int32, device=dev))
                for _ in range(2)]

        def call(out, fn=fn, ints=ints):
            _cuda.check(fn(corr.data_ptr(), pts.data_ptr(),
                           None if coords is None else coords.data_ptr(),
                           *(t.data_ptr() for t in out), b * n, n, k,
                           levels, scale, res, knn, *ints,
                           _cuda.stream_ptr(dev)), f"lookup_ab {src}")

        for out in outs:
            call(out)
        torch.cuda.synchronize()
        got = outs[0]
        calls[src] = lambda call=call, out=got: call(out)
        err = max([float((g - w).abs().max())
                   for g, w in zip(got[:3], want[:3]) if g.numel()],
                  default=0.0)
        row[src] = {
            "launch": list(ints), "max_abs_err": err,
            "knn_idx_equal": (None if coords is None
                              else bool(torch.equal(got[3], want[3]))),
            "bitwise_repeat": all(torch.equal(x, y)
                                  for x, y in zip(*outs)),
            "resident_warps": resident(lib, plan, k, knn, ints), "ms": []}
    _time(row, calls, ["plain"] + order)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH[@PLAN]",
                    help="another source of the entry point")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sources = parse_sources(args.source)
    if not torch.cuda.is_available():
        print("lookup_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(_cuda.PKG_DIR))
    from chip_smoke import GENERAL_LOOKUPS, lookup_inputs

    libs = build_sources({k: v[0] for k, v in sources.items()}, "lookup")
    plans = {k: v[1] for k, v in sources.items()}
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    order = list(sources)
    print(json.dumps({"gpu": torch.cuda.get_device_name(0), "plans": plans,
                      "ptxas": {k: v[1] for k, v in libs.items()}}),
          flush=True)
    for name, (k, knn, res, levels) in GENERAL_LOOKUPS.items():
        corr, xyz, coords = lookup_inputs(rng, 1, N_POINTS, dev, k)
        print(json.dumps(run_case(
            libs, plans, order, name,
            (corr, xyz, coords, levels, BASE_SCALE, res, knn), dev)),
            flush=True)
        rel = (xyz - coords[:, :, None, :]).contiguous()
        print(json.dumps(run_case(
            libs, plans, order, f"voxel_{name}",
            (corr, rel, None, levels, BASE_SCALE, res, 0), dev)), flush=True)
        del corr, xyz, coords, rel
    return 0


if __name__ == "__main__":
    sys.exit(main())
