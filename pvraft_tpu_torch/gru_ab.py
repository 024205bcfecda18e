"""Time GRU-update kernel sources against each other on the card.

    python -m pvraft_tpu_torch.gru_ab [--source NAME=PATH ...] [--seed S]

Builds each ``.cu`` source that exports ``pvraft_gru_update`` (the C entry
point of ``csrc/gru_iter.cu``, same arguments) with the port's nvcc flags
into its own directory under ``pvraft_tpu_torch/_build/ab/``, one ``nvcc``
each, all started together. The checkout's own ``csrc/gru_iter.cu`` is
always one of them, named ``this``. Then, at each B x N of ``SHAPES``, on
the inputs ``chip_smoke.py`` gives the GRU kernel, it calls every source
once, reports its max |err| against ``gru_math`` (fp32) and against
``gru_math`` in fp64 (beside fp32 ``gru_math``'s own) and whether two
launches are bitwise equal, and times each by device time
(``kernel_bench.device_ms``) in turns: every source in the order given,
then again in the reverse order, so each has two readings. A source that computes something else on purpose (a
variant that isolates one cost) reports its error and is timed all the
same. Prints one JSON line per shape and one with each source's ptxas
report (registers, shared memory, spills). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

from pvraft_tpu_torch.kernel_bench import device_ms
from pvraft_tpu_torch.ops import cuda as _cuda
from pvraft_tpu_torch.ops.cuda.gru_iter import (
    WIDTH, gru_math, pack_gru_weights, pad_flow)

SHAPES = ((1, 8192), (2, 8192), (4, 8192), (4, 4096), (1, 2048))


def build(sources: dict) -> dict:
    """name -> (loaded library, ptxas lines); one nvcc per source, all
    started together; raises if one fails."""
    root = os.path.join(_cuda.BUILD_ROOT, "ab")
    procs = {}
    for name, src in sources.items():
        with open(src, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()[:12]
        out = os.path.join(root, f"{name}-{digest}", "libgru.so")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        # The source's own directory first on the include path, as when it
        # is built in place.
        cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS,
               "-I", os.path.dirname(os.path.abspath(src)), "-o", out, src]
        procs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(out).pvraft_gru_update
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = (fn, [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln])
    return libs


def inputs(rng, b, n, dev):
    """Seeded operands at chip_smoke.py's GRU distributions."""
    h = WIDTH

    def a(*s, scale=0.15):
        return torch.from_numpy(
            (scale * rng.normal(size=s)).astype(np.float32)).to(dev)

    me = (a(h, h), a(h), a(3, h), a(h), a(2 * h, h - 3), a(h - 3))
    gru = (a(3 * h, h), a(h), a(3 * h, h), a(h), a(3 * h, h), a(h))
    weights = pack_gru_weights(me, gru, h, h)
    net = torch.tanh(a(b, n, h, scale=1.0))
    inp = torch.relu(a(b, n, h, scale=1.0))
    cor = a(b, n, h, scale=1.0)
    flow8 = pad_flow(a(b, n, 3, scale=0.3)).contiguous()
    return (net, inp, cor, flow8, *weights)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH", help="another GRU kernel source")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gru_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = dict(s.split("=", 1) for s in args.source)
    sources["this"] = _cuda.sources()["gru_iter"]
    libs = build(sources)
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    order = list(sources)
    print(json.dumps({"gpu": torch.cuda.get_device_name(0),
                      "ptxas": {k: v[1] for k, v in libs.items()}}), flush=True)
    for b, n in SHAPES:
        ops = inputs(rng, b, n, dev)
        want = gru_math(ops[0], ops[1], ops[2], ops[3], ops[4:])
        d = [t.double() for t in ops]
        exact = gru_math(d[0], d[1], d[2], d[3], d[4:])
        row = {"shape": [b, n, WIDTH],
               "gru_math_vs_fp64": float((want - exact).abs().max())}
        calls = {}
        for name in order:
            fn = libs[name][0]
            outs = [torch.empty_like(ops[0]) for _ in range(2)]

            def call(out, fn=fn):
                _cuda.check(fn(*(t.data_ptr() for t in (*ops, out)),
                               b * n, _cuda.stream_ptr(dev)), "gru_ab")

            for out in outs:
                call(out)
            torch.cuda.synchronize()
            calls[name] = (call, outs[0])
            row[name] = {"max_abs_err": float((outs[0] - want).abs().max()),
                         "vs_fp64": float((outs[0] - exact).abs().max()),
                         "bitwise_repeat": bool(torch.equal(*outs)),
                         "ms": []}
        for name in order + order[::-1]:
            call, out = calls[name]
            row[name]["ms"].append(device_ms(lambda: call(out)))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
