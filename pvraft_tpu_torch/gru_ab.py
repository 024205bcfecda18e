"""Time GRU-update kernel sources against each other on the card.

    python -m pvraft_tpu_torch.gru_ab [--entry fp32|bf16|general]
        [--source NAME=PATH[@PLAN] ...] [--seed S]

Builds each ``.cu`` source that exports the entry point with the port's
nvcc flags into its own directory under ``pvraft_tpu_torch/_build/ab/``,
one ``nvcc`` each, all started together, and times them against each
other on the same inputs.

``--entry fp32`` (the default): sources of ``pvraft_gru_update`` (the C
entry point of ``csrc/gru_iter.cu``, same arguments); the checkout's own
``csrc/gru_iter.cu`` is always one of them, named ``this``. At each B x N
of ``SHAPES``, on the inputs ``chip_smoke.py`` gives the GRU kernel, it
calls every source once, reports its max |err| against ``gru_math``
(fp32) and against ``gru_math`` in fp64 (beside fp32 ``gru_math``'s own)
and whether two launches are bitwise equal.

``--entry bf16``: sources of ``pvraft_gru_update_bf16`` (the 21-argument
C entry point of ``csrc/gru_iter_bf16.cu``: 13 pointers, rows, hidden,
context and correlation widths, three launch ints, the stream); the
checkout's own ``csrc/gru_iter_bf16.cu`` is ``this``. ``@PLAN`` names the
host plan that gives a source its three launch ints: ``bf16`` (the
default, ``ops/cuda/gru_iter.py::bf16_gru_plan``: blocks, threads, shared
memory) or ``general`` (:func:`v7_plan`: groups of 8 points, threads,
shared memory; the plan of the bf16 kernel before it moved to the tensor
cores). At width 64 at each B x N of ``SHAPES`` and at 1 x
8192 at each width of ``BF16_WIDTHS`` (correlation features 64, the
lookup head's), on the operands the bf16 model hands over (cor bf16, the
rest float32), it holds every source against ``gru_math`` at bf16 by
``chip_smoke.py``'s rule (``BF16_OP_TOL`` at all but ``BF16_STRAY`` of
the outputs, every output within ``FLOOR_FACTOR`` x the plain version's
own host-vs-card spread where that is wider), reports whether two
launches are bitwise equal, and times ``gru_math`` at bf16 (``plain``)
beside the sources.

``--entry general``: sources of ``pvraft_gru_update_general`` (the
20-argument C entry point of ``csrc/gru_iter_general.cu``, laid out as
the bf16 one); the checkout's own ``csrc/gru_iter_general.cu`` is
``this``. ``@PLAN``: ``general`` (the default, ``general_gru_plan``:
mode, points per block, shared memory), ``resident``, ``ring`` or
``fma`` (the same plan held to that mode; a width where that mode has
no layout reports the refusal and is not timed), or
``v7`` (:func:`v7_plan`, the plan of the kernel before it moved to the
tensor cores, for a parent checkout's source). At 1 x 8192 at each
(hidden, context, correlation) width of ``chip_smoke.py::
GENERAL_GRU_WIDTHS``, and at hidden 32 / context 96 at each other B x N
of ``SHAPES``, on ``chip_smoke.py``'s GRU inputs, it reports each
source's max |err| against fp32 ``gru_math`` and against ``gru_math`` in
fp64 (beside fp32 ``gru_math``'s own) and whether two launches are
bitwise equal, and times fp32 ``gru_math`` (``plain``) and the unfused
MotionEncoder + ConvGRU modules (``library``) beside the sources.

Every source, and ``plain``, is timed by device time
(``kernel_bench.device_ms``) in turns: every source in the order given,
then again in the reverse order, so each has two readings. A source that
computes something else on purpose (a variant that isolates one cost)
reports its error and is timed all the same. Prints one JSON line with
the card and each source's ptxas report (registers, shared memory,
spills), then one per shape. Needs a CUDA device: without one it exits
with code 2.
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
    WIDTH, bf16_gru_plan, general_gru_plan, gru_math, pack_gru_weights,
    pad_flow)

SHAPES = ((1, 8192), (2, 8192), (4, 8192), (4, 4096), (1, 2048))
# (hidden, context) widths of the bf16 entry's 1 x 8192 rows beyond 64.
BF16_WIDTHS = ((32, 32), (96, 96), (128, 128))
# entry -> (C symbol, the checkout's source, ints after the pointers)
ENTRIES = {"fp32": ("pvraft_gru_update", "gru_iter", 1),
           "bf16": ("pvraft_gru_update_bf16", "gru_iter_bf16", 7),
           "general": ("pvraft_gru_update_general", "gru_iter_general", 7)}
# entry -> the plans its sources take, the default first
PLANS = {"fp32": ("",), "bf16": ("bf16", "general"),
         "general": ("general", "resident", "ring", "fma", "v7")}


def v7_plan(hidden: int, context: int, corr_ch: int) -> tuple:
    """The general GRU kernel's launch shape before it moved to the tensor
    cores (its FMA body, one thread per channel of a group of 8 points):
    (groups per block, threads, dynamic shared memory bytes). One point
    holds 4 (7 pad4(H) + pad4(C) + pad4(F) + 8) bytes; a block takes as
    many groups as keep about 256 threads busy within 48 KB."""
    def pad4(x):
        return (x + 3) // 4 * 4

    group = 8 * 4 * (7 * pad4(hidden) + pad4(context) + pad4(corr_ch) + 8)
    if min(hidden, context, corr_ch) < 1 or group > _cuda.SMEM_MAX:
        raise ValueError(f"v7 plan: widths {hidden}/{context}/{corr_ch} "
                         f"do not fit {_cuda.SMEM_MAX} bytes")
    groups = max(1, min(256 // hidden, _cuda.SMEM_DEFAULT // group))
    threads = min(256, -(-groups * hidden // 32) * 32)
    return groups, threads, groups * group


def parse_sources(specs, entry: str) -> dict:
    """``NAME=PATH[@PLAN]`` specs -> {name: (path, plan)}, with the
    checkout's own source of ``entry`` as ``this``. The fp32 entry takes
    no plan (its kernel is built on one launch shape)."""
    out = {}
    for spec in specs:
        name, sep, rest = spec.partition("=")
        if not sep or not name or not rest:
            raise ValueError(f"--source {spec!r}: expected NAME=PATH[@PLAN]")
        path, _, plan = rest.partition("@")
        if entry == "fp32" and plan:
            raise ValueError(f"--source {spec!r}: the fp32 entry takes no "
                             f"plan")
        plan = plan or PLANS[entry][0]
        if plan not in PLANS[entry]:
            raise ValueError(f"--source {spec!r}: plan {plan!r} is not one "
                             f"of {PLANS[entry]}")
        if name == "this" or name in out:
            raise ValueError(f"--source {spec!r}: the name {name!r} is taken")
        out[name] = (path, plan)
    out["this"] = (_cuda.sources()[ENTRIES[entry][1]], PLANS[entry][0])
    return out


def build_sources(sources: dict, lib: str) -> dict:
    """name -> (the loaded library, ptxas lines); ``sources`` maps a name
    to a ``.cu`` path, built with the port's nvcc flags into
    ``_build/ab/<name>-<digest>/lib<lib>.so``; one nvcc per source, all
    started together; raises if one fails."""
    root = os.path.join(_cuda.BUILD_ROOT, "ab")
    procs = {}
    for name, src in sources.items():
        with open(src, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()[:12]
        out = os.path.join(root, f"{name}-{digest}", f"lib{lib}.so")
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
        libs[name] = (ctypes.CDLL(out),
                      [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln
                       or "Compiling entry" in ln])
    return libs


def build(sources: dict, entry: str = "fp32") -> dict:
    """name -> (the loaded entry point, ptxas lines) of each GRU source
    (``build_sources``)."""
    symbol, _, n_ints = ENTRIES[entry]
    libs = {}
    for name, (lib, ptxas) in build_sources(sources, "gru").items():
        fn = getattr(lib, symbol)
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[name] = (fn, ptxas)
    return libs


def inputs(rng, b, n, dev, h=WIDTH, c=None, f=None):
    """Seeded operands at chip_smoke.py's GRU distributions: hidden width
    ``h``, context ``c`` and correlation features ``f`` (both default
    ``h``)."""
    return raw_inputs(rng, b, n, dev, h, c, f)[2]


def raw_inputs(rng, b, n, dev, h=WIDTH, c=None, f=None):
    """``inputs``'s operands with the raw parameters they were packed
    from: (MotionEncoder's, ConvGRU's, operands)."""
    c = h if c is None else c
    f = h if f is None else f

    def a(*s, scale=0.15):
        return torch.from_numpy(
            (scale * rng.normal(size=s)).astype(np.float32)).to(dev)

    me = (a(f, h), a(h), a(3, h), a(h), a(2 * h, h - 3), a(h - 3))
    gru = (a(2 * h + c, h), a(h), a(2 * h + c, h), a(h), a(2 * h + c, h),
           a(h))
    weights = pack_gru_weights(me, gru, h, c)
    net = torch.tanh(a(b, n, h, scale=1.0))
    inp = torch.relu(a(b, n, c, scale=1.0))
    cor = a(b, n, f, scale=1.0)
    flow8 = pad_flow(a(b, n, 3, scale=0.3)).contiguous()
    return me, gru, (net, inp, cor, flow8, *weights)


def _launch_ints(entry: str, plan: str, h: int, c: int, f: int,
                 rows: int) -> tuple:
    if plan == "v7" or (entry == "bf16" and plan == "general"):
        return v7_plan(h, c, f)
    if entry == "general":
        return general_gru_plan(h, c, f,
                                None if plan == "general" else plan).launch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return bf16_gru_plan(h, c, f, rows, sms)[:3]


def unfused(me, gru, ops, h, c, f, dev):
    """The library yardstick: the unfused MotionEncoder + ConvGRU modules
    on the raw parameters of ``ops`` (the port never calls them on the
    kernel path); returns a no-grad callable."""
    from pvraft_tpu_torch.models.update import ConvGRU, MotionEncoder

    menc = MotionEncoder(h, f).to(dev)
    cgru = ConvGRU(h, c + h).to(dev)
    with torch.no_grad():
        for layer, (w, bias) in zip(
                (menc.conv_corr, menc.conv_flow, menc.conv,
                 cgru.convz, cgru.convr, cgru.convq),
                zip((*me, *gru)[0::2], (*me, *gru)[1::2])):
            layer.weight.copy_(w.t())
            layer.bias.copy_(bias)
    net, inp, cor, flow8 = ops[:4]
    flow = flow8[..., :3]

    def call():
        with torch.no_grad():
            return cgru(net, torch.cat([inp, menc(flow, cor)], dim=-1))

    return call


def _time(row, calls, order):
    for name in order + order[::-1]:
        row[name]["ms"].append(device_ms(calls[name]))


def run_fp32(libs, order, rng, dev):
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
            calls[name] = lambda call=call, out=outs[0]: call(out)
            row[name] = {"max_abs_err": float((outs[0] - want).abs().max()),
                         "vs_fp64": float((outs[0] - exact).abs().max()),
                         "bitwise_repeat": bool(torch.equal(*outs)),
                         "ms": []}
        _time(row, calls, order)
        print(json.dumps(row), flush=True)


def run_bf16(libs, plans, order, rng, dev):
    sys.path.insert(0, os.path.dirname(_cuda.PKG_DIR))
    from chip_smoke import BF16_OP_TOL, BF16_STRAY, FLOOR_FACTOR, beyond

    bf16 = torch.bfloat16
    cases = [(b, n, WIDTH, WIDTH) for b, n in SHAPES]
    cases += [(1, 8192, h, c) for h, c in BF16_WIDTHS]
    for b, n, h, c in cases:
        ops = list(inputs(rng, b, n, dev, h, c, WIDTH))
        ops[2] = ops[2].to(bf16)
        want = gru_math(*ops[:4], tuple(ops[4:]), bf16)
        host = gru_math(*(t.cpu() for t in ops[:4]),
                        tuple(t.cpu() for t in ops[4:]), bf16)
        floor = float((want.cpu() - host).abs().max())
        atol = max(BF16_OP_TOL["atol"], FLOOR_FACTOR * floor)
        row = {"shape": [b, n, h, c, WIDTH], "plain_host_vs_card": floor,
               "atol_used": atol, "plain": {"ms": []}}
        calls = {"plain": lambda: gru_math(*ops[:4], tuple(ops[4:]), bf16)}
        for name in order:
            fn = libs[name][0]
            ints = _launch_ints("bf16", plans[name], h, c, WIDTH, b * n)
            outs = [torch.empty_like(ops[0]) for _ in range(2)]

            def call(out, fn=fn, ints=ints):
                _cuda.check(fn(*(t.data_ptr() for t in (*ops, out)),
                               b * n, h, c, WIDTH, *ints,
                               _cuda.stream_ptr(dev)), "gru_ab")

            for out in outs:
                call(out)
            torch.cuda.synchronize()
            calls[name] = lambda call=call, out=outs[0]: call(out)
            got = outs[0]
            stray = beyond(got, want, **BF16_OP_TOL)
            row[name] = {
                "launch": list(ints),
                "max_abs_err": float((got - want).abs().max()),
                "beyond_op_tol": stray,
                "ok": bool(stray <= BF16_STRAY * got.numel()
                           and beyond(got, want, BF16_OP_TOL["rtol"],
                                      atol) == 0),
                "bitwise_repeat": bool(torch.equal(*outs)), "ms": []}
        _time(row, calls, ["plain"] + order)
        print(json.dumps(row), flush=True)


def run_general(libs, plans, order, rng, dev):
    sys.path.insert(0, os.path.dirname(_cuda.PKG_DIR))
    from chip_smoke import GENERAL_GRU_WIDTHS, MAIN_GENERAL

    main = GENERAL_GRU_WIDTHS[MAIN_GENERAL[1]]
    cases = [(1, 8192, *w) for w in GENERAL_GRU_WIDTHS.values()]
    cases += [(b, n, *main) for b, n in SHAPES if (b, n) != (1, 8192)]
    for b, n, h, c, f in cases:
        me, gru, ops = raw_inputs(rng, b, n, dev, h, c, f)
        want = gru_math(*ops[:4], ops[4:])
        d = [t.double() for t in ops]
        exact = gru_math(*d[:4], tuple(d[4:]))
        library = unfused(me, gru, ops, h, c, f, dev)
        row = {"shape": [b, n, h, c, f],
               "gru_math_vs_fp64": float((want - exact).abs().max()),
               "library_vs_plain": float((library() - want).abs().max()),
               "plain": {"ms": []}, "library": {"ms": []}}
        calls = {"plain": lambda: gru_math(*ops[:4], ops[4:]),
                 "library": library}
        timed = ["plain", "library"]
        for name in order:
            fn = libs[name][0]
            try:
                ints = _launch_ints("general", plans[name], h, c, f, b * n)
            except ValueError as e:   # a mode with no layout at the widths
                row[name] = {"refused": str(e)}
                continue
            timed.append(name)
            outs = [torch.empty_like(ops[0]) for _ in range(2)]

            def call(out, fn=fn, ints=ints):
                _cuda.check(fn(*(t.data_ptr() for t in (*ops, out)),
                               b * n, h, c, f, *ints,
                               _cuda.stream_ptr(dev)), "gru_ab")

            for out in outs:
                call(out)
            torch.cuda.synchronize()
            calls[name] = lambda call=call, out=outs[0]: call(out)
            row[name] = {"launch": list(ints),
                         "max_abs_err": float((outs[0] - want).abs().max()),
                         "vs_fp64": float((outs[0] - exact).abs().max()),
                         "bitwise_repeat": bool(torch.equal(*outs)),
                         "ms": []}
        _time(row, calls, timed)
        print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--entry", choices=sorted(ENTRIES), default="fp32",
                    help="the C entry point the sources export")
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH[@PLAN]",
                    help="another source of the entry point")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sources = parse_sources(args.source, args.entry)
    if not torch.cuda.is_available():
        print("gru_ab: no CUDA device", file=sys.stderr)
        return 2
    from pvraft_tpu_torch.profile_serve import nvidia_smi

    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build({k: v[0] for k, v in sources.items()}, args.entry)
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    order = list(sources)
    plans = {k: v[1] for k, v in sources.items()}
    print(json.dumps({"gpu": torch.cuda.get_device_name(0),
                      "nvidia_smi": nvidia_smi(), "entry": args.entry,
                      "plans": plans,
                      "ptxas": {k: v[1] for k, v in libs.items()}}),
          flush=True)
    if args.entry == "fp32":
        run_fp32(libs, order, rng, dev)
    elif args.entry == "bf16":
        run_bf16(libs, plans, order, rng, dev)
    else:
        run_general(libs, plans, order, rng, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
