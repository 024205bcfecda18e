"""Bitwise replay (port of ``pvraft_tpu/analysis/determinism/replay.py``).

Builds each program of :data:`REPLAY_PROGRAMS` twice from scratch (a
fresh model from the seed, inputs from the ``replay.input`` stream, a
fresh capture: one CUDA graph on the card, the same function on static
buffers on the CPU), runs each build once and hashes every output and
every tensor of its state afterwards (parameters, Adam's state). The two
digests must be equal bit for bit: anything outside the seed contract
that leaks into a program (an unordered reduction, uninitialised memory,
a stray random draw) shows here. On the card the runs go under
``torch.use_deterministic_algorithms`` (sorted scatter-adds, a fixed
cuBLAS workspace), the train step's stance since it was captured.

When two builds differ, the entry names the first tensor that differs
and, for a forward program, the first submodule at which its capture
parts from its eager run (``serve/aot.py::first_difference``).

    python -m pvraft_tpu_torch.analysis determinism --replay \\
        [--out R.json] [--check R.json] [--device cpu] [--size tiny]

Digests are compared with a saved report only on the same platform and
card; the verdict (each program bitwise against itself) holds
everywhere. A difference is never loosened to a tolerance.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

from pvraft_tpu_torch.rng import DEFAULT_SEED, STREAM_NAMES

SCHEMA_VERSION = "pvraft_determinism/v1"

# The train step and a serve dispatch at the default serving dtype.
REPLAY_PROGRAMS = ("flagship_train_step_fp32", "serve_predict_bf16_b8192_bs4")


def _leaves(fn, out) -> List[Tuple[str, Any]]:
    """(name, tensor) of each output and each state tensor: outputs by
    position, state by parameter name where ``fn.module`` has one."""
    from pvraft_tpu_torch.programs.costs import _tensors

    names = {}
    module = getattr(fn, "module", None)
    if module is not None:
        names = {id(p): n for n, p in module.named_parameters()}
    leaves = [(f"output[{i}]", t) for i, t in enumerate(_tensors(out))]
    leaves += [(names.get(id(t), f"state[{i}]"), t)
               for i, t in enumerate(getattr(fn, "state", ()))]
    return leaves


def _digest(leaves) -> str:
    """sha256 over each leaf's dtype, shape and bytes."""
    import torch

    h = hashlib.sha256()
    for _, t in leaves:
        arr = t.detach().cpu().contiguous()
        h.update(str(arr.dtype).encode())
        h.update(str(tuple(arr.shape)).encode())
        h.update(arr.view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _run_once(name: str, device, size: str) -> Dict[str, Any]:
    """Build the spec from scratch, capture it, run it once; its leaves
    (copied to the host) and their digest."""
    import gc

    import torch

    from pvraft_tpu_torch.programs import get, load_catalog
    from pvraft_tpu_torch.serve.aot import capture

    load_catalog()
    dev = torch.device(device)
    fn, inputs = get(name).build(dev, size)
    program = capture(f"replay.{name}", fn, inputs, dev,
                      preserve=getattr(fn, "state", ()))
    out = program(*program.inputs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    leaves = [(n, t.detach().cpu().clone()) for n, t in _leaves(fn, out)]
    run = {"leaves": leaves, "digest": _digest(leaves), "fn": fn,
           "inputs": inputs}
    del program
    gc.collect()
    return run


def _first_difference(a, b) -> Optional[Dict[str, Any]]:
    import torch

    for (name, x), (_, y) in zip(a["leaves"], b["leaves"]):
        if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(x, y):
            diff = (float((x.double() - y.double()).abs().max())
                    if x.shape == y.shape else None)
            return {"tensor": name, "max_abs_diff": diff}
    return None


def replay_report(device=None, size: str = "tiny",
                  programs: Sequence[str] = REPLAY_PROGRAMS
                  ) -> Dict[str, Any]:
    """Run each program twice from scratch and compare bit for bit, on
    ``device`` (the card unless another device is named)."""
    import gc

    import torch

    from pvraft_tpu_torch.device import (
        deterministic_algorithms,
        resolve_device,
    )
    from pvraft_tpu_torch.programs import get, load_catalog
    from pvraft_tpu_torch.serve.aot import first_difference

    load_catalog()
    dev = resolve_device(device)
    entries: List[Dict[str, Any]] = []
    with deterministic_algorithms(dev.type == "cuda"):
        for name in programs:
            first = _run_once(name, dev, size)
            second = _run_once(name, dev, size)
            same = (first["digest"] == second["digest"]
                    and len(first["leaves"]) == len(second["leaves"]))
            entry = {"name": name, "tags": list(get(name).tags),
                     "determinism": get(name).determinism,
                     "n_output_leaves": len(first["leaves"]),
                     "digest": first["digest"],
                     "digest_rerun": second["digest"],
                     "bitwise_identical": bool(same)}
            if not same:
                entry["first_difference"] = _first_difference(first, second)
                module = getattr(second["fn"], "module", None)
                if module is not None and "serve" in get(name).tags:
                    entry["first_module_difference"] = first_difference(
                        module, second["fn"], second["inputs"], dev)
            entries.append(entry)
            first = second = None
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    on_card = dev.type == "cuda"
    return {
        "schema": SCHEMA_VERSION,
        "seed": DEFAULT_SEED,
        "platform": "gpu" if on_card else dev.type,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "torch_version": torch.__version__,
        "size": size,
        "deterministic_algorithms": on_card,
        "streams": list(STREAM_NAMES),
        "programs": entries,
        "verdict": ("bitwise" if all(e["bitwise_identical"] for e in entries)
                    else "divergent"),
    }


def write_report(path: str, report: Dict[str, Any]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")


def load_report(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("schema") != SCHEMA_VERSION:
        raise ValueError(f"{path}: schema {doc.get('schema')!r}, expected "
                         f"{SCHEMA_VERSION!r}")
    return doc


def check_report(path: str, fresh: Dict[str, Any]) -> List[str]:
    """A fresh replay against a saved report: both bitwise, the same
    programs, seed, streams and size; the digests equal where both ran
    on the same platform and card. Returns the problems ([] = holds)."""
    try:
        saved = load_report(path)
    except (OSError, ValueError) as e:
        return [f"cannot read the saved report: {e}"]
    problems: List[str] = []
    if saved.get("verdict") != "bitwise":
        problems.append(f"saved verdict is {saved.get('verdict')!r}, not "
                        "'bitwise'")
    for e in fresh["programs"]:
        if not e["bitwise_identical"]:
            problems.append(
                f"program {e['name']} does not replay bitwise here: "
                f"{e['digest'][:16]} vs {e['digest_rerun'][:16]}, first "
                f"difference {e.get('first_difference')}")
    for key in ("seed", "streams", "size"):
        if saved.get(key) != fresh[key]:
            problems.append(f"{key} drift: saved {saved.get(key)!r}, fresh "
                            f"{fresh[key]!r}")
    want = {e["name"]: e for e in saved.get("programs", [])}
    got = {e["name"]: e for e in fresh["programs"]}
    if sorted(want) != sorted(got):
        problems.append(f"program set drift: saved {sorted(want)}, fresh "
                        f"{sorted(got)}")
    same_card = (saved.get("platform"), saved.get("device")) == \
        (fresh["platform"], fresh["device"])
    for name in sorted(set(want) & set(got)):
        if same_card and want[name].get("digest") != got[name]["digest"]:
            problems.append(f"{name}: output digest drift on "
                            f"{fresh['device']}: the program's numerics "
                            "changed")
    return problems
