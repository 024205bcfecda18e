"""Export a checkpoint to the reference's key names (the port's
``scripts/export_checkpoint.py``).

    python -m pvraft_tpu_torch.export <src.msgpack> <dst.params> [--refine]

Reads a msgpack checkpoint (the port's or the JAX package's) and writes
a reference ``.params`` file, ``torch.save({"epoch", "state_dict"})``
with the reference's key names (``engine/checkpoint.py::
export_torch_state_dict``), which the reference's ``test.py`` loads with
``strict=True``: train here, evaluate in the original code. Stage 2 is
detected by the tree's ``backbone`` subtree; ``--refine`` on a stage-1
checkpoint exits with an error. A payload without an epoch is written
with epoch -1, the "unknown" sentinel. Needs no card.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import torch

from pvraft_tpu_torch.engine.checkpoint import export_torch_state_dict, load_params


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser("pvraft_tpu_torch export")
    ap.add_argument("src", help="msgpack checkpoint")
    ap.add_argument("dst", help="output torch .params path")
    ap.add_argument("--refine", action="store_true",
                    help="assert the source is a PVRaftRefine (stage-2) "
                         "checkpoint (the layout is detected; this flag "
                         "fails fast on a stage-1 tree)")
    args = ap.parse_args(argv)
    variables, epoch = load_params(args.src)
    tree = variables["params"]
    refine = args.refine or "backbone" in tree
    if refine and "backbone" not in tree:
        sys.exit("error: --refine given but the checkpoint has no 'backbone' "
                 "subtree (this looks like a stage-1 PVRaft checkpoint)")
    sd = export_torch_state_dict(tree, refine=refine)
    state_dict = {k: torch.from_numpy(v.copy()) for k, v in sd.items()}
    os.makedirs(os.path.dirname(args.dst) or ".", exist_ok=True)
    torch.save({"epoch": epoch, "state_dict": state_dict}, args.dst)
    print(f"wrote {args.dst} ({len(state_dict)} tensors, epoch {epoch})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
