"""Where a train step's time goes on the card.

    python -m pvraft_tpu_torch.profile_train [--seed S] [--fused-gru]
        [--no-use_pallas] [--top 12]

Trains the flagship ``ModelConfig`` at the ``TrainConfig`` defaults
(B=2 scenes of 8,192 points, 8 GRU iterations, fp32, Adam) on seeded
FT3D-like synthetic scenes, on one CUDA device, two ways: ``eager``
(``Trainer(graphs=False)``: the step op by op, with a plain Adam at a
float learning rate) and ``graphed`` (the
captured train step that ``Trainer`` runs by default). Each: two warm-up
steps, then one step under ``torch.profiler``. One JSON line per way
gives the wall time, device-busy time, idle share, kernel count, the
device-busy time within the model's ``pvraft.*`` stage ranges (a replay
has none) and the kernels with the most device time. The eager line
also gives, from the same step's work with a synchronize after each
phase, the device-busy time of its forward, backward and optimizer
phases (the autograd engine launches the backward from its own thread,
which the device-side ranges of the unsynchronised step do not cover;
inside one graph the phases cannot be told apart). The graphed line
gives its programs' capture records. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch
from torch.profiler import record_function

from pvraft_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from pvraft_tpu_torch.data import batches, to_device
from pvraft_tpu_torch.engine.steps import scheduled_step, sequence_loss_of
from pvraft_tpu_torch.engine.trainer import Trainer
from pvraft_tpu_torch.profile_serve import nvidia_smi, profile_call


def flagship_train_config(seed: int = 0, epochs: int = 1,
                          **model_kw) -> Config:
    """The flagship ModelConfig and the TrainConfig defaults (B=2,
    8 iterations, eval at 32) on 4 seeded FT3D-like synthetic scenes of
    8,192 points (4 independently moving objects each)."""
    return Config(model=ModelConfig(**model_kw),
                  data=DataConfig(dataset="synthetic", synthetic_size=4,
                                  synthetic_objects=4),
                  train=TrainConfig(num_epochs=epochs, seed=seed))


def phased_step(trainer: Trainer, batch) -> None:
    """The train step's work (``make_train_step``) with a synchronize at
    the end of each ``phase.*`` range."""
    cfg = trainer.cfg.train
    trainer.optimizer.zero_grad(set_to_none=True)
    with record_function("phase.forward"):
        loss, _ = sequence_loss_of(trainer.model, batch, cfg.gamma, cfg.iters)
        torch.cuda.synchronize()
    with record_function("phase.backward"):
        loss.backward()
        torch.cuda.synchronize()
    with record_function("phase.optimizer"):
        scheduled_step(trainer.optimizer, trainer.schedule)
        torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fused-gru", action="store_true")
    ap.add_argument("--use_pallas", action=argparse.BooleanOptionalAction,
                    default=None)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = flagship_train_config(args.seed, fused_gru=args.fused_gru,
                                use_pallas=args.use_pallas)
    gpu = nvidia_smi()
    for path in ("eager", "graphed"):
        trainer = Trainer(cfg, graphs=path == "graphed")
        batch = to_device(next(batches(trainer.train_ds, 2)), trainer.device)
        for _ in range(2):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        row = profile_call(lambda: trainer.train_step(batch), args.top)
        row["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        if path == "eager":
            phased = profile_call(lambda: phased_step(trainer, batch),
                                  args.top)
            row["phase_busy_ms"] = phased["phase_busy_ms"]
            row["phased_top_kernels"] = phased["top_kernels"]
        else:
            row["programs"] = trainer.compile_report()
            row["reserved_bytes"] = torch.cuda.memory_reserved()
        print(json.dumps({"gpu": gpu, "fused_gru": args.fused_gru,
                          "use_pallas": args.use_pallas, "path": path,
                          "batch": 2, "points": cfg.data.max_points,
                          "iters": cfg.train.iters, **row}), flush=True)
        del trainer, batch
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
