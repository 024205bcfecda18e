"""The port's program catalog: every program it runs, registered once
(modelled on ``pvraft_tpu/programs/catalog.py``, over the port's own
programs).

Tags:

* ``kernel``: one forward and one gradient spec per hand-written kernel
  (``csrc/*.cu``) at the shapes of ``PERF.md`` §6, 1 x 8192: kernels 1,
  2, 2b and 3 at the flagship widths, 1g and 3g at truncate_k 1024 /
  knn 64, 2g at hidden 32 / context 96. Every kernel has a gradient of
  its own (a hand-written backward in plain PyTorch).
* ``flagship`` with ``train`` or ``fwd``: the train step at fp32 and bf16
  (the bf16 one with ``fused_gru`` and bf16 gradients, as the port trains
  bf16), the forward at both, the eval step (32 iterations, one scene),
  and stage 2's train and eval steps (32 iterations): B = 2 x 8,192,
  truncate_k 512, the train step's Adam as the Trainer makes it.
* ``sharded``: ``dp_sp_2x2_train_step``, the stage-1 train step of one
  rank of a 2 x 2 (data x seq) mesh (``parallel/``): on a process group
  of 4 ranks each rank's program, with the flagship batch sharded over
  ``data`` and each scene's points over ``seq``; on fewer ranks the
  layout the group offers (one process: the one-rank step), as the JAX
  spec degrades to the devices the host offers.
* ``serve`` and ``aot``: one spec per (bucket, batch) of ``ServeConfig()``
  and per serving dtype, named ``serve_predict_<fp32|bf16>_b<bucket>_bs
  <batch>``: the function each replica captures
  (``serve/engine.py::predict_fn``).
* ``profile``: the step profiler's ladder rungs
  (``profiling/step_profiler.py::ladder_programs``).

Every spec declares its ``determinism=`` stance (detcheck GD003): the
lookup's backward scatter-adds into knn indices that are distinct per
point, and the voxel counts add exact 0/1 values, so neither depends on
the order of its adds on the card; the plain voxel means' float sums do,
but with ``use_pallas`` the card runs the kernel, and on the CPU
scatter-adds run in order. Collectives run only on a process group.

Every input comes from the ``replay.input`` stream (``rng.py``): input
``i`` of a program always draws from the same substream, so two builds
of a spec get bitwise the same inputs (``analysis/determinism/
replay.py``). Weights are seeded from ``model.init``.

Nothing is built at import: each thunk imports what it needs and builds
the model when it is called.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

from pvraft_tpu_torch.profiling.step_profiler import MEASUREMENTS
from pvraft_tpu_torch.programs import geometries as g
from pvraft_tpu_torch.programs.spec import register
from pvraft_tpu_torch.rng import DEFAULT_SEED
from pvraft_tpu_torch.serve.aot import SERVE_DTYPES, predict_program_name
from pvraft_tpu_torch.serve.engine import SERVE_DEFAULT_ITERS


def stream_input(i: int, shape: Sequence[int], dtype: str, device,
                 seed: int = DEFAULT_SEED):
    """Input ``i`` of a program: float standard normals, or a mostly
    valid bool mask (80% True, every row's first point True)."""
    import numpy as np
    import torch

    from pvraft_tpu_torch.rng import host_rng

    rng = host_rng(seed, "replay.input", i)
    shape = tuple(shape)
    if dtype == "bool":
        arr = rng.random(shape) < 0.8
        if arr.ndim:
            arr[..., 0] = True
        return torch.from_numpy(arr).to(device)
    arr = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(arr).to(device=device, dtype=getattr(torch, dtype))


def _inputs(device, *shapes: Tuple[Sequence[int], str]):
    return tuple(stream_input(i, s, dt, device)
                 for i, (s, dt) in enumerate(shapes))


def _points(size: str, flagship: int = g.FLAGSHIP_POINTS) -> int:
    return flagship if size == "flagship" else g.TINY_POINTS


# The determinism= stances (see the module docstring).
_KERNEL_STANCE = "unique-index-scatter; exact voxel counts"
_GRU_STANCE = ("no hazard op of its own; reaches the lookup's "
               "unique-index-scatter through ops/cuda")
_MODEL_STANCE = ("unique-index-scatter; exact voxel counts; no collective "
                 "in one process")
_SHARDED_STANCE = ("unique-index-scatter; exact voxel counts; all_reduce "
                   "and ring order fixed by the mesh")


# --- the kernels (tag "kernel") ---------------------------------------------


def _grad_of(fn):
    """The gradient program of ``fn``: the sum of its float outputs,
    differentiated with respect to every float input."""
    import torch

    def grad(*inputs):
        leaves = [x.detach().requires_grad_(x.is_floating_point())
                  for x in inputs]
        with torch.enable_grad():
            out = fn(*leaves)
            total = sum(o.float().sum() for o in out
                        if o.is_floating_point())
            wrt = [x for x in leaves if x.requires_grad]
            grads = torch.autograd.grad(total, wrt, allow_unused=True)
        return tuple(torch.zeros_like(x) if d is None else d
                     for x, d in zip(wrt, grads))

    return grad


def _lookup_thunk(k: int, knn: int, resolution: int, levels: int,
                  grad: bool):
    def thunk(device, size):
        from pvraft_tpu_torch.ops.cuda.corr_lookup import fused_corr_lookup

        b, n = g.KERNEL_SHAPE[0], _points(size, g.KERNEL_SHAPE[1])
        corr, xyz, coords = _inputs(device, ((b, n, k), "float32"),
                                    ((b, n, k, 3), "float32"),
                                    ((b, n, 3), "float32"))

        def fwd(c, x, q):
            return fused_corr_lookup(c, x, q, levels, 0.25, resolution, knn)

        if grad:
            def fn(c, x, q):
                return _grad_of(lambda c_: fwd(c_, x, q))(c)
        else:
            fn = fwd
        return fn, (corr, xyz, coords)

    return thunk


def _voxel_thunk(k: int, resolution: int, levels: int, grad: bool):
    def thunk(device, size):
        from pvraft_tpu_torch.ops.cuda.voxel_corr import (
            voxel_bin_means_pallas,
        )

        b, n = g.KERNEL_SHAPE[0], _points(size, g.KERNEL_SHAPE[1])
        corr, rel = _inputs(device, ((b, n, k), "float32"),
                            ((b, n, k, 3), "float32"))

        def fwd(c, r):
            return (voxel_bin_means_pallas(c, r, levels, 0.25, resolution),)

        if grad:
            def fn(c, r):
                return _grad_of(lambda c_: fwd(c_, r))(c)
        else:
            fn = fwd
        return fn, (corr, rel)

    return thunk


def _gru_thunk(h: int, c: int, f: int, dtype: str, grad: bool):
    def thunk(device, size):
        import torch

        from pvraft_tpu_torch.ops.cuda.gru_iter import (
            FLOW_PAD,
            fused_gru_update,
        )

        b, n = g.KERNEL_SHAPE[0], _points(size, g.KERNEL_SHAPE[1])
        act = _inputs(device, ((b, n, h), "float32"), ((b, n, c), "float32"),
                      ((b, n, f), dtype), ((b, n, FLOW_PAD), "float32"))
        # The packed weight 8-tuple's shapes (pack_gru_weights), scaled.
        shapes = ((f, h), (FLOW_PAD, h), (2 * h, h), (h, 3 * h),
                  (c, 3 * h), (h, 3 * h), (FLOW_PAD, 3 * h),
                  (FLOW_PAD, 3 * h))
        weights = tuple(0.15 * stream_input(4 + i, s, "float32", device)
                        for i, s in enumerate(shapes))
        cdtype = getattr(torch, dtype)

        def fwd(net, inp, cor, flow8, *w):
            return (fused_gru_update(net, inp, cor, flow8, w, cdtype),)

        return (_grad_of(fwd) if grad else fwd), (*act, *weights)

    return thunk


# (spec name, csrc source, thunk factory, its arguments, geometry)
_KERNELS = (
    ("cuda_corr_lookup", "corr_lookup", _lookup_thunk,
     (g.FLAGSHIP_TRUNCATE_K, 32, 3, 3),
     {"lookup": {"k": g.FLAGSHIP_TRUNCATE_K, "knn": 32, "resolution": 3,
                 "levels": 3}}),
    ("cuda_corr_lookup_general", "corr_lookup_general", _lookup_thunk,
     (g.GENERAL_LOOKUP["k"], g.GENERAL_LOOKUP["knn"],
      g.GENERAL_LOOKUP["resolution"], g.GENERAL_LOOKUP["levels"]),
     {"lookup": dict(g.GENERAL_LOOKUP)}),
    ("cuda_voxel_corr", "voxel_corr", _voxel_thunk,
     (g.FLAGSHIP_TRUNCATE_K, 3, 3),
     {"voxel": {"k": g.FLAGSHIP_TRUNCATE_K, "resolution": 3, "levels": 3}}),
    ("cuda_voxel_corr_general", "corr_lookup_general", _voxel_thunk,
     (g.GENERAL_LOOKUP["k"], g.GENERAL_LOOKUP["resolution"],
      g.GENERAL_LOOKUP["levels"]),
     {"voxel": {k: g.GENERAL_LOOKUP[k]
                for k in ("k", "resolution", "levels")}}),
    ("cuda_gru_iter", "gru_iter", _gru_thunk, (64, 64, 64, "float32"),
     {"gru": {"hidden": 64, "context": 64, "corr": 64,
              "dtype": "float32"}}),
    ("cuda_gru_iter_bf16", "gru_iter_bf16", _gru_thunk,
     (64, 64, 64, "bfloat16"),
     {"gru": {"hidden": 64, "context": 64, "corr": 64,
              "dtype": "bfloat16"}}),
    ("cuda_gru_iter_general", "gru_iter_general", _gru_thunk,
     (g.GENERAL_GRU["hidden"], g.GENERAL_GRU["context"],
      g.GENERAL_GRU["corr"], "float32"),
     {"gru": {**g.GENERAL_GRU, "dtype": "float32"}}),
)

for _name, _source, _factory, _args, _geom in _KERNELS:
    _b, _n = g.KERNEL_SHAPE
    _geometry = {kind: {"b": _b, "n": _n, **shape}
                 for kind, shape in _geom.items()}
    for _grad in (False, True):
        register(
            f"{_name}_{'grad' if _grad else 'fwd'}",
            tags=("kernel", "cuda"),
            precision="any" if "bf16" in _name else "f32",
            kernels=(_source,), geometry=_geometry,
            determinism=_GRU_STANCE if "gru" in _name else _KERNEL_STANCE,
            description=f"csrc/{_source}.cu "
                        f"{'gradient' if _grad else 'forward'}, "
                        f"{_b} x {_n}",
        )(_factory(*_args, _grad))


# --- flagship programs (tags "flagship" and "train" / "fwd") ----------------


def _model_config(size: str, **kw):
    """The flagship ModelConfig (at "tiny", its tiny dims) with
    ``use_pallas=True``: the model goes through the kernels' Functions on
    every device (on the CPU they run their plain versions), so a program
    counts the same on the CPU and on the card."""
    from pvraft_tpu_torch.config import ModelConfig

    kw = {"use_pallas": True, **kw}
    if size == "tiny":
        kw = {**g.TINY_MODEL, **kw}
    else:
        kw = {"truncate_k": g.FLAGSHIP_TRUNCATE_K, **kw}
    return ModelConfig(**kw)


def _model(cfg, device, refine: bool = False, mesh=None):
    from pvraft_tpu_torch.models.raft import PVRaft, PVRaftRefine
    from pvraft_tpu_torch.rng import torch_seed
    from pvraft_tpu_torch.weights import seeded_state_dict

    model = (PVRaftRefine if refine else PVRaft)(cfg, mesh)
    model.load_state_dict(seeded_state_dict(
        cfg, torch_seed(DEFAULT_SEED, "model.init"), refine), strict=True)
    return model.to(device)


def _batch(device, b: int, n: int):
    """pc1, pc2, a float mask and a ground-truth flow."""
    pc1, pc2, valid, flow = _inputs(device, ((b, n, 3), "float32"),
                                    ((b, n, 3), "float32"),
                                    ((b, n), "bool"), ((b, n, 3), "float32"))
    return pc1, pc2, valid.float(), flow


def _state(model, optimizer=None):
    import torch

    out = list(model.parameters())
    if optimizer is not None:
        out += [t for s in optimizer.state.values() for t in s.values()
                if torch.is_tensor(t)]
    return tuple(out)


def _adam(params, device):
    """The Trainer's Adam on the card (its learning rate a tensor there,
    ``capturable``), the state made before the first step; on the CPU the
    same multi-tensor implementation at a float learning rate."""
    import torch

    from pvraft_tpu_torch.engine.steps import init_adam_state

    dev = torch.device(device)
    card = dev.type == "cuda"
    optimizer = torch.optim.Adam(
        list(params), lr=torch.tensor(1e-3, device=dev) if card else 1e-3,
        betas=(0.9, 0.999), eps=1e-8, capturable=card, foreach=True)
    init_adam_state(optimizer)
    return optimizer


def _train_thunk(model_kw: Dict[str, Any], grad_dtype: str, refine: bool):
    def thunk(device, size):
        from pvraft_tpu_torch.engine.steps import (
            _refine_loss,
            _stage1_loss,
            _train_body,
        )
        from pvraft_tpu_torch.weights import trained_parameters

        cfg = _model_config(size, **model_kw)
        model = _model(cfg, device, refine)
        model.train()
        iters = (g.FLAGSHIP_REFINE_ITERS if refine else g.FLAGSHIP_ITERS) \
            if size == "flagship" else g.TINY_ITERS
        optimizer = _adam((p for _, p in trained_parameters(model)), device)
        loss_of = (_refine_loss(model, iters) if refine
                   else _stage1_loss(model, 0.8, iters))
        fn = _train_body(optimizer, loss_of,
                         None if grad_dtype == "float32" else grad_dtype)
        fn.state, fn.module = _state(model, optimizer), model
        return fn, _batch(device, g.FLAGSHIP_BATCH, _points(size))

    return thunk


def _eval_thunk(model_kw: Dict[str, Any], refine: bool):
    def thunk(device, size):
        from pvraft_tpu_torch.engine.steps import BATCH_KEYS, make_eval_step

        cfg = _model_config(size, **model_kw)
        model = _model(cfg, device, refine).eval()
        iters = ((g.FLAGSHIP_REFINE_ITERS if refine
                  else g.FLAGSHIP_EVAL_ITERS)
                 if size == "flagship" else g.TINY_ITERS)
        step = make_eval_step(model, iters, 0.8, per_scene=True,
                              refine=refine)

        def fn(*inputs):
            out, flow = step(dict(zip(BATCH_KEYS, inputs)))
            return (*(out[k] for k in sorted(out)), flow)

        fn.state, fn.module = _state(model), model
        return fn, _batch(device, 1, _points(size))

    return thunk


def _fwd_thunk(model_kw: Dict[str, Any]):
    def thunk(device, size):
        import torch

        cfg = _model_config(size, **model_kw)
        model = _model(cfg, device).eval()
        iters = g.FLAGSHIP_ITERS if size == "flagship" else g.TINY_ITERS

        def fn(pc1, pc2):
            with torch.no_grad():
                flows, _ = model(pc1, pc2, iters)
            return (flows[-1],)

        fn.state, fn.module = _state(model), model
        return fn, _batch(device, g.FLAGSHIP_BATCH, _points(size))[:2]

    return thunk


_BF16 = {"compute_dtype": "bfloat16", "fused_gru": True}


def _model_geometry(b: int, n: int, model_kw: Dict[str, Any],
                    truncate_k: int = g.FLAGSHIP_TRUNCATE_K):
    """The kernels a model program launches on the card, and their
    shapes (the flagship ModelConfig's widths)."""
    geometry = {"lookup": {"b": b, "n": n, "k": truncate_k, "knn": 32,
                           "resolution": 3, "levels": 3}}
    if model_kw.get("fused_gru"):
        geometry["gru"] = {"b": b, "n": n, "hidden": 64, "context": 64,
                           "corr": 64,
                           "dtype": model_kw.get("compute_dtype",
                                                 "float32")}
    return geometry


def _sources(geometry: Dict[str, Dict[str, Any]]) -> Tuple[str, ...]:
    """The csrc sources of a model program's kernels: the tuned ones at
    the flagship widths, the bf16 GRU at bfloat16."""
    out = []
    if "lookup" in geometry:
        out.append("corr_lookup")
    gru = geometry.get("gru")
    if gru is not None:
        out.append("gru_iter_bf16" if gru["dtype"] == "bfloat16"
                   else "gru_iter")
    return tuple(out)


_B, _N = g.FLAGSHIP_BATCH, g.FLAGSHIP_POINTS
_FLAGSHIP = (
    ("flagship_train_step_fp32", "train", _train_thunk({}, "float32", False),
     {}, _B, "stage-1 train step (fp32): forward, sequence loss, backward, "
             "Adam"),
    ("flagship_train_step_bf16", "train",
     _train_thunk(_BF16, "bfloat16", False), _BF16, _B,
     "stage-1 train step (bf16, fused_gru, bf16 gradients)"),
    ("flagship_fwd_fp32", "fwd", _fwd_thunk({}), {}, _B,
     "stage-1 forward (fp32)"),
    ("flagship_fwd_bf16", "fwd", _fwd_thunk(_BF16), _BF16, _B,
     "stage-1 forward (bf16, fused_gru)"),
    ("flagship_eval_step_fp32", "fwd", _eval_thunk({}, False), {}, 1,
     "stage-1 eval step (32 iterations, one scene)"),
    ("flagship_refine_train_step_fp32", "train",
     _train_thunk({}, "float32", True), {}, _B,
     "stage-2 train step (32 iterations, Adam over the head)"),
    ("flagship_refine_eval_step_fp32", "fwd", _eval_thunk({}, True), {}, 1,
     "stage-2 eval step (32 iterations, one scene)"),
)

for _name, _kind, _thunk, _kw, _b, _about in _FLAGSHIP:
    _geometry = _model_geometry(_b, _N, _kw)
    register(_name, tags=("flagship", _kind),
             precision="any" if "bf16" in _name else "f32",
             kernels=_sources(_geometry), geometry=_geometry,
             determinism=_MODEL_STANCE,
             description=f"{_about}, {_b} x {_N} points")(_thunk)


def _dp_sp_thunk(device, size):
    """This rank's stage-1 train step on a (data x seq) mesh of the
    process group: 2 x 2 on 4 ranks, 1 x 2 on 2, 1 x 1 on one process
    (other worlds raise: the flagship batch of 2 splits over at most 2
    data indices). Its inputs are this rank's block of the flagship
    batch and its rows of each scene."""
    from pvraft_tpu_torch.engine.steps import _stage1_loss, _train_body
    from pvraft_tpu_torch.parallel import (
        make_mesh,
        process_count,
        seq_shard_batch,
    )
    from pvraft_tpu_torch.weights import trained_parameters

    world = process_count()
    if world not in (1, 2, 4):
        raise ValueError(f"dp_sp_2x2_train_step runs on 1, 2 or 4 ranks, "
                         f"not {world}")
    mesh = make_mesh(n_seq=min(world, 2))
    cfg = _model_config(size, seq_shard=mesh.n_seq > 1)
    model = _model(cfg, device, mesh=mesh)
    model.train()
    iters = g.FLAGSHIP_ITERS if size == "flagship" else g.TINY_ITERS
    optimizer = _adam((p for _, p in trained_parameters(model)), device)
    fn = _train_body(optimizer, _stage1_loss(model, 0.8, iters))
    fn.state, fn.module = _state(model, optimizer), model
    batch = dict(zip(("pc1", "pc2", "mask", "flow"),
                     _batch(device, g.FLAGSHIP_BATCH, _points(size))))
    rows = g.FLAGSHIP_BATCH // mesh.n_data
    block = {k: v[mesh.data_index * rows:(mesh.data_index + 1) * rows]
             for k, v in batch.items()}
    local = seq_shard_batch(block, mesh)
    return fn, tuple(local[k] for k in ("pc1", "pc2", "mask", "flow"))


register("dp_sp_2x2_train_step", tags=("flagship", "train", "sharded"),
         kernels=_sources(_model_geometry(_B, _N, {})),
         geometry=_model_geometry(_B, _N, {}),
         determinism=_SHARDED_STANCE,
         description="stage-1 train step of one rank of a 2 x 2 (data x "
                     "seq) mesh: ring kNN and correlation, group-wide "
                     "GroupNorm and gathers (one process: the one-rank "
                     "step)")(_dp_sp_thunk)


# --- the serve table (tags "serve" and "aot") -------------------------------


def _serve_thunk(bucket: int, bs: int, dtype: str):
    def thunk(device, size):
        from pvraft_tpu_torch.serve.engine import predict_fn

        cfg = _model_config(size, compute_dtype=dtype)
        model = _model(cfg, device).eval()
        iters = SERVE_DEFAULT_ITERS if size == "flagship" else g.TINY_ITERS
        n = bucket if size == "flagship" else bucket // g.TINY_BUCKET_DIVISOR
        fn = predict_fn(model, iters, refine=False)
        fn.state, fn.module = _state(model), model
        return fn, _inputs(device, ((bs, n, 3), "float32"),
                           ((bs, n, 3), "float32"), ((bs, n), "bool"),
                           ((bs, n), "bool"))

    return thunk


for _dtype, _short in SERVE_DTYPES.items():
    for _bucket, _bs in g.serve_program_keys():
        _geometry = _model_geometry(_bs, _bucket, {})
        register(
            f"serve_predict_{_short}_b{_bucket}_bs{_bs}",
            tags=("serve", "aot"),
            precision="f32" if _short == "fp32" else "any",
            kernels=_sources(_geometry), geometry=_geometry,
            determinism=_MODEL_STANCE,
            description=f"serve predict ({_short}) bucket {_bucket} x batch "
                        f"{_bs}: the replica's "
                        f"{predict_program_name(_bucket, _bs, _dtype)}",
        )(_serve_thunk(_bucket, _bs, _dtype))


# --- the step profiler's ladder (tag "profile") ------------------------------


def _profile_thunk(stage: str):
    def thunk(device, size):
        import torch

        from pvraft_tpu_torch.profiling.step_profiler import ladder_programs
        from pvraft_tpu_torch.rng import torch_seed
        from pvraft_tpu_torch.weights import seeded_state_dict

        cfg = _model_config(size)
        iters = g.FLAGSHIP_ITERS if size == "flagship" else g.TINY_ITERS
        pc1, pc2, mask, gt = _batch(device, g.FLAGSHIP_BATCH, _points(size))
        state = seeded_state_dict(cfg, torch_seed(DEFAULT_SEED, "model.init"))
        rung = dict(ladder_programs(cfg, state, pc1, pc2, mask, gt,
                                    iters))[stage]

        def fn(eps):
            return (rung(eps),)

        fn.state = tuple(getattr(rung, "preserve", ()))
        return fn, (torch.zeros((), device=device),)

    return thunk


for _stage in MEASUREMENTS:
    _kw = {"fused_gru": True} if _stage == "gru_fused" else {}
    _geometry = (_model_geometry(_B, _N, _kw)
                 if _stage not in ("encoder", "corr_cum") else {})
    register(f"profile.{_stage}", tags=("profile",),
             kernels=_sources(_geometry), geometry=_geometry,
             determinism=_MODEL_STANCE,
             description=f"step-profiler ladder rung {_stage!r} "
                         "(profiling/step_profiler.py)")(
        _profile_thunk(_stage))
