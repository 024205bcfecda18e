"""The export to the reference's key names against the JAX package's.

On the same weights (the port's seeded ones, as flax trees through
``params_to_jax``), the port's ``export_torch_state_dict`` equals the JAX
``export_torch_state_dict`` key for key and bitwise, stage 1 and stage
2; the CLI ``python -m pvraft_tpu_torch.export`` writes a ``.params``
file that both packages' ``load_torch_checkpoint`` read back bitwise,
on the cases of ``tests/test_export_checkpoint.py``: the round trip with
its epoch, the epochless payload's sentinel, ``--refine`` on a stage-1
checkpoint.
"""

import numpy as np
import pytest
import torch

from pvraft_tpu.engine import checkpoint as jckpt
from pvraft_tpu_torch import export as texport
from pvraft_tpu_torch.config import ModelConfig
from pvraft_tpu_torch.engine import checkpoint as tckpt
from pvraft_tpu_torch.engine import msgpack
from pvraft_tpu_torch.weights import params_to_jax, seeded_state_dict

TINY = ModelConfig(truncate_k=16, corr_knn=8, graph_k=4)


def _state(refine):
    return seeded_state_dict(TINY, 3, refine=refine)


def _tree_equal(got, want, path=""):
    assert set(got) == set(want), f"{path}: {sorted(got)} != {sorted(want)}"
    for k, w in want.items():
        if isinstance(w, dict):
            _tree_equal(got[k], w, f"{path}/{k}")
        else:
            g = np.asarray(got[k])
            assert g.dtype == np.asarray(w).dtype, f"{path}/{k}"
            np.testing.assert_array_equal(g, np.asarray(w),
                                          err_msg=f"{path}/{k}")


@pytest.mark.parametrize("refine", [False, True], ids=["stage1", "stage2"])
def test_export_equals_jax_key_for_key_and_bitwise(refine):
    state = _state(refine)
    tree = params_to_jax(state)["params"]
    got = tckpt.export_torch_state_dict(tree, refine=refine)
    want = jckpt.export_torch_state_dict(tree, refine=refine)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert np.array_equal(got[k], w), k
    assert any(k.startswith("refine_block.") for k in got) == refine
    # The wrapper on the port's own state_dict, and the variables dict.
    wrapped = tckpt.export_state_dict(state)
    assert list(wrapped) == list(want)
    assert all(np.array_equal(wrapped[k], w) for k, w in want.items())
    assert list(tckpt.export_torch_state_dict(
        {"params": tree}, refine=refine)) == list(want)


def _saved(tmp_path, refine, epoch=7):
    state = _state(refine)
    tckpt.save_checkpoint(str(tmp_path / "ckpts"), params_to_jax(state),
                          opt_state={}, epoch=epoch, checkpoint_interval=0)
    return state, str(tmp_path / "ckpts" / "last_checkpoint.msgpack")


@pytest.mark.parametrize("refine", [False, True], ids=["stage1", "stage2"])
def test_cli_round_trips_through_both_packages(tmp_path, refine, capsys):
    state, src = _saved(tmp_path, refine)
    dst = str(tmp_path / "out" / "exported.params")
    assert texport.main([src, dst] + (["--refine"] if refine else [])) == 0
    assert "epoch 7" in capsys.readouterr().out
    payload = torch.load(dst, map_location="cpu", weights_only=True)
    assert set(payload) == {"epoch", "state_dict"} and payload["epoch"] == 7
    # The JAX reader gives back the very tree the checkpoint holds.
    jtree, jepoch = jckpt.load_torch_checkpoint(dst, refine=refine)
    assert jepoch == 7
    _tree_equal(jtree, params_to_jax(state)["params"])
    # The port's reader gives back the very state_dict.
    tstate, tepoch = tckpt.load_torch_checkpoint(dst, refine=refine)
    assert tepoch == 7 and list(tstate) == sorted(state)
    for k, v in state.items():
        assert torch.equal(tstate[k], v), k
    # Stage 2 is detected without the flag.
    if refine:
        again = str(tmp_path / "again.params")
        texport.main([src, again])
        sd = torch.load(again, map_location="cpu", weights_only=True)
        assert any(k.startswith("refine_block.") for k in sd["state_dict"])


def test_epochless_payload_yields_sentinel(tmp_path, capsys):
    """A payload without an epoch reads as -1 in both packages, both
    payload shapes (the full variables dict and the bare tree), and the
    CLI writes that sentinel."""
    inner = {"dense": {"kernel": np.zeros((2, 2), np.float32)}}
    for payload in ({"params": {"params": inner}}, {"params": inner}):
        src = tmp_path / "bare.msgpack"
        src.write_bytes(msgpack.packb(payload))
        for load_params in (tckpt.load_params, jckpt.load_params):
            variables, epoch = load_params(str(src))
            assert epoch == -1 and set(variables) == {"params"}
            np.testing.assert_array_equal(
                np.asarray(variables["params"]["dense"]["kernel"]),
                inner["dense"]["kernel"])
    tree = params_to_jax(_state(False))
    src = tmp_path / "model.msgpack"
    src.write_bytes(msgpack.packb({"params": tree}))
    dst = str(tmp_path / "model.params")
    assert texport.main([str(src), dst]) == 0
    assert "epoch -1" in capsys.readouterr().out
    assert torch.load(dst, weights_only=True)["epoch"] == -1


def test_export_refine_flag_rejects_stage1(tmp_path):
    _, src = _saved(tmp_path, refine=False, epoch=0)
    dst = tmp_path / "out.params"
    with pytest.raises(SystemExit) as e:
        texport.main([src, str(dst), "--refine"])
    assert e.value.code not in (0, None) and "backbone" in str(e.value.code)
    assert not dst.exists()
