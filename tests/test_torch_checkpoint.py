"""The port's checkpoint store, mirroring ``tests/test_checkpoint.py``'s
native cases on ``tpu_dist_nn_torch.checkpoint`` (``.npz`` files in
place of flax msgpack), on the CPU."""

import json

import numpy as np
import pytest
import torch

from tpu_dist_nn_torch.checkpoint import (
    AsyncCheckpointManager,
    CheckpointManager,
    flush,
    restore_pytree,
    resume_or_init,
    save_pytree,
)
from tpu_dist_nn_torch.data.datasets import synthetic_mnist
from tpu_dist_nn_torch.models.fcnn import init_fcnn
from tpu_dist_nn_torch.train.optimizers import build_optimizer
from tpu_dist_nn_torch.train.trainer import TrainConfig, run_training_loop, train_fcnn
from tpu_dist_nn_torch.utils.errors import InvalidArgumentError

torch.set_num_threads(1)


def _state(seed=0, grad_accum=1):
    params = init_fcnn(torch.Generator().manual_seed(seed), [6, 5, 3], device="cpu")
    wb = [{"w": p["w"], "b": p["b"]} for p in params]
    opt = build_optimizer(1e-3, grad_accum=grad_accum)
    state = opt.init([t for p in wb for t in (p["w"], p["b"])])
    state.count = 7 + seed
    state.mu = [m + seed + 1 for m in state.mu]
    return {"params": wb, "opt_state": state}


def _leaves(state):
    p, o = state["params"], state["opt_state"]
    return ([t for d in p for t in (d["w"], d["b"])] + list(o.mu) + list(o.nu)
            + list(o.acc or []))


def _files(path):
    return sorted(p.name for p in path.glob("ckpt_*.npz"))


@pytest.mark.parametrize("grad_accum", [1, 2], ids=["adam", "multisteps"])
def test_pytree_roundtrip(tmp_path, grad_accum):
    state = _state(grad_accum=grad_accum)
    path = tmp_path / "state.npz"
    save_pytree(state, path)
    template = _state(seed=1, grad_accum=grad_accum)  # other values, same structure
    restored = restore_pytree(template, path)
    assert restored["opt_state"].count == 7 and isinstance(restored["opt_state"].count, int)
    assert restored["opt_state"].mini_step == 0
    assert (restored["opt_state"].acc is None) == (grad_accum == 1)
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_restore_follows_the_template_device_dtype_and_grad():
    # Leaves land as the template's: dtype, device, requires_grad.
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "s.npz"
        save_pytree({"w": torch.arange(4.0), "n": np.arange(3), "k": 5}, path)
        tmpl = {"w": torch.zeros(4, dtype=torch.float64).requires_grad_(True),
                "n": np.zeros(3), "k": 0}
        got = restore_pytree(tmpl, path)
    assert got["w"].dtype == torch.float64 and got["w"].requires_grad
    assert got["w"].tolist() == [0.0, 1.0, 2.0, 3.0]
    np.testing.assert_array_equal(got["n"], np.arange(3))
    assert got["k"] == 5 and isinstance(got["k"], int)


def test_save_is_a_snapshot_of_tensors_updated_later(tmp_path):
    w = torch.ones(3)
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": w})
    w.add_(5.0)  # the trainer updates in place after a save
    assert mgr.restore({"w": torch.zeros(3)})[1]["w"].tolist() == [1.0, 1.0, 1.0]


def test_manager_latest_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    assert mgr.latest_step() is None
    for step in (1, 2, 3):
        mgr.save(step, {"x": np.full((2,), float(step))})
    assert mgr.latest_step() == 3
    assert mgr.steps() == [2, 3]  # step 1 pruned
    assert _files(tmp_path) == ["ckpt_00000002.npz", "ckpt_00000003.npz"]
    step, state = mgr.restore({"x": np.zeros((2,))})
    assert step == 3 and state["x"][0] == 3.0
    with pytest.raises(ValueError, match="keep must be >= 1"):
        CheckpointManager(tmp_path / "k", keep=0)


def test_manager_restore_specific_step_and_missing(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(5, {"x": np.ones(1)})
    step, state = mgr.restore({"x": np.zeros(1)}, step=5)
    assert step == 5 and state["x"][0] == 1.0
    with pytest.raises(FileNotFoundError):
        mgr.restore({"x": np.zeros(1)}, step=9)
    assert CheckpointManager(tmp_path / "empty").restore_or_none({"x": np.zeros(1)}) is None


def test_manifest_records_metadata(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"x": np.zeros(1)}, metadata={"loss": 0.5})
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest == {"metadata": {"1": {"loss": 0.5}}, "latest_step": 1, "steps": [1]}


def test_metadata_pruned_with_checkpoint(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=1)
    mgr.save(1, {"x": np.zeros(1)}, metadata={"loss": 1.0})
    mgr.save(2, {"x": np.zeros(1)}, metadata={"loss": 0.5})
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert "1" not in manifest.get("metadata", {})
    assert manifest["metadata"]["2"]["loss"] == 0.5


def test_save_older_than_retention_window_rejected(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(5, {"x": np.zeros(1)})
    mgr.save(6, {"x": np.zeros(1)})
    with pytest.raises(ValueError, match="retention window"):
        mgr.save(1, {"x": np.zeros(1)})
    assert mgr.steps() == [5, 6]


def test_restore_falls_back_past_missing_newest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, {"x": np.ones(1)})
    mgr.save(2, {"x": np.full((1,), 2.0)})
    (tmp_path / "ckpt_00000002.npz").unlink()
    step, state = mgr.restore({"x": np.zeros(1)})
    assert step == 1 and state["x"][0] == 1.0
    (tmp_path / "ckpt_00000001.npz").unlink()
    with pytest.raises(RuntimeError, match="refusing to restart"):
        mgr.restore({"x": np.zeros(1)})


def test_restore_structure_mismatch_is_explained(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"params": [np.ones(3), np.ones(2)]})
    with pytest.raises(ValueError, match="checkpoint-dir"):
        mgr.restore({"params": [np.ones(3), np.ones(2), np.ones(4)]}, 1)
    with pytest.raises(ValueError, match="leaves not in the template"):
        mgr.restore({"params": [np.ones(3)]}, 1)


def test_resume_or_init_checks_leaf_shapes(tmp_path):
    mgr = CheckpointManager(tmp_path)
    assert resume_or_init(None, {"w": 1}) == (0, {"w": 1})
    assert resume_or_init(mgr, {"w": torch.zeros(2)})[0] == 0
    mgr.save(4, {"w": torch.ones(2)})
    step, state = resume_or_init(mgr, {"w": torch.zeros(2)})
    assert step == 4 and state["w"].tolist() == [1.0, 1.0]
    with pytest.raises(InvalidArgumentError, match=r"leaf shape \(2,\) does not match"):
        resume_or_init(mgr, {"w": torch.zeros(3)})


def test_train_resume_matches_uninterrupted(tmp_path):
    """Train 1 epoch + checkpoint, then resume for 2 more; the result
    must equal a straight 3-epoch run (identical per-epoch shuffles)."""
    data = synthetic_mnist(192, num_classes=4, dim=12, seed=3)
    params0 = init_fcnn(torch.Generator().manual_seed(0), [12, 8, 4], device="cpu")
    full_params, full_hist = train_fcnn(params0, data, TrainConfig(epochs=3, batch_size=32, seed=7))
    mgr = CheckpointManager(tmp_path / "ck")
    train_fcnn(params0, data, TrainConfig(epochs=1, batch_size=32, seed=7), checkpoints=mgr)
    assert mgr.latest_step() == 1
    resumed_params, resumed_hist = train_fcnn(
        params0, data, TrainConfig(epochs=3, batch_size=32, seed=7), checkpoints=mgr)
    assert mgr.latest_step() == 3
    assert [h["epoch"] for h in resumed_hist] == [1, 2]  # epochs 1..2 only re-run
    assert [h["loss"] for h in resumed_hist] == [h["loss"] for h in full_hist[1:]]
    for a, b in zip(full_params, resumed_params):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=1e-6, atol=1e-7)


def test_resume_noop_when_complete(tmp_path):
    data = synthetic_mnist(96, num_classes=4, dim=12, seed=3)
    params0 = init_fcnn(torch.Generator().manual_seed(0), [12, 8, 4], device="cpu")
    mgr = CheckpointManager(tmp_path)
    cfg = TrainConfig(epochs=2, batch_size=32, seed=7)
    trained, _ = train_fcnn(params0, data, cfg, checkpoints=mgr)
    again, hist = train_fcnn(params0, data, cfg, checkpoints=mgr)
    assert hist == []
    assert all(torch.equal(a["w"], b["w"]) for a, b in zip(trained, again))


def test_async_manager_saves_and_restores(tmp_path):
    mgr = AsyncCheckpointManager(tmp_path, keep=2)
    state = {"w": np.arange(6.0).reshape(2, 3)}
    for step in (1, 2, 3):
        mgr.save(step, {"w": state["w"] * step}, metadata={"step": step})
    mgr.wait()
    assert mgr.steps() == [2, 3]  # retention applied in order
    got_step, got = mgr.restore({"w": np.zeros((2, 3))})
    assert got_step == 3
    np.testing.assert_allclose(got["w"], state["w"] * 3)
    mgr.close()
    mgr.close()  # idempotent


def test_async_manager_restore_flushes_pending(tmp_path):
    mgr = AsyncCheckpointManager(tmp_path, keep=3)
    mgr.save(7, {"w": np.ones(4)})
    step, got = mgr.restore({"w": np.zeros(4)})  # no explicit wait
    assert step == 7
    np.testing.assert_allclose(got["w"], np.ones(4))
    mgr.close()


def test_async_manager_surfaces_worker_errors(tmp_path):
    mgr = AsyncCheckpointManager(tmp_path, keep=1)
    mgr.save(5, {"w": np.ones(2)})
    mgr.wait()
    # Out-of-retention fails fast on the caller's thread.
    with pytest.raises(ValueError, match="retention"):
        mgr.save(1, {"w": np.ones(2)})
    boom = RuntimeError("disk on fire")

    def exploding_save_local(step, state, metadata=None):
        raise boom

    mgr._save_local = exploding_save_local
    mgr.save(6, {"w": np.ones(2)})
    with pytest.raises(RuntimeError, match="disk on fire"):
        mgr.wait()
    mgr.wait()  # the error is raised once
    mgr.close()


def test_async_save_after_close_raises(tmp_path):
    mgr = AsyncCheckpointManager(tmp_path)
    mgr.close()
    with pytest.raises(RuntimeError, match="closed"):
        mgr.save(1, {"w": np.ones(2)})


def test_flush_runs_when_training_raises(tmp_path):
    # A save enqueued before the loop dies must still be durable.
    data = synthetic_mnist(64, num_classes=4, dim=12, seed=3)
    params = init_fcnn(torch.Generator().manual_seed(0), [12, 4], device="cpu")
    wb = [{"w": params[0]["w"].clone().requires_grad_(True),
           "b": params[0]["b"].clone().requires_grad_(True)}]
    calls = []

    def step(p, o, x, y):
        calls.append(1)
        if len(calls) > 2:  # dies in epoch 1, after epoch 0's save
            raise RuntimeError("simulated data-pipeline crash")
        return p, o, torch.tensor(1.0)

    mgr = AsyncCheckpointManager(tmp_path, keep=3)
    with pytest.raises(RuntimeError, match="simulated"):
        run_training_loop(step, wb, {"count": 0}, data,
                          TrainConfig(epochs=3, batch_size=32), checkpoints=mgr)
    assert mgr.latest_step() == 1  # the enqueued save landed
    mgr.close()
    flush(None)
    flush(CheckpointManager(tmp_path / "sync"))
