"""The port's training launcher, its example and the quickstart's model
section on the CPU, against the reference.

`launch.train.main(..., "--device", "cpu")` runs the reference integration
test's arguments (`tests/integration/test_end_to_end.py`: llama3.2-3b
reduced, 30 steps, batch 8, seq 64, lr 3e-3, a checkpoint every 10 steps):
every step's batch equal to the reference's `global_batch` bit for bit, the
first loss within 2e-3 of the reference's loss on its own initial weights
and that batch (the port draws them with its threefry: the same uniforms,
erfinv within ~1e-5), the loss down by more than 0.3, step 30 committed.
Its first line is the reference's, from the local mesh. Then `--resume`
after step 30's COMMIT is removed: `recover` returns 20,
the run goes on from step 20, the parameters it starts from are step 20's
checkpoint, and step 30 is committed again.
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as r_registry
from repro.data import pipeline as r_pipe
from repro.launch.mesh import make_local_mesh as make_local_mesh_ref
from repro.models import model as r_model
from repro.models import stack as r_stack
from repro.models.schema import init_params as r_init_params
from repro_torch.data import pipeline as t_pipe
from repro_torch.dist.checkpoint import CheckpointManager
from repro_torch.examples import quickstart, train_lm
from repro_torch.launch import train
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARGS = ["--arch", "llama3.2-3b", "--steps", "30", "--batch", "8", "--seq", "64",
        "--lr", "3e-3", "--ckpt-every", "10", "--device", "cpu"]


def _record_batches(monkeypatch):
    seen = []
    real = t_pipe.global_batch

    def recorded(cfg, step, device=None):
        b = real(cfg, step, device)
        seen.append((cfg, step, {k: v.clone() for k, v in b.items()}))
        return b

    monkeypatch.setattr(t_pipe, "global_batch", recorded)
    return seen


def test_launcher_trains_checkpoints_and_resumes(tmp_path, monkeypatch):
    seen = _record_batches(monkeypatch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        losses = train.main(ARGS + ["--ckpt-dir", str(tmp_path)])
    lines = out.getvalue().splitlines()
    # the reference's first line, from the local mesh (one CPU device here)
    r_mesh = make_local_mesh_ref()
    assert lines[0] == (f"[train] arch=llama3.2-3b-reduced devices={len(jax.devices())} "
                        f"mesh={dict(r_mesh.shape)}")
    assert lines[0] == "[train] arch=llama3.2-3b-reduced devices=1 mesh={'data': 1, 'model': 1}"
    assert len(losses) == 30 and losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])
    assert [ln for ln in lines if ln.startswith("[ckpt]")] == [
        f"[ckpt] committed step {s}" for s in (10, 20, 30)]
    assert sum(ln.startswith("step ") for ln in lines) == 4  # steps 0, 10, 20, 29
    cm = CheckpointManager(tmp_path, n_hosts=1)
    assert cm.latest_step() == 30

    # every batch is the reference's
    assert [s for _, s, _ in seen] == list(range(30))
    for cfg, step, b in seen:
        want = r_pipe.global_batch(r_pipe.DataConfig(vocab=cfg.vocab, seq_len=cfg.seq_len,
                                                     global_batch=cfg.global_batch), step)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(b[k].numpy(), np.asarray(want[k]), err_msg=(step, k))

    # the first loss: the reference's on its own initial weights and batch 0
    cfg_r = r_registry.reduced("llama3.2-3b")
    p_r = r_init_params(r_stack.build_schema(cfg_r), jax.random.PRNGKey(0))
    want = float(r_model.loss_fn(cfg_r, p_r, r_pipe.global_batch(
        r_pipe.DataConfig(vocab=cfg_r.vocab, seq_len=64, global_batch=8), 0)))
    assert abs(losses[0] - want) <= 2e-3, (losses[0], want)

    # a crash after step 30's shard, before its commit: resume from step 20
    (tmp_path / "step_00000030" / "COMMIT").unlink()
    restored = {}
    real_restore = CheckpointManager.restore

    def restore(self, step, host, like):
        out = real_restore(self, step, host, like)
        restored[step] = {k: v.clone() for k, v in out.items()}  # training updates out in place
        return out

    monkeypatch.setattr(CheckpointManager, "restore", restore)
    seen.clear()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        resumed = train.main(ARGS + ["--ckpt-dir", str(tmp_path), "--resume"])
    assert "[train] resumed from committed step 20" in out.getvalue().splitlines()
    assert list(restored) == [20] and [s for _, s, _ in seen] == list(range(20, 30))
    assert len(resumed) == 10 and all(np.isfinite(resumed))
    with np.load(tmp_path / "step_00000020" / "shard_0000.npz") as z:
        for name, x in restored[20].items():
            np.testing.assert_array_equal(x.numpy(), z[name])
    assert cm.latest_step() == 30


def test_train_lm_example_runs_the_reduced_100m_config(tmp_path):
    """The example prints the ~100M config's count and trains its reduced
    form (the launcher's `--reduced` is always on, C10)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        losses = train_lm.main(["--steps", "8", "--ckpt-dir", str(tmp_path / "c"),
                                "--device", "cpu"])
    lines = out.getvalue().splitlines()
    assert lines[0] == "params: 100.1M"
    assert lines[1] == "[train] arch=llama3-100m-reduced devices=1 mesh={'data': 1, 'model': 1}"
    assert len(losses) == 8 and losses[-1] < losses[0]
    assert lines[-1] == "OK: loss decreased; checkpoints committed with one-round protocol."


def test_quickstart_model_section_is_a_training_forward():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        logits = quickstart.model_section("cpu")
    assert out.getvalue() == "mixtral-8x7b (reduced) logits: (2, 64, 512)\n"
    assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits.float()).all())


def test_launcher_needs_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"), contextlib.redirect_stdout(io.StringIO()):
        train.main(["--steps", "1"])
