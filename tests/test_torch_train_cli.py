"""The port's training CLI, ``repro_torch.launch.train``, driven in process
through ``main(argv)`` on the CPU.

A run with an injected failure and periodic checkpoints recovers and ends
bitwise equal to the uninterrupted run of the API (same weights, schedule
and batches); its final loss agrees with the reference's
``repro.launch.train`` run on the same weights (the port's, carried over
with ``convert.lm_tree_to_jax_layout``) at the trajectory tolerance of
``tests/test_torch_train.py``, rtol 2e-6 (measured: 0, the same float32
loss after 12 steps).

The reference runs its unsharded path, the one it takes on a host without
the mesh's devices (``make_host_mesh`` raising), which is the port's.  On
a host where the 1 x 1 mesh builds, the reference's ``run`` fails in
``jax.device_put``: its optimizer-state shardings hold ``None`` for the
step, which flattens to no leaf, so the leaves and shardings misalign.
"""

import ast
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as ref_train
from repro.train.checkpoint import read_checkpoint_arrays as ref_read
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.launch import train
from repro_torch.models import init_params
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.train import (init_train_state, make_train_step,
                               read_checkpoint_arrays, restore_checkpoint)
from repro_torch.train.checkpoint import flatten

STEPS, BATCH, SEQ, LR, WARMUP, SEED = 12, 4, 16, 1e-3, 3, 0
FLAGS = ["--arch", "qwen2.5-14b", "--smoke", "--steps", str(STEPS),
         "--batch", str(BATCH), "--seq", str(SEQ), "--lr", str(LR),
         "--warmup", str(WARMUP), "--seed", str(SEED), "--log-every", "1"]


@pytest.fixture(autouse=True)
def pin_prng_mode():
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def api_run(cfg):
    opt = AdamW(lr=cosine_schedule(LR, WARMUP, STEPS))
    state = init_train_state(init_params(SEED, cfg, "cpu"), opt)
    step = make_train_step(cfg, opt)
    ds = SyntheticLM(vocab=cfg.vocab, seq=SEQ, global_batch=BATCH, seed=SEED)
    for i in range(STEPS):
        state, metrics = step(state, ds.batch_at(i, "cpu"))
    return state, opt, float(metrics["loss"])


def test_recovered_cli_run_equals_the_uninterrupted_api_run(tmp_path,
                                                           capsys,
                                                           monkeypatch):
    cfg = get_config("qwen2.5-14b", smoke=True)
    ckpt = str(tmp_path / "port")
    train.main(FLAGS + ["--ckpt-dir", ckpt, "--ckpt-every", "4",
                        "--fail-at", "6", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert "[train] resumed from step 4" in out
    assert out[-1] == f"[train] done at step {STEPS}"
    # steps 4 and 5 ran twice: before the failure and after the resume
    logged = [line.split()[2] for line in out if " loss " in line]
    assert logged == [str(i) for i in [*range(6), *range(4, STEPS)]]

    want, opt, want_loss = api_run(cfg)
    template = init_train_state(init_params(SEED + 1, cfg, "cpu"), opt)
    got, meta = restore_checkpoint(ckpt, STEPS, template)
    a, b = flatten(got), flatten(want)
    assert a.keys() == b.keys() and len(a) == 3 * 27 + 1
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert meta == {"arch": "qwen2.5-14b", "loss": want_loss}

    # the reference's launch/train.py on the same weights and flags
    params = convert.lm_tree_to_jax_layout(init_params(SEED, cfg, "cpu"),
                                           cfg)
    monkeypatch.setattr(ref_train, "init_params", lambda key, c: jax.tree.map(
        jnp.asarray, params))

    def no_mesh(**kw):
        raise ValueError("no devices for the mesh")
    monkeypatch.setattr(ref_train, "make_host_mesh", no_mesh)
    ref_ckpt = str(tmp_path / "ref")
    monkeypatch.setattr(sys, "argv", ["train"] + FLAGS + [
        "--ckpt-dir", ref_ckpt, "--ckpt-every", "4", "--fail-at", "6"])
    ref_train.main()
    assert capsys.readouterr().out.splitlines()[-1] == (
        f"[train] done at step {STEPS}")
    ref_loss = ref_read(ref_ckpt, STEPS)[1]["loss"]
    np.testing.assert_allclose(read_checkpoint_arrays(ckpt, STEPS)[1]["loss"],
                               ref_loss, rtol=2e-6)


def test_injected_straggler_is_flagged(capsys):
    train.main(FLAGS + ["--straggle-at", "10", "--log-every", "100",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[train] STRAGGLER step 10:" in out
    flagged = next(line for line in out.splitlines()
                   if line.startswith("[train] stragglers flagged:"))
    assert 10 in ast.literal_eval(flagged.split(":", 1)[1].strip())


def test_help_says_the_port_runs_unsharded():
    text = " ".join(train.parser().format_help().split())
    assert "unsharded on one device" in text
    for flag in ("--data", "--model", "--ckpt-every", "--resume",
                 "--fail-at", "--straggle-at", "--z-threshold",
                 "--max-restarts", "--microbatches", "--device"):
        assert flag in text
