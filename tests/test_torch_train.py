"""The port's LM training path against the JAX package's: loss and
gradients, AdamW and its schedule, the int8 error-feedback compression,
the synthetic data, the train step over 5 steps (plain, microbatched,
compressed), TrainState checkpoints and recovery, the straggler detector,
and the flash entry's refusal of a gradient.

Both sides run the qwen2.5 SMOKE config (2 layers, d_model 128) on the
reference's weights (``convert.lm_params_from_jax``) and the same
``SyntheticLM`` batches, on the CPU, the port on one torch thread.
Tolerances, each with the largest difference measured on this CPU:

* ``loss_fn``: rtol 2e-6 (2.3e-7); gradients atol 5e-7 on leaves whose
  largest entry is 2.6e-3..8.9e-2 (8.5e-8; XLA's dot and reduction orders
  against PyTorch's).
* One ``AdamW.update``: moments bitwise; updates rtol 5e-7 (1.6e-7: a
  few entries of the larger leaf one or two roundings apart); ``gnorm``
  rtol 1e-6 (one float32 rounding: the squares sum in another order).
* ``cosine_schedule`` against the jitted reference: rtol 5e-7 (2.2e-7:
  XLA's ``cos`` and its fused multiply-adds are one or two roundings off
  PyTorch's).
* ``compress_int8``, ``decompress_int8``, ``error_feedback_update``
  against the jitted reference: bitwise (0 of 60,000 entries differ).
* The 5-step train-step loss trajectory: rtol 2e-6 plain and
  microbatched (2.3e-7, 7.6e-8); rtol 2e-4 with int8 compression
  (4.3e-5: a gradient entry one rounding apart can quantize to the next
  int8 level, and error feedback carries the difference on).
* Port against port: microbatching at the reference's own tolerance
  (``tests/test_train.py``: loss rtol 1e-4, params atol 2e-3);
  checkpoint round trips, recovery and remat bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.data import SyntheticLM as RefSyntheticLM
from repro.models import init_params as ref_init
from repro.models import loss_fn as ref_loss
from repro.optim import AdamW as RefAdamW
from repro.optim import compress_int8 as ref_compress
from repro.optim import cosine_schedule as ref_cosine
from repro.optim import decompress_int8 as ref_decompress
from repro.optim import error_feedback_update as ref_feedback
from repro.optim.adamw import AdamWState as RefAdamWState
from repro.train import StragglerDetector as RefStragglerDetector
from repro.train import make_train_step as ref_make_train_step
from repro.train.train_step import init_train_state as ref_init_state
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM, make_global_batch
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import forward, init_params, loss_fn
from repro_torch.models import transformer as tf
from repro_torch.optim import (AdamW, AdamWState, compress_int8,
                               cosine_schedule, decompress_int8,
                               error_feedback_update)
from repro_torch.train import (FaultConfig, StragglerDetector, TrainState,
                               init_train_state, latest_step,
                               make_train_step, restore_checkpoint,
                               save_checkpoint, simulate_failures)
from repro_torch.train.fault import InjectedFailure, run_with_recovery

SEQ, BATCH = 32, 8


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


@pytest.fixture(scope="module")
def lm():
    rc = ref_config("qwen2.5-14b", smoke=True)
    pc = get_config("qwen2.5-14b", smoke=True)
    rp = jax.tree.map(np.asarray, ref_init(jax.random.PRNGKey(0), rc))
    return rc, pc, rp


def port_params(rp, pc):
    return convert.lm_params_from_jax(rp, pc, "cpu")


def batches(cfg, n, seq=SEQ, batch=BATCH, seed=0):
    ref = RefSyntheticLM(vocab=cfg.vocab, seq=seq, global_batch=batch,
                         seed=seed)
    port = SyntheticLM(vocab=cfg.vocab, seq=seq, global_batch=batch,
                       seed=seed)
    return ([ref.batch_at(i) for i in range(n)],
            [port.batch_at(i, "cpu") for i in range(n)])


def grads_of(params, batch, cfg):
    names, leaves = zip(*dict(params.named_parameters()).items())
    loss = loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(names, grads))


def assert_tree_close(ref_tree, port_tree, **tol):
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    port_leaves = jax.tree.leaves(port_tree)
    assert len(ref_flat) == len(port_leaves)
    for (path, a), b in zip(ref_flat, port_leaves):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32),
                                   err_msg=jax.tree_util.keystr(path), **tol)


# ---------------------------------------------------------------------------
# the model: trainable parameters, loss, gradients, remat
# ---------------------------------------------------------------------------


def test_parameters_are_trainable(lm):
    _, pc, rp = lm
    p = init_params(0, pc, "cpu")
    assert all(t.requires_grad for t in p.parameters())
    assert all(t.requires_grad for t in port_params(rp, pc).parameters())


@pytest.mark.parametrize("layout", ["smoke", "pattern_with_tail"])
def test_loss_and_gradients_match_reference(lm, layout):
    """``loss_fn`` and every gradient leaf against
    ``jax.value_and_grad(repro.models.loss_fn)``; "pattern_with_tail" is a
    3-layer ("attn", "local") stack: one rematerialized repeat and an
    unrolled tail, through ``lm_tree_to_jax_layout``'s scan and tail."""
    rc, pc, rp = lm
    if layout == "pattern_with_tail":
        kw = dict(n_layers=3, block_pattern=("attn", "local"), window=8)
        rc, pc = (dataclasses.replace(c, **kw) for c in (rc, pc))
        rp = jax.tree.map(np.asarray, ref_init(jax.random.PRNGKey(3), rc))
    (rb,), (pb,) = batches(rc, 1)
    want_loss, want_grads = jax.jit(jax.value_and_grad(ref_loss),
                                    static_argnums=2)(rp, rb, rc)
    loss, grads = grads_of(port_params(rp, pc), pb, pc)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=2e-6)
    got = convert.lm_tree_to_jax_layout(grads, pc)
    assert (jax.tree.structure(got)
            == jax.tree.structure(jax.tree.map(np.asarray, want_grads)))
    assert_tree_close(want_grads, got, atol=5e-7, rtol=0)


def test_labels_below_zero_carry_no_loss(lm):
    rc, pc, rp = lm
    (rb,), (pb,) = batches(rc, 1)
    labels = np.asarray(rb["labels"]).copy()
    labels[:, ::3] = -1
    labels[1] = -100
    want = ref_loss(rp, {"tokens": rb["tokens"],
                         "labels": jnp.asarray(labels)}, rc)
    params = port_params(rp, pc)
    masked = {"tokens": pb["tokens"], "labels": torch.from_numpy(labels)}
    got = loss_fn(params, masked, pc)
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-6)
    # the masked positions do not enter: the loss over the kept ones only
    logits, _ = forward(params, pb, pc)
    keep = torch.from_numpy(labels >= 0)
    nll = torch.nn.functional.cross_entropy(
        logits[keep], torch.from_numpy(labels)[keep].long())
    np.testing.assert_allclose(got.item(), nll.item(), rtol=1e-6)
    none = {"tokens": pb["tokens"], "labels": torch.full_like(pb["labels"],
                                                              -1)}
    assert loss_fn(params, none, pc).item() == 0.0


def test_remat_recomputes_each_repeat_with_equal_gradients(lm, monkeypatch):
    """With ``cfg.remat`` each whole pattern repeat runs under
    ``torch.utils.checkpoint`` and the tail does not; the gradients are
    bitwise those of the run without remat, and nothing is checkpointed
    with grad off."""
    _, pc, rp = lm
    kw = dict(n_layers=5, block_pattern=("attn", "local"), window=8)
    cfg = dataclasses.replace(pc, **kw)
    params = init_params(1, cfg, "cpu")
    (_, ), (pb,) = batches(cfg, 1)
    calls = []
    real = tf.checkpoint
    monkeypatch.setattr(tf, "checkpoint", lambda fn, blocks, *a, **k: (
        calls.append(len(blocks)), real(fn, blocks, *a, **k))[1])
    loss_r, g_r = grads_of(params, pb, cfg)
    assert calls == [2, 2]
    loss_p, g_p = grads_of(params, pb, dataclasses.replace(cfg, remat=False))
    assert calls == [2, 2]
    assert torch.equal(loss_r, loss_p)
    assert all(torch.equal(g_r[k], g_p[k]) for k in g_r)
    with torch.no_grad():
        loss_fn(params, pb, cfg)
    assert calls == [2, 2]


# ---------------------------------------------------------------------------
# the flash entry refuses a gradient (the reference cannot differentiate it)
# ---------------------------------------------------------------------------


def test_flash_entry_refuses_a_gradient(lm):
    _, pc, _ = lm
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((1, 4, 8, 16), (1, 2, 8, 16), (1, 2, 8, 16)))
    want = flash_attention(q, k, v)        # nothing requires grad: runs
    for i in range(3):
        args = [q, k, v]
        args[i] = args[i].clone().requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            flash_attention(*args)
        with torch.no_grad():
            assert torch.equal(flash_attention(*args), want)
        with torch.inference_mode():
            assert torch.equal(flash_attention(*args), want)
    # through the model: trainable parameters and attention_impl="pallas"
    cfg = dataclasses.replace(pc, attention_impl="pallas")
    params = init_params(0, cfg, "cpu")
    (_, ), (pb,) = batches(cfg, 1)
    with pytest.raises(RuntimeError, match="no backward"):
        loss_fn(params, pb, cfg)
    chunked = dataclasses.replace(cfg, attention_impl="chunked")
    with torch.inference_mode():
        a, _ = forward(params, pb, cfg)
        b, _ = forward(params, pb, chunked)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# optimizer and schedule
# ---------------------------------------------------------------------------

SHAPES = {"a": (64, 33), "b": (7,), "c": (5, 4, 3)}


@pytest.mark.parametrize("case", ["float32", "bfloat16", "clipped", "step5"])
def test_adamw_update_matches_reference(case):
    rng = np.random.default_rng(0)
    tree = lambda s: {k: rng.normal(0, s, sh).astype(np.float32)  # noqa: E731
                      for k, sh in SHAPES.items()}
    p, g = tree(1.0), tree(3.0 if case == "clipped" else 0.01)
    m0, v0 = tree(0.01), {k: np.abs(x) for k, x in tree(1e-4).items()}
    step = 4 if case == "step5" else 0
    sd, td = ((jnp.bfloat16, torch.bfloat16) if case == "bfloat16"
              else (jnp.float32, torch.float32))
    ref = RefAdamW(lr=ref_cosine(1e-3, 3, 20), state_dtype=sd)
    port = AdamW(lr=cosine_schedule(1e-3, 3, 20), state_dtype=td)
    rs = RefAdamWState(step=jnp.int32(step),
                       m={k: jnp.asarray(x, sd) for k, x in m0.items()},
                       v={k: jnp.asarray(x, sd) for k, x in v0.items()})
    ps = AdamWState(step=torch.tensor(step, dtype=torch.int32),
                    m={k: torch.from_numpy(x).to(td) for k, x in m0.items()},
                    v={k: torch.from_numpy(x).to(td) for k, x in v0.items()})
    ru, rs, rgn = ref.update({k: jnp.asarray(x) for k, x in g.items()}, rs,
                             {k: jnp.asarray(x) for k, x in p.items()})
    t = lambda d: {k: torch.from_numpy(x) for k, x in d.items()}  # noqa: E731
    pu, ps, pgn = port.update(t(g), ps, t(p))
    assert int(ps.step) == int(rs.step) == step + 1
    np.testing.assert_allclose(float(pgn), float(rgn), rtol=1e-6)
    if case == "clipped":
        assert float(rgn) > port.grad_clip
    for k in SHAPES:
        for a, b in ((rs.m[k], ps.m[k]), (rs.v[k], ps.v[k])):
            assert b.dtype == td
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          b.float().numpy())
        np.testing.assert_allclose(pu[k].numpy(), np.asarray(ru[k]),
                                   rtol=5e-7, atol=0)
    new = AdamW.apply_updates({k: torch.tensor(x) for k, x in p.items()}, pu)
    for k in SHAPES:
        np.testing.assert_array_equal(new[k].numpy(), p[k] + pu[k].numpy())


def test_cosine_schedule_matches_reference():
    """Warm-up, the cosine decay and past its end, against the jitted
    reference (the train step runs it under jit)."""
    for base, warm, total in ((3e-3, 5, 60), (1e-3, 10, 100), (3e-4, 0, 7)):
        ref = jax.jit(ref_cosine(base, warm, total))
        port = cosine_schedule(base, warm, total)
        steps = [0, 1, warm // 2, warm, (warm + total) // 2, total - 1,
                 total, total + 5]
        for s in steps:
            got = port(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(float(got), float(ref(jnp.int32(s))),
                                       rtol=5e-7, err_msg=f"step {s}")
        assert float(port(total + 5)) == pytest.approx(0.1 * base, rel=1e-6)


# ---------------------------------------------------------------------------
# int8 compression with error feedback
# ---------------------------------------------------------------------------


def test_int8_compression_matches_reference_bitwise():
    """``q``, ``scale``, the decompressed values and the residual equal the
    jitted reference's (the train step's) bit for bit, over magnitudes
    1e-6..1e2 and with values on the half-way points of the int8 grid."""
    rng = np.random.default_rng(1)
    jc, jd, je = (jax.jit(f) for f in (ref_compress, ref_decompress,
                                       ref_feedback))
    for trial in range(100):
        x = rng.normal(0, 10 ** rng.uniform(-6, 2), (300,)).astype(np.float32)
        if trial % 2:
            # amax 127: scale f32(1/127) * 127, and halves of it
            x[:6] = np.float32(127) * np.array(
                [1, 0.5, -1.5, 2.5, -3.5, 0.25], np.float32) / np.float32(127)
            x[6] = 127
        r = rng.normal(0, 10 ** rng.uniform(-8, 0), (300,)).astype(np.float32)
        q_ref, s_ref = jc(jnp.asarray(x))
        q, s = compress_int8(torch.from_numpy(x))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
        assert np.float32(s) == np.float32(s_ref)
        np.testing.assert_array_equal(decompress_int8(q, s).numpy(),
                                      np.asarray(jd(q_ref, s_ref)))
        gh_ref, res_ref = je(jnp.asarray(x), jnp.asarray(r))
        gh, res = error_feedback_update(torch.from_numpy(x),
                                        torch.from_numpy(r))
        np.testing.assert_array_equal(gh.numpy(), np.asarray(gh_ref))
        np.testing.assert_array_equal(res.numpy(), np.asarray(res_ref))


def test_int8_halves_round_to_even():
    x = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5])
    q, s = compress_int8(x)
    assert float(s) == float(np.float32(127) * np.float32(1 / 127))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, 126]


def test_error_feedback_accumulates():
    """As ``tests/test_train.py``'s: the sum of what is sent plus the last
    residual is the sum of the true gradients."""
    rng = np.random.default_rng(1)
    true = [torch.from_numpy(rng.normal(0, 1e-4, (64,)).astype(np.float32))
            for _ in range(50)]
    residual = torch.zeros(64)
    sent = torch.zeros(64)
    for g in true:
        g_hat, residual = error_feedback_update(g, residual)
        sent = sent + g_hat
    total = sum(true)
    np.testing.assert_allclose((sent + residual).numpy(), total.numpy(),
                               atol=1e-6)
    assert float(sent.abs().sum()) > 0.1 * float(total.abs().sum())


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_synthetic_tokens_equal_reference():
    for seed, step, vocab, seq, batch in ((0, 0, 512, 32, 8),
                                          (5, 7, 97, 16, 4),
                                          (3, 1000, 152064, 24, 3),
                                          (11, 2, 50, 1, 2)):
        ref = RefSyntheticLM(vocab=vocab, seq=seq, global_batch=batch,
                             seed=seed).batch_at(step)
        got = SyntheticLM(vocab=vocab, seq=seq, global_batch=batch,
                          seed=seed).batch_at(step, "cpu")
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    cfg = get_config("qwen2.5-14b", smoke=True)
    cell = {"seq": 16, "batch": 4}
    a = make_global_batch(cfg, cell, 3, seed=2, device="cpu")
    b = SyntheticLM(cfg.vocab, 16, 4, 2).batch_at(3, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def run_port(pc, rp, pbs, microbatches=1, compress=False, opt=None):
    opt = opt or AdamW(lr=cosine_schedule(3e-3, 2, 5))
    state = init_train_state(port_params(rp, pc), opt, compress=compress)
    step = make_train_step(pc, opt, microbatches=microbatches,
                           compress_grads=compress)
    metrics = []
    for b in pbs:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.mark.parametrize("microbatches,compress,rtol",
                         [(1, False, 2e-6), (4, False, 2e-6),
                          (1, True, 2e-4)])
def test_train_step_trajectory_matches_reference(lm, microbatches, compress,
                                                 rtol):
    rc, pc, rp = lm
    rbs, pbs = batches(rc, 5)
    ref_opt = RefAdamW(lr=ref_cosine(3e-3, 2, 5))
    rs = ref_init_state(jax.tree.map(jnp.asarray, rp), ref_opt,
                        compress=compress)
    ref_step = jax.jit(ref_make_train_step(rc, ref_opt, microbatches,
                                           compress))
    want = []
    for b in rbs:
        rs, m = ref_step(rs, b)
        want.append({k: float(v) for k, v in m.items()})
    state, got = run_port(pc, rp, pbs, microbatches, compress)
    np.testing.assert_allclose([m["loss"] for m in got],
                               [m["loss"] for m in want], rtol=rtol)
    np.testing.assert_allclose([m["grad_norm"] for m in got],
                               [m["grad_norm"] for m in want],
                               rtol=100 * rtol)
    np.testing.assert_allclose([m["lr"] for m in got],
                               [m["lr"] for m in want], rtol=5e-7)
    assert int(state.opt.step) == 5
    assert (state.residual is not None) == compress


def test_microbatching_matches_full_batch(lm):
    """As ``tests/test_train.py``'s, on the port: 4 microbatches against
    one batch, loss rtol 1e-4 and updated params atol 2e-3."""
    _, pc, rp = lm
    _, (pb,) = batches(pc, 1)
    opt = AdamW(lr=1e-3)
    s1, m1 = run_port(pc, rp, [pb], 1, opt=opt)
    s4, m4 = run_port(pc, rp, [pb], 4, opt=opt)
    np.testing.assert_allclose(m4[0]["loss"], m1[0]["loss"], rtol=1e-4)
    for a, b in zip(s1.params.parameters(), s4.params.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=2e-3)


# ---------------------------------------------------------------------------
# checkpoints and fault tolerance
# ---------------------------------------------------------------------------


def states_equal(a: TrainState, b: TrainState) -> bool:
    pa = dict(a.params.named_parameters())
    pb = dict(b.params.named_parameters())
    return (pa.keys() == pb.keys()
            and all(torch.equal(pa[k], pb[k]) for k in pa)
            and torch.equal(a.opt.step, b.opt.step)
            and all(torch.equal(a.opt.m[k], b.opt.m[k])
                    and torch.equal(a.opt.v[k], b.opt.v[k]) for k in pa)
            and (a.residual is None) == (b.residual is None)
            and (a.residual is None
                 or all(torch.equal(a.residual[k], b.residual[k])
                        for k in pa)))


@pytest.mark.parametrize("compress", [False, True])
def test_train_state_checkpoint_round_trips(lm, tmp_path, compress):
    """Params, m, v, step (and residuals) restore bitwise into a fresh
    state, and training continues identically."""
    _, pc, rp = lm
    _, pbs = batches(pc, 4)
    opt = AdamW(lr=cosine_schedule(3e-3, 2, 5), state_dtype=torch.bfloat16)
    state = init_train_state(port_params(rp, pc), opt, compress=compress)
    step = make_train_step(pc, opt, compress_grads=compress)
    for b in pbs[:3]:
        state, _ = step(state, b)
    h = save_checkpoint(str(tmp_path), 3, state, metadata={"arch": pc.name},
                        async_save=True)
    h.join()
    assert latest_step(str(tmp_path)) == 3
    fresh = init_train_state(init_params(9, pc, "cpu"), opt,
                             compress=compress)
    restored, meta = restore_checkpoint(str(tmp_path), 3, fresh)
    assert meta["arch"] == pc.name and restored.params is fresh.params
    assert states_equal(restored, state)
    assert all(p.requires_grad for p in restored.params.parameters())
    a, ma = step(state, pbs[3])
    b, mb = step(restored, pbs[3])
    assert float(ma["loss"]) == float(mb["loss"])
    assert states_equal(a, b)


def test_restore_rejects_dtype_mismatch(lm, tmp_path):
    """Moments saved in bfloat16 do not restore into a float32 state, and
    a module's parameters are left untouched by a refused restore."""
    _, pc, rp = lm
    state = init_train_state(port_params(rp, pc),
                             AdamW(state_dtype=torch.bfloat16))
    save_checkpoint(str(tmp_path), 1, state)
    target = init_train_state(init_params(4, pc, "cpu"), AdamW())
    before = [p.detach().clone() for p in target.params.parameters()]
    with pytest.raises(ValueError, match="dtype mismatch"):
        restore_checkpoint(str(tmp_path), 1, target)
    other = init_train_state(init_params(4, dataclasses.replace(
        pc, d_ff=128), "cpu"), AdamW())
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), 1, other)
    assert all(torch.equal(a, b) for a, b in
               zip(before, target.params.parameters()))


def test_recovery_restarts_to_the_uninterrupted_state(lm, tmp_path):
    """``run_with_recovery``: a failure injected at step 7 after a
    checkpoint at step 5; the restarted run ends bitwise equal to the
    uninterrupted one."""
    _, pc, rp = lm
    _, pbs = batches(pc, 10, seq=16, batch=4)
    opt = AdamW(lr=cosine_schedule(3e-3, 3, 10))
    step = make_train_step(pc, opt)
    whole = init_train_state(port_params(rp, pc), opt)
    for b in pbs:
        whole, _ = step(whole, b)

    ckpt, attempts, final = str(tmp_path), [], {}
    faults = FaultConfig(fail_at_steps=(7,))

    def attempt(resume):
        attempts.append(resume)
        state, start = init_train_state(port_params(rp, pc), opt), 0
        if resume is not None:
            state, _ = restore_checkpoint(ckpt, resume, state)
            start = resume
        for i in range(start, len(pbs)):
            if resume is None:
                simulate_failures(i, faults)
            state, _ = step(state, pbs[i])
            if i + 1 == 5:
                save_checkpoint(ckpt, 5, state)
        final["state"] = state
        return len(pbs)

    assert run_with_recovery(attempt, max_restarts=2,
                             checkpoint_dir=ckpt) == 10
    assert attempts == [None, 5]
    assert states_equal(final["state"], whole)
    with pytest.raises(InjectedFailure):
        run_with_recovery(lambda r: simulate_failures(7, faults),
                          max_restarts=0)


def test_straggler_detector_flags_the_reference_steps():
    rng = np.random.default_rng(0)
    times = 0.1 + rng.normal(0, 0.002, 200)
    times[[50, 80, 81, 150]] = [0.5, 0.3, 0.12, 0.2]
    for window, z in ((16, 3.0), (32, 2.0), (8, 5.0)):
        ref, port = RefStragglerDetector(window, z), StragglerDetector(window,
                                                                      z)
        assert [ref.observe(i, t) for i, t in enumerate(times)] == [
            port.observe(i, t) for i, t in enumerate(times)]
        assert ref.flagged == port.flagged and list(ref.times) == list(
            port.times)
    assert [s for s, _, _ in port.flagged][:1] == [50]
