"""The port's ``parallel/`` and ``launch/mesh.py`` against the JAX
package's, on the CPU.

* ``param_axes`` / ``abstract_params`` of all ten configs (``CONFIG`` and
  ``SMOKE``): every leaf's logical axes, shape and dtype equal to the
  reference's tree through ``convert``'s name map, the reference's leading
  ``"layers"`` axis of a scanned stack removed; the abstract values on the
  ``meta`` device.
* The sharding specs and ``fallbacks`` of every leaf of those configs on
  meshes (16, 16), (2, 16, 16), (2, 2) and (2, 2, 2), equal to the
  reference's ``logical_to_spec`` on a stand-in mesh (the rules read only
  ``axis_names`` and ``devices.shape``); a subprocess with 8 XLA host
  devices checks that the reference's ``make_param_shardings`` on real
  (2, 2) and (2, 2, 2) meshes gives those same specs, and records
  ``NamedSharding.devices_indices_map`` of every (shape, spec) pair,
  which ``shard_index`` must equal at every mesh coordinate.
* Four ``gloo`` CPU ranks (tests/torch_parallel_ranks.py, job
  "parallel"): ``compressed_psum`` on (pod 2, data 2) bitwise equal to
  the reference's under ``shard_map`` (a subprocess with 4 XLA host
  devices); ``pipeline_apply`` over 4 stages bitwise equal to
  ``pipeline_apply_emulated``, which holds at atol 1e-5 (the reference's
  own test's tolerance) against the reference's; a phi3 SMOKE block a
  stage, bitwise the blocks run in sequence; ``shard_of`` / ``gather``
  round trips.
* ``shard_act`` is the identity; the policy context manager restores.
"""

import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_parallel_ranks as R
from repro.configs import all_arch_names
from repro.configs import get_config as ref_config
from repro.models import model as ref_model
from repro.models.param import split_tree
from repro.parallel import sharding as ref_sharding
from repro.parallel.pipeline import pipeline_apply_emulated as ref_pipeline
from repro_torch.configs import get_config
from repro_torch.launch import mesh as M
from repro_torch.models import abstract_params, param_axes, param_specs
from repro_torch.parallel import act
from repro_torch.parallel import sharding as S
from repro_torch.parallel.pipeline import pipeline_apply_emulated

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ARCHS = all_arch_names()
SIZES = [True, False]
SIZE_IDS = ["SMOKE", "CONFIG"]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture(autouse=True)
def one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


class StandIn:
    """What the reference's rules read of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


@functools.lru_cache(maxsize=None)
def ref_tree(arch: str, smoke: bool):
    cfg = ref_config(arch, smoke=smoke)
    tree = jax.eval_shape(functools.partial(ref_model._init, cfg=cfg),
                          jax.random.PRNGKey(0))
    vals, axes = split_tree(tree)
    return cfg, vals, axes


@functools.lru_cache(maxsize=None)
def port_tree(arch: str, smoke: bool):
    return param_specs(get_config(arch, smoke=smoke))


def ref_leaf(tree, name: str, cfg):
    """The reference's leaf for the port's parameter ``name``, and
    whether it is stacked on a leading layer axis (``convert``'s map:
    stack layer i is repeat i // P of pattern position i % P, then the
    tail; the enc-dec stacks are whole)."""
    path = name.split(".")
    if path[0] == "stack":
        i, rest = int(path[1]), path[2:]
        pat = len(cfg.block_pattern)
        n_rep = cfg.n_layers // pat
        if i < n_rep * pat:
            node, stacked = tree["stack"]["scan"][i % pat], True
        else:
            node, stacked = tree["stack"]["tail"][i - n_rep * pat], False
    elif path[0] in ("encoder", "decoder"):
        node, rest, stacked = tree[path[0]], path[2:], True
    else:
        node, rest, stacked = tree, path, False
    for k in rest:
        node = node[k]
    return node, stacked


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def ref_leaf_count(cfg, vals) -> int:
    """The reference's leaves, a stacked one counted once a layer."""
    n = 0
    for path, v in jax.tree_util.tree_flatten_with_path(vals)[0]:
        top = path[0].key
        stacked = (top in ("encoder", "decoder") or
                   (top == "stack" and path[1].key == "scan"))
        n += v.shape[0] if stacked else 1
    return n


@pytest.mark.parametrize("smoke", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_axes_match_reference(arch, smoke):
    rc, vals, axes = ref_tree(arch, smoke)
    abstract, port_axes = port_tree(arch, smoke)
    assert list(abstract) == list(port_axes)
    assert len(port_axes) == ref_leaf_count(rc, vals)
    for name, ax in port_axes.items():
        want, stacked = ref_leaf(axes, name, rc)
        v, _ = ref_leaf(vals, name, rc)
        assert _is_axes(want), name
        if stacked:
            assert want[0] == "layers", name
            want, shape = want[1:], v.shape[1:]
        else:
            shape = v.shape
        assert ax == tuple(want), name
        t = abstract[name]
        assert t.device.type == "meta" and tuple(t.shape) == tuple(shape)
        assert str(t.dtype).split(".")[-1] == str(v.dtype), name
    # the two entry points agree with param_specs
    assert param_axes(get_config(arch, smoke=smoke)) == port_axes
    assert list(abstract_params(get_config(arch, smoke=smoke))) == list(
        abstract)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("smoke", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_and_fallbacks_match_reference(arch, smoke, mesh):
    shape, names = MESHES[mesh]
    rc, vals, axes = ref_tree(arch, smoke)
    abstract, port_axes = port_tree(arch, smoke)
    standin = StandIn(shape, names)
    rules = ref_sharding.solve_rules(standin)
    layout = M.mesh_layout(shape, names)
    assert S.solve_rules(layout).rules == rules.rules
    specs, fallbacks = S.make_param_shardings(layout, port_axes, abstract)
    want_fallbacks = []
    for name in port_axes:
        ax, stacked = ref_leaf(axes, name, rc)
        v, _ = ref_leaf(vals, name, rc)
        fb = []
        want = tuple(ref_sharding.logical_to_spec(
            tuple(ax), standin, rules, tuple(v.shape), fb))
        if stacked:
            assert want[:1] in ((), (None,)), name
            want = want[1:]
        assert tuple(specs[name]) == want, name
        assert isinstance(specs[name], S.Spec)
        want_fallbacks += fb
    assert fallbacks == want_fallbacks


def test_phi3_embed_on_the_production_mesh():
    """phi3's ``embed`` on the (16, 16) production mesh is ('model',
    'data'), and no dim of phi3 falls back to replication there."""
    abstract, axes = port_tree("phi3-medium-14b", False)
    specs, fallbacks = S.make_param_shardings(M.make_production_mesh(),
                                              axes, abstract)
    assert tuple(specs["embed"]) == ("model", "data")
    assert fallbacks == []
    multi = M.make_production_mesh(multi_pod=True)
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.shape == (2, 16, 16) and multi.rank is None


def test_batch_spec_and_data_axis_size_match_reference():
    for shape, names in MESHES.values():
        standin, layout = StandIn(shape, names), M.mesh_layout(shape, names)
        for ndim in (1, 2, 3):
            for div in (True, False):
                assert tuple(S.batch_spec(layout, ndim, div)) == tuple(
                    ref_sharding.batch_spec(standin, ndim, div))
        assert S.data_axis_size(layout) == ref_sharding.data_axis_size(
            standin)


# ---------------------------------------------------------------------------
# the shard layout against NamedSharding on real meshes (8 host devices)
# ---------------------------------------------------------------------------

LAYOUT_SCRIPT = textwrap.dedent("""
    import os, sys, json, functools
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, "src")
    import jax
    import numpy as np
    from repro.configs import all_arch_names, get_config
    from repro.launch.mesh import make_host_mesh
    from repro.models import model as M
    from repro.models.param import split_tree
    from repro.parallel.sharding import (logical_to_spec,
                                         make_param_shardings, solve_rules)

    def js(spec):
        return [list(e) if isinstance(e, tuple) else e for e in spec]

    out = {}
    for name, mesh in (("2x2", make_host_mesh(2, 2)),
                       ("2x2x2", make_host_mesh(2, 2, pod=2))):
        coords = {d.id: [int(c) for c in np.argwhere(mesh.devices == d)[0]]
                  for d in mesh.devices.flat}
        rules = solve_rules(mesh)
        per_arch = {}
        for arch in all_arch_names():
            pairs = {}
            for smoke in (True, False):
                cfg = get_config(arch, smoke=smoke)
                vals, axes = split_tree(jax.eval_shape(
                    functools.partial(M._init, cfg=cfg),
                    jax.random.PRNGKey(0)))
                sh, fb = make_param_shardings(mesh, axes, vals)
                is_ax = lambda x: isinstance(x, tuple) and len(x) > 0 and all(
                    isinstance(a, (str, type(None))) for a in x)
                flat_a = jax.tree.leaves(axes, is_leaf=is_ax)
                flat_v = jax.tree.leaves(vals)
                flat_s = jax.tree.leaves(sh)
                assert len(flat_a) == len(flat_v) == len(flat_s)
                fb2 = []
                for a, v, s in zip(flat_a, flat_v, flat_s):
                    want = logical_to_spec(a, mesh, rules, v.shape, fb2)
                    assert tuple(s.spec) == tuple(want), (arch, a)
                    key = json.dumps([list(v.shape), js(s.spec)])
                    if key in pairs:
                        continue
                    idx = s.devices_indices_map(v.shape)
                    pairs[key] = [
                        [coords[d.id], [list(sl.indices(n))[:2]
                                        for sl, n in zip(ix, v.shape)]]
                        for d, ix in idx.items()]
                assert fb2 == fb, arch
            per_arch[arch] = pairs
        out[name] = {"axes": list(mesh.axis_names), "pairs": per_arch}
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
    print("LAYOUT_OK")
""")


def _run_jax(script: str, out_path: str, timeout: int = 600):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "-c", script, out_path],
                       capture_output=True, text=True, timeout=timeout,
                       env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(out_path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    return _run_jax(LAYOUT_SCRIPT,
                    str(tmp_path_factory.mktemp("layout") / "out.json"))


def _spec(js_spec) -> S.Spec:
    return S.Spec(*[tuple(e) if isinstance(e, list) else e
                    for e in js_spec])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", ["2x2", "2x2x2"])
def test_shard_layout_matches_named_sharding(layouts, mesh, arch):
    """shard_index at every mesh coordinate equals the reference's
    ``devices_indices_map`` for the device there, for every (shape, spec)
    pair of the config's leaves (SMOKE and CONFIG), real meshes."""
    shape, names = MESHES[mesh]
    got = layouts[mesh]
    assert tuple(got["axes"]) == names
    layout = M.mesh_layout(shape, names)
    pairs = got["pairs"][arch]
    assert pairs
    for key, per_device in pairs.items():
        leaf_shape, js_spec = json.loads(key)
        spec = _spec(js_spec)
        assert len(per_device) == layout.size
        for coords, slices in per_device:
            idx = S.shard_index(leaf_shape, spec, layout,
                                dict(zip(names, coords)))
            assert [[s.start, s.stop] for s in idx] == slices, (key, coords)


def test_shard_of_splits_tuple_axes_major_to_minor():
    layout = M.mesh_layout((2, 2, 2), ("pod", "data", "model"))
    x = torch.arange(8 * 4).reshape(8, 4)
    spec = S.Spec(("pod", "data"), "model")
    blocks = {}
    for p in range(2):
        for d in range(2):
            for m in range(2):
                c = {"pod": p, "data": d, "model": m}
                blocks[(p, d, m)] = S.shard_of(x, spec, layout, c)
    assert torch.equal(blocks[(0, 1, 0)], x[2:4, 0:2])
    assert torch.equal(blocks[(1, 0, 1)], x[4:6, 2:4])
    with pytest.raises(ValueError, match="divide"):
        S.shard_index((6, 6), S.Spec("model", ("pod", "data")), layout,
                      {"pod": 0, "data": 0, "model": 0})


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


def test_host_mesh_raises_without_the_ranks(monkeypatch):
    """As the reference's make_host_mesh raises without the devices (the
    training CLI then runs unsharded): a MeshSizeError, which is a
    ValueError."""
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(M.MeshSizeError, match="need 4 ranks") as e:
        M.make_host_mesh(data=2, model=2, devices=["cpu"] * 4)
    assert (e.value.need, e.value.have) == (4, 1)
    with pytest.raises(ValueError, match="need 8 ranks"):
        M.make_host_mesh(data=2, model=2, pod=2)
    one = M.make_host_mesh(data=1, model=1, devices=["cpu"])
    assert one.size == 1 and one.rank == 0 and one.device.type == "cpu"
    x = torch.arange(6.0)
    assert torch.equal(one.all_reduce(x, "data"), x)
    (got,) = one.all_gather(x, ("data", "model"))
    assert torch.equal(got, x) and got is not x


def test_a_rank_without_a_card_raises(monkeypatch):
    """No rank falls back to the CPU: without ``devices`` a rank needs a
    card, and nccl refuses ranks that would share a device."""
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            M.make_host_mesh(data=1, model=1)
    with pytest.raises(RuntimeError, match="nccl"):
        M.make_host_mesh(data=1, model=1, backend="nccl", devices=["cpu"])


def test_mesh_layout_coordinates():
    m = M.Mesh(("pod", "data", "model"), (2, 2, 2), rank=5)
    assert m.coords == {"pod": 1, "data": 0, "model": 1}
    assert m.axis_index(("pod", "data")) == 2
    assert m.group_ranks("model") == [4, 5]
    assert m.group_ranks(("pod", "data")) == [1, 3, 5, 7]
    assert m.devices.shape == (2, 2, 2)
    with pytest.raises(ValueError, match="no rank"):
        M.mesh_layout((2,), ("stage",)).coords


def test_flat_mesh_is_the_core_mesh(monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="no process group"):
        M.make_flat_mesh(2, devices=["cpu", "cpu"], backend="gloo")


# ---------------------------------------------------------------------------
# activation policy
# ---------------------------------------------------------------------------


def test_shard_act_is_the_identity_and_policy_restores():
    x = torch.ones(2, 3, 4)
    act.clear_policy()
    with act.policy({"residual": ("data", None, None)}):
        assert act.get_policy() == {"residual": ("data", None, None)}
        assert act.shard_act(x, "residual") is x
    assert act.get_policy() == {}
    act.set_policy({"logits": (None,)})
    assert act.shard_act(x, "logits") is x
    act.clear_policy()
    assert act.get_policy() == {}


# ---------------------------------------------------------------------------
# the pipeline, emulated
# ---------------------------------------------------------------------------


def test_pipeline_matches_reference_emulated():
    ws, xs = R.tanh_inputs()
    got = pipeline_apply_emulated(R.tanh_stage, ws, xs, n_stages=R.S)
    want = ref_pipeline(lambda w, x: jax.numpy.tanh(x @ w),
                        jax.numpy.asarray(ws.numpy()),
                        jax.numpy.asarray(xs.numpy()), n_stages=R.S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    seq = xs
    for s in range(R.S):
        seq = torch.tanh(seq @ ws[s])
    assert torch.equal(got, seq)


def test_pipeline_bubble_accounting():
    """M + S - 1 ticks: outputs for every microbatch, in order (the
    reference's test), and stage_fn runs S x (M + S - 1) times."""
    S_, M_, d = 3, 5, 4
    ws = torch.stack([torch.eye(d) * (i + 1) for i in range(S_)])
    xs = torch.arange(M_ * d, dtype=torch.float32).reshape(M_, d)
    calls = []

    def fn(w, x):
        calls.append(1)
        return x @ w
    out = pipeline_apply_emulated(fn, ws, xs, n_stages=S_)
    np.testing.assert_allclose(out.numpy(), (xs * 6.0).numpy(), atol=1e-5)
    assert len(calls) == S_ * (M_ + S_ - 1)
    want = ref_pipeline(lambda w, x: x @ w, jax.numpy.asarray(ws.numpy()),
                        jax.numpy.asarray(xs.numpy()), n_stages=S_)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)


def test_pipeline_takes_a_dict_of_stacked_leaves():
    ws, xs = R.tanh_inputs()
    got = pipeline_apply_emulated(lambda p, x: torch.tanh(x @ p["w"]) + p["b"],
                                  {"w": ws, "b": torch.zeros(R.S, R.D_TANH)},
                                  xs, n_stages=R.S)
    assert torch.equal(got, pipeline_apply_emulated(R.tanh_stage, ws, xs,
                                                    n_stages=R.S))


# ---------------------------------------------------------------------------
# four gloo ranks
# ---------------------------------------------------------------------------

PSUM_SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    sys.path.insert(0, "tests")
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    import torch_parallel_ranks as R
    from repro.optim.compress import compressed_psum
    mesh = jax.make_mesh((2, 2), ("pod", "data"))
    out = {}
    for case, ax in R.PSUM_CASES.items():
        x = np.concatenate([R.psum_input(case, r) for r in range(4)])
        f = shard_map(lambda v: compressed_psum(v, pod_axis="pod",
                                                data_axis=ax),
                      mesh=mesh, in_specs=P(("pod", "data")),
                      out_specs=P(("pod", "data")), check_rep=False)
        y = np.asarray(jax.jit(f)(jnp.asarray(x)))
        out[case] = y.view(np.uint32).reshape(4, -1).tolist()
    with open(sys.argv[1], "w") as fh:
        json.dump(out, fh)
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel")
    ctx = mp.start_processes(R.run_rank, args=("parallel", str(work)),
                             nprocs=4, join=False, start_method="spawn")
    ref = _run_jax(PSUM_SCRIPT, str(work / "psum.json"))
    while not ctx.join(timeout=300):
        pass
    got = [torch.load(work / f"rank{r}.pt", weights_only=False)
           for r in range(4)]
    return dict(ranks=got, psum=ref)


@pytest.mark.parametrize("case", list(R.PSUM_CASES))
def test_compressed_psum_bitwise_reference(ranks, case):
    """Each rank's result equals the reference's block of the same
    (pod, data) coordinates, bit for bit (float32 sum over data, int8
    across pods)."""
    want = np.asarray(ranks["psum"][case], np.uint32)
    for r, out in enumerate(ranks["ranks"]):
        c = out["coords"]
        got = out["psum"][case]
        assert got.dtype == torch.float32 and tuple(got.shape) == \
            R.PSUM_SHAPE
        blk = c["pod"] * 2 + c["data"]
        assert np.array_equal(got.numpy().view(np.uint32).reshape(-1),
                              want[blk]), (case, r)
    if case != "pod_only":
        # every rank holds the same total
        firsts = [o["psum"][case] for o in ranks["ranks"]]
        assert all(torch.equal(firsts[0], f) for f in firsts)


def test_compressed_psum_is_close_to_the_float_sum(ranks):
    total = sum(torch.from_numpy(R.psum_input("data_then_pod", r))
                for r in range(4))
    got = ranks["ranks"][0]["psum"]["data_then_pod"]
    amax = float(total.abs().max())
    assert float((got - total).abs().max()) <= amax / 127


def test_real_pipeline_equals_emulated_bitwise(ranks):
    ws, xs = R.tanh_inputs()
    want = pipeline_apply_emulated(R.tanh_stage, ws, xs, n_stages=R.S)
    for out in ranks["ranks"]:
        assert torch.equal(out["pipe_tanh"], want)


def test_block_pipeline_equals_the_blocks_in_sequence(ranks):
    """A phi3 SMOKE block a stage: the real pipeline (on every rank), the
    emulated one and the four blocks applied in sequence, bitwise."""
    cfg, blocks, xs = R.block_stages()
    fn = R.block_stage_fn(cfg)
    with torch.no_grad():
        emu = pipeline_apply_emulated(fn, blocks, xs, n_stages=R.S)
        seq = []
        for x in xs:
            for b in blocks:
                x = fn(b, x)
            seq.append(x)
    assert torch.equal(emu, torch.stack(seq))
    for out in ranks["ranks"]:
        assert torch.equal(out["pipe_block"], emu)


def test_shard_gather_round_trips(ranks):
    layout = M.mesh_layout((2, 2), ("data", "model"))
    gen = torch.Generator().manual_seed(11)
    full = torch.randn((8, 12, 6), generator=gen)
    for out in ranks["ranks"]:
        for key, (mine, whole_ok) in out["trips"].items():
            assert whole_ok, key
            spec = eval(key, {"Spec": S.Spec})
            want = full[S.shard_index(full.shape, spec, layout,
                                      out["mesh_coords"])]
            assert torch.equal(mine, want), key
