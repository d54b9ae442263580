"""The port's data parallelism (``u2mkd_tpu_torch/parallel/mesh.py``)
against the JAX package's, on the CPU.

The port's ranks are processes of ``tests/torch_dp_worker.py``, two gloo
ranks on a free port, each with a timeout; the JAX side runs ``shard_map``
over two of conftest's eight virtual CPU devices (``mesh.make_mesh(2)``),
one scan a device. Compared, on the same weights and scans:

* the synced ``MaskedBatchNorm`` and ``BatchNorm2d``: outputs, running
  statistics and the gradients of the input, scale and bias (the port's
  scale and bias gradients summed over the ranks, as JAX's ``shard_map``
  sums a replicated input's);
* the conv-only SPVCNN's data-parallel train step (the loss and the updated
  state, to the tolerances of ``tests/test_torch_train.py``) and eval step
  (counters and predictions equal);
* ``use_data_parallel`` and each rank's sample order against JAX's, with
  ``jax.device_count`` / ``process_index`` / ``process_count`` patched;
* ``--multihost`` without a coordinator.

The stage-2 step and the CLI in two processes are in
``tests/test_torch_parallel_train.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as PS

from u2mkd_tpu.data import loaders as jax_loaders
from u2mkd_tpu.data import plumbing_host as jax_plumbing_host
from u2mkd_tpu.data import synthetic as jax_synthetic
from u2mkd_tpu.models import blocks as jax_blocks
from u2mkd_tpu.models import swiftnet as jax_swiftnet
from u2mkd_tpu.models.plumbing import from_precomputed as jax_from_precomputed
from u2mkd_tpu.models.spvcnn import SPVCNN as JaxSPVCNN
from u2mkd_tpu.parallel import mesh as jax_mesh
from u2mkd_tpu.train import optim as jax_optim
from u2mkd_tpu.train import state as jax_state

import chip_smoke
import torch_dp_worker
from test_torch_distill import LOSS_RTOL, UPDATE_RTOL
from test_torch_model import _random_variables
from test_torch_student_eval import NCLS
from u2mkd_tpu_torch.data import loaders, plumbing_host
from u2mkd_tpu_torch.models import convert_weights
from u2mkd_tpu_torch.parallel import mesh
from u2mkd_tpu_torch.utils import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
RANK_TIMEOUT_S = 240
CAPS = (256, 128, 64, 32, 16)
LR = 0.05
# a BN layer's outputs, statistics and gradients: the same sums in another
# order (each rank's partial sums, then their sum)
BN_RTOL = 1e-5
STAT_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _ranks(task, args, tmp_path):
    """``task`` of tests/torch_dp_worker.py in WORLD gloo ranks -> each
    rank's outputs."""
    return torch_dp_worker.spawn(task, args, tmp_path, WORLD, timeout=RANK_TIMEOUT_S)


def _close(name, got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(np.abs(ref).max(), 1e-30),
                               err_msg=name)


def test_synced_batchnorms_match_jax_shard_map(tmp_path):
    """``MaskedBatchNorm`` and ``BatchNorm2d`` with a process group against
    JAX's with ``axis_name`` under ``shard_map``: outputs, running
    statistics, and the gradients of sum(y * cotangent)."""
    rng = np.random.RandomState(0)
    c, v = 6, 40
    x = (rng.randn(WORLD, v, c) * 2 + 0.5).astype(np.float32)
    mask = rng.rand(WORLD, v) < 0.7
    g = rng.randn(WORLD, v, c).astype(np.float32)
    img = (rng.randn(2 * WORLD, c, 5, 7) + 1.0).astype(np.float32)
    gimg = rng.randn(2 * WORLD, c, 5, 7).astype(np.float32)
    args = {"x": x, "mask": mask, "g": g, "img": img, "gimg": gimg}
    for name in ("masked", "image"):
        args[f"{name}_scale"] = (1 + 0.1 * rng.randn(c)).astype(np.float32)
        args[f"{name}_bias"] = (0.1 * rng.randn(c)).astype(np.float32)
    got = _ranks("bn", args, tmp_path)

    m2 = jax_mesh.make_mesh(WORLD)
    stats0 = {"mean": jnp.zeros(c), "var": jnp.ones(c)}
    cases = {"masked": (jax_blocks.MaskedBatchNorm(c, axis_name=jax_mesh.DATA_AXIS),
                        (jnp.asarray(x), jnp.asarray(mask)), jnp.asarray(g)),
             "image": (jax_swiftnet.BatchNorm2d(c, axis_name=jax_mesh.DATA_AXIS),
                       (jnp.asarray(img.transpose(0, 2, 3, 1)),),
                       jnp.asarray(gimg.transpose(0, 2, 3, 1)))}
    for name, (bn, inputs, cot) in cases.items():
        params = {"scale": jnp.asarray(args[f"{name}_scale"]),
                  "bias": jnp.asarray(args[f"{name}_bias"])}

        def local(params, x, *rest, bn=bn):
            *extra, gl = rest
            y, mut = bn.apply({"params": params, "batch_stats": stats0}, x, *extra, True,
                              mutable=["batch_stats"])
            return y, mut["batch_stats"], jnp.sum(y * gl)[None]

        n_in = len(inputs)
        fn = shard_map(local, mesh=m2, in_specs=(PS(),) + (PS(jax_mesh.DATA_AXIS),) * (n_in + 1),
                       out_specs=(PS(jax_mesh.DATA_AXIS), PS(), PS(jax_mesh.DATA_AXIS)),
                       check_rep=False)
        y, stats, _ = fn(params, *inputs, cot)
        dparams, dx = jax.grad(lambda p, xx: fn(p, xx, *inputs[1:], cot)[2].sum(),
                               argnums=(0, 1))(params, inputs[0])
        ports = [r[name] for r in got]
        to_jax = (lambda a: a) if name == "masked" else (lambda a: a.transpose(0, 2, 3, 1))
        _close(f"{name} y", to_jax(np.concatenate([p["y"] for p in ports])), y, BN_RTOL)
        _close(f"{name} dx", to_jax(np.concatenate([p["dx"] for p in ports])), dx, BN_RTOL)
        _close(f"{name} dscale", sum(p["dscale"] for p in ports), dparams["scale"], BN_RTOL)
        _close(f"{name} dbias", sum(p["dbias"] for p in ports), dparams["bias"], BN_RTOL)
        for p in ports:
            _close(f"{name} mean", p["mean"], stats["mean"], STAT_RTOL)
            _close(f"{name} var", p["var"], stats["var"], STAT_RTOL)


def _teacher_scans():
    raws = [jax_synthetic.make_batch(np.random.RandomState(s), 1, 250, voxel_size=0.3)
            for s in (3, 4)]
    jax_pls = []
    for raw in raws:
        pl = jax_plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], CAPS)
        jax_pls.append({k: v for k, v in pl.items() if not k.startswith("cr27")})
    batch_j = jax.tree_util.tree_map(jnp.asarray, chip_smoke.concat_scans(raws))
    batch_j["plumbing"] = jax.tree_util.tree_map(jnp.asarray, chip_smoke.concat_scans(jax_pls))
    ports = [dict(raw, plumbing=plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"],
                                                             raw["pmask"], CAPS))
             for raw in raws]
    return batch_j, ports


def test_teacher_dp_step_and_eval_match_jax(tmp_path):
    """The conv-only SPVCNN (cr 0.25, P=250 a scan, one scan a rank): the
    port's two-rank eval step and train step against JAX's
    ``data_parallel_eval`` / ``data_parallel_step`` on the same weights:
    counters and predictions equal, the loss to LOSS_RTOL, the updated
    state's change to UPDATE_RTOL; the two ranks' states bitwise equal."""
    batch_j, ports = _teacher_scans()
    model = JaxSPVCNN(num_classes=NCLS, cr=0.25, dropout_rate=0.0)
    model_dp = JaxSPVCNN(num_classes=NCLS, cr=0.25, dropout_rate=0.0,
                         axis_name=jax_mesh.DATA_AXIS)
    abstract = jax.eval_shape(
        lambda f, a: model.init(jax.random.PRNGKey(0), f[:1],
                                jax_from_precomputed(jax.tree_util.tree_map(
                                    lambda t: t[:1], a), batch_j["pmask"][:1]), False),
        batch_j["feats"], batch_j["plumbing"])
    variables = _random_variables(abstract, 7)
    tx = jax_optim.make_optimizer("sgd", LR)
    st = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]))
    m2 = jax_mesh.make_mesh(WORLD)
    ev = jax_mesh.data_parallel_eval(jax_state.make_eval_step(
        model_dp, CAPS, NCLS, axis_name=jax_mesh.DATA_AXIS), m2)
    step = jax_mesh.data_parallel_step(jax_state.make_train_step(
        model_dp, tx, CAPS, axis_name=jax_mesh.DATA_AXIS), m2)
    res = ev(st, batch_j)
    st1, aux = step(st, batch_j, jax.random.PRNGKey(1))

    start = {k: v.numpy() for k, v in convert_weights.from_flax(
        variables["params"], variables["batch_stats"]).items()}
    got = _ranks("teacher", {"caps": CAPS, "ncls": NCLS, "lr": LR, "state": start,
                             "batches": ports}, tmp_path)
    for r in got:
        for k in ("seen", "correct", "positive"):
            np.testing.assert_array_equal(r["counts"][k], np.asarray(res["counts"][k]), k)
    np.testing.assert_array_equal(np.concatenate([r["pred"] for r in got]),
                                  np.asarray(res["pred"]))
    np.testing.assert_allclose(got[0]["loss"], float(aux["loss"]), rtol=LOSS_RTOL)
    ref = convert_weights.from_flax(jax.tree_util.tree_map(np.asarray, st1.params),
                                    jax.tree_util.tree_map(np.asarray, st1.batch_stats))
    assert sorted(ref) == sorted(got[0]["state"])
    for name, t in ref.items():
        p_ref, p_got = t.numpy(), got[0]["state"][name]
        atol = (UPDATE_RTOL * np.abs(p_ref - start[name]).max()
                + 2 * np.spacing(np.abs(p_ref).max().astype(np.float32)))
        np.testing.assert_allclose(p_got, p_ref, rtol=0, atol=atol, err_msg=name)
        np.testing.assert_array_equal(got[1]["state"][name], p_got, name)


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_use_data_parallel_matches_jax(monkeypatch, world):
    """The port's predicate is JAX's with one device a process, over batch
    sizes 1-8."""
    cfg = config.load("configs/synthetic/train/spformer_tiny.yaml")
    monkeypatch.setattr(jax, "device_count", lambda: world)
    monkeypatch.setattr(mesh, "world_size", lambda group=None: world)
    for b in range(1, 9):
        cfg.batch_size = b
        assert mesh.use_data_parallel(cfg) == jax_mesh.use_data_parallel(cfg), (world, b)


def test_jax_predicate_quirk_turns_batch_3_off_at_world_2(monkeypatch):
    """A deviation of the JAX package kept by the port: the predicate tests
    each process's own batch against the global device count, so the
    configs' batch 3 (``spformer.yaml``) at two processes of one device is
    not data parallel though each process could run its 3 scans, and the
    port refuses such a run rather than run it unsynced."""
    cfg = config.load("configs/nuscenes/train/spformer.yaml")
    assert cfg.batch_size == 3
    monkeypatch.setattr(jax, "device_count", lambda: 2)
    monkeypatch.setattr(mesh, "world_size", lambda group=None: 2)
    assert not jax_mesh.use_data_parallel(cfg)
    assert not mesh.use_data_parallel(cfg)
    with pytest.raises(ValueError, match="not data parallel"):
        loaders.dp_shard_count(cfg)
    cfg.batch_size = 4
    assert loaders.dp_shard_count(cfg) == 1


@pytest.mark.parametrize("world", [2, 3])
def test_rank_order_matches_jax(monkeypatch, world):
    """Each rank's samples over two shuffled epochs: the port's
    ``order[rank::world][:n // world]`` is JAX's ``process_shard`` slice."""
    n, batch = 23, 2
    ds = list(range(n))

    def collate(items):
        return {"idx": np.asarray(items)}

    for rank in range(world):
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(mesh, "process_index", lambda group=None: rank)
        monkeypatch.setattr(mesh, "world_size", lambda group=None: world)
        rng_j, rng_p = np.random.RandomState(0), np.random.RandomState(0)
        for _ in range(2):
            want = [b["idx"] for b in jax_loaders._epoch_iter(
                ds, batch, collate, True, rng_j, lambda b: b, process_shard=True)]
            got = [b["idx"] for b in loaders._epoch_iter(ds, batch, collate, True, rng_p,
                                                          shard=True)]
            assert len(got) == (n // world) // batch
            np.testing.assert_array_equal(np.concatenate(got), np.concatenate(want))


def test_multihost_without_coordinator_raises(monkeypatch, tmp_path):
    """``--multihost`` with no coordinator and no launcher environment
    fails before it trains."""
    from u2mkd_tpu_torch import train_spformer

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="no coordinator"):
        train_spformer.main(["configs/synthetic/train/spformer_tiny.yaml", "--run-dir",
                             str(tmp_path / "run"), "--multihost", "--cpu"])
    assert not (tmp_path / "run").exists()


def test_host_local_keys_stay_on_the_host():
    """``device_batch`` drops what JAX's drops; ``shard_host_batch`` (the
    rank's upload) keeps the host-local metadata on the host and uploads the
    rest; ``local_data`` is the rank's own block as numpy."""
    raw = jax_synthetic.make_batch(np.random.RandomState(0), 1, 64, voxel_size=0.3)
    batch = dict(raw, infos=[{"inverse_map": np.arange(3)}], lidar_tokens=["t0"])
    assert sorted(mesh.device_batch(batch)) == sorted(jax_mesh.device_batch(batch))
    up = mesh.shard_host_batch(batch, torch.device("cpu"))
    assert torch.is_tensor(up["feats"]) and up["lidar_tokens"] == ["t0"]
    assert isinstance(up["infos"][0]["inverse_map"], np.ndarray)
    np.testing.assert_array_equal(mesh.local_data(up["feats"]), raw["feats"])
