"""The port's config loader and builder against the JAX package's, on the
CPU: the recursive YAML configs with dotted overrides, the models each
config names (their parameter and buffer names and shapes against the
weight bridge of the JAX model's variables), the learning-rate sequence of
each schedule against optax's, and the synthetic loaders' scans.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2mkd_tpu.data import plumbing_host as jax_plumbing_host
from u2mkd_tpu.data import synthetic as jax_synthetic
from u2mkd_tpu.models.plumbing import from_precomputed as jax_from_precomputed
from u2mkd_tpu.train import builder as jax_builder
from u2mkd_tpu.utils import config as jax_config

from test_torch_model import _random_variables
from u2mkd_tpu_torch.models import convert_weights
from u2mkd_tpu_torch.train import builder
from u2mkd_tpu_torch.utils import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))
OPTS = ["model.cr=0.5", "data.training_size=8", "new.key.path=[1, 2]", "optimizer.lr=1e-3",
        "flag=true", "name=abc"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """At most two CPU threads per test process: the tier-1 run shares the
    machine's cores among several workers, and more threads each only
    contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_config_load_matches_jax(path):
    """``load`` (every default.yaml from the root down, deep-merged under the
    file) and ``update_dotted`` give the JAX module's nested dicts."""
    got, want = config.load(path), jax_config.load(path)
    assert got == want
    assert config.update_dotted(got, OPTS) == jax_config.update_dotted(want, OPTS)
    assert got.get_path("new.key.path") == [1, 2] and got.get_path("missing.key", 7) == 7
    with pytest.raises(ValueError):
        config.update_dotted(got, ["no_equals_sign"])


def _synthetic(name, *opts):
    cfg = config.load(os.path.join(REPO, "configs", "synthetic", "train", name))
    return config.update_dotted(cfg, list(opts))


def _jax_variables(name):
    """Random variables of the JAX model of synthetic config ``name``,
    initialized on a small synthetic scan with host plumbing."""
    cfg = jax_config.load(os.path.join(REPO, "configs", "synthetic", "train", name))
    model = jax_builder.make_model(cfg)
    rng = np.random.RandomState(0)

    def batch(raw, caps):
        pl = jax_plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], caps)
        out = {k: jnp.asarray(v) for k, v in raw.items()}
        out["plumbing"] = jax.tree_util.tree_map(
            jnp.asarray, {k: v for k, v in pl.items() if not k.startswith("cr27")})
        return out

    if cfg.model.name == "spvcnn_spformer":
        b = batch(jax_synthetic.make_batch(rng, 1, 256, voxel_size=0.3), tuple(cfg.capacities))
        abstract = jax.eval_shape(
            lambda x: model.init(jax.random.PRNGKey(0), x["feats"],
                                 jax_from_precomputed(x["plumbing"], x["pmask"]), False), b)
    else:
        raw = jax_synthetic.make_multimodal_batch(rng, 1, 256, 384, voxel_size=0.3,
                                                  num_cams=2, im_hw=(32, 48))
        # the parameters do not depend on the capacities; the reference's
        # host plumbing crashes on the teacher's (768, ..., 192, ...) (ROADMAP
        # section 3), so both take the student's
        sb = batch(raw["student"], tuple(cfg.student_capacities))
        tb = batch(raw["teacher"], tuple(cfg.student_capacities))
        abstract = jax.eval_shape(
            lambda s, t: model.init(jax.random.PRNGKey(0), s,
                                    jax_from_precomputed(s["plumbing"], s["pmask"]), t,
                                    jax_from_precomputed(t["plumbing"], t["pmask"]), False, True),
            sb, tb)
    return _random_variables(abstract, 0)


@pytest.mark.parametrize("name", ["spformer_tiny.yaml", "tsd_tiny.yaml"])
def test_make_model_matches_jax_tree(name):
    """``make_model`` builds, for each synthetic config, the model whose
    state dict has the names and shapes the weight bridge gives for the JAX
    model of that config, and loads its bridged weights strictly; the same
    seed gives the same weights."""
    cfg = _synthetic(name)
    variables = _jax_variables(name)
    want = convert_weights.from_flax(variables["params"], variables["batch_stats"])
    model = builder.make_model(cfg, "cpu", seed=3)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, t in want.items():
        assert tuple(got[k].shape) == tuple(t.shape), k
    model.load_state_dict(want)
    again = builder.make_model(cfg, "cpu", seed=3).state_dict()
    other = builder.make_model(cfg, "cpu", seed=4).state_dict()
    fresh = builder.make_model(cfg, "cpu", seed=3).state_dict()
    assert all(torch.equal(again[k], fresh[k]) for k in again)
    assert not all(torch.equal(again[k], other[k]) for k in again)
    ws, wss, qs, qss = builder.window_geometry(cfg)
    assert (ws, wss, qs, qss) == jax_builder.window_geometry(cfg)
    sub = model if name == "spformer_tiny.yaml" else model.model_s
    assert sub.window_size == ws and sub.quant_size_sphere == qss


def test_make_model_rejects_what_the_port_lacks(monkeypatch):
    """A model name the JAX package's builder lacks too raises; every model
    name the builder serves builds under ``precision=bfloat16``, which sets
    the bf16 policy, and an unknown precision raises ``KeyError`` as the JAX
    builder's does; multi-process loading that is not data parallel (batch 3
    at two processes) raises; the synthetic loaders refuse a real dataset,
    which ``make_loaders`` sends to ``data/loaders.py``."""
    from u2mkd_tpu.ops import precision as jax_precision
    from u2mkd_tpu_torch.ops import precision

    cfg = _synthetic("spformer_tiny.yaml", "model.name=spvcnn_swiftnet18")
    with pytest.raises(NotImplementedError, match="no such model"):
        builder.make_model(cfg, "cpu")
    with pytest.raises(NotImplementedError):
        jax_builder.make_model(cfg)
    try:
        for name, opts in (("spformer_tiny.yaml", ["model.name=spvcnn"]),
                           ("spformer_tiny.yaml", []), ("tsd_tiny.yaml", [])):
            builder.make_model(_synthetic(name, "precision=bfloat16", *opts), "cpu")
            assert precision.compute_dtype() == torch.bfloat16
        bad = _synthetic("spformer_tiny.yaml", "precision=float16")
        with pytest.raises(KeyError):
            builder.make_model(bad, "cpu")
        with pytest.raises(KeyError):
            jax_builder.make_model(bad)
    finally:
        precision.set_compute_dtype("float32")
        jax_precision.set_compute_dtype("float32")
    cfg = _synthetic("spformer_tiny.yaml", "dataset.name=semantic_nusc")
    with pytest.raises(ValueError, match="make_loaders"):
        builder.make_synthetic_loaders(cfg, None)
    from u2mkd_tpu_torch.parallel import mesh

    cfg = _synthetic("spformer_tiny.yaml", "train.multihost=true", "batch_size=3")
    monkeypatch.setattr(mesh, "world_size", lambda group=None: 2)
    with pytest.raises(ValueError, match="not data parallel"):
        builder.make_loaders(cfg, builder.make_model(cfg, "cpu"))


@pytest.mark.parametrize("path,opts,world", [
    ("configs/synthetic/train/spformer_tiny.yaml", [], 1),
    ("configs/nuscenes/train/spformer.yaml", [], 1),
    ("configs/nuscenes/train/spformer.yaml", [], 4),
    ("configs/nuscenes/train/spformer_tsd_full_ours_star.yaml", ["scheduler.name=poly"], 1),
    ("configs/synthetic/train/tsd_tiny.yaml", ["scheduler.name=none"], 1),
])
def test_lr_sequence_matches_optax(path, opts, world):
    """The learning rate of each step of ``make_optimizer_and_schedule``
    (the optimizer's group at LambdaLR's factor) equals the step size of
    the JAX package's optax chain at the same count, read as -update / g
    with momentum (plain, no Nesterov) and weight decay at 0, over the first steps and across
    the warm-up's end."""
    opts = opts + ["optimizer.name=sgd", "optimizer.momentum=0", "optimizer.nesterov=false",
                   "optimizer.weight_decay=0"]
    cfg = config.update_dotted(config.load(os.path.join(REPO, path)), opts)
    tx = jax_builder.make_optimizer_and_schedule(
        jax_config.update_dotted(jax_config.load(os.path.join(REPO, path)), opts), world)
    w = torch.nn.Parameter(torch.ones(3))
    opt, sched = builder.make_optimizer_and_schedule(cfg, [("w", w)], world)
    params = {"w": jnp.ones(3)}
    state = tx.init(params)
    steps = 260 if world > 1 else 6
    for step in range(steps):
        upd, state = tx.update({"w": jnp.ones(3)}, state, params)
        want = -float(upd["w"][0])
        if step < 6 or step >= 245:
            np.testing.assert_allclose(opt.param_groups[0]["lr"], want, rtol=1e-6,
                                       err_msg=str(step))
        opt.step()
        sched.step()


def test_synthetic_loaders_match_jax():
    """The teacher's loaders draw the JAX loaders' scans (train from the
    seed, val from seed + 1) with the model's window geometry attached; the
    distillation loaders' train batches carry both parts' plumbing, their
    val batches the student's only (``debug.debug_val`` off)."""
    cfg = _synthetic("spformer_tiny.yaml", "data.training_size=8", "model.pallas_attention=true")
    model = builder.make_model(cfg, "cpu")
    train, val = builder.make_synthetic_loaders(cfg, model, seed=5)
    jcfg = jax_config.update_dotted(
        jax_config.load(os.path.join(REPO, "configs/synthetic/train/spformer_tiny.yaml")),
        ["data.training_size=8"])
    j_train, j_val = jax_builder.make_synthetic_loaders(jcfg, seed=5)
    for ours, theirs, n in ((train, j_train, 4), (val, j_val, 2)):
        got, want = list(ours()), list(theirs())
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            for k in ("feats", "labels", "pmask", "pcoords"):
                np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)
            assert "wgeom" in g["plumbing"]

    cfg = _synthetic("tsd_tiny.yaml", "data.training_size=8", "model.pallas_attention=true")
    model = builder.make_model(cfg, "cpu")
    train, val = builder.make_synthetic_distill_loaders(cfg, model)
    j_train, _ = jax_builder.make_synthetic_distill_loaders(
        jax_config.update_dotted(
            jax_config.load(os.path.join(REPO, "configs/synthetic/train/tsd_tiny.yaml")),
            ["data.training_size=8"]))
    first, want = next(iter(train())), next(iter(j_train()))
    for part in ("student", "teacher"):
        for k in ("feats", "pmask"):
            np.testing.assert_array_equal(first[part][k], np.asarray(want[part][k]))
        assert "wgeom" in first[part]["plumbing"]
    np.testing.assert_array_equal(first["t2s"], np.asarray(want["t2s"]))
    v = next(iter(val()))
    assert "plumbing" in v["student"] and "plumbing" not in v["teacher"]
