"""The port's evaluation entry point (``python -m u2mkd_tpu_torch.evaluate``)
on the CPU, in-process through ``main(argv)``.

- After one epoch of either training entry point on the tiny synthetic
  configs, the CLI's mIoU of that run's checkpoint equals the validation
  mIoU the training loop printed (within 1e-2 of a point, as
  ``tests/test_cli_smoke.py`` holds the JAX package's).
- On a ``tools/make_nusc_mini.py`` set, from weights bridged from a JAX
  init, its per-class IoU on the raw points equals the JAX package's
  ``evaluator.evaluate_tta`` over the JAX package's own val loader (1e-6);
  the JAX side's convs take their XLA path (the TPU conv tiling dropped
  from its batches).
- With ``--num-vote 3`` each scan's three views differ, in the same scan
  order each vote.
"""

import hashlib
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2mkd_tpu.data import loaders as jax_loaders
from u2mkd_tpu.models.plumbing import from_precomputed as jax_from_precomputed
from u2mkd_tpu.train import builder as jax_builder
from u2mkd_tpu.train import evaluator as jax_evaluator
from u2mkd_tpu.train import state as jax_state
from u2mkd_tpu.utils import config as jax_config

from u2mkd_tpu_torch import evaluate, train_lc_nusc_tsd_full, train_spformer
from u2mkd_tpu_torch.models import convert_weights
from u2mkd_tpu_torch.train import checkpoints, loop, state

from test_torch_model import _random_variables

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

MINI = "configs/nuscenes/mini/spformer_mini.yaml"
MINI_OPTS = ["dataset.name=semantic_nusc", "batch_size=1", "capacities=[2048,1024,512,256,128]"]


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """The loop's metric log without TensorBoard, whose import here loads
    TensorFlow (~10 s)."""
    writer = loop.SummaryWriter
    monkeypatch.setattr(loop, "SummaryWriter", lambda d: writer(d, tensorboard=False))


def _miou(pattern, out):
    m = re.findall(pattern, out, re.M)
    assert m, out[-2000:]
    return float(m[-1])


@pytest.mark.parametrize("stage", ["teacher", "student"])
def test_cli_reproduces_the_training_loop(stage, tmp_path, capsys):
    """One epoch of the stage's training CLI, then the evaluation CLI on its
    ``latest.pt`` (the weights the loop validated last): the same mIoU."""
    main, cfg, extra = {
        "teacher": (train_spformer.main, "configs/synthetic/train/spformer_tiny.yaml",
                    ["model.cr=0.5"]),
        "student": (train_lc_nusc_tsd_full.main, "configs/synthetic/train/tsd_tiny.yaml", []),
    }[stage]
    run_dir = str(tmp_path / stage)
    opts = ["--cpu", "num_epochs=1", "data.training_size=8", *extra]
    main([cfg, "--run-dir", run_dir, *opts])
    trained = _miou(r"^epoch 1/1: .* miou=([0-9.]+)", capsys.readouterr().out)
    res = evaluate.main([cfg, "--checkpoint", os.path.join(run_dir, "checkpoints", "latest.pt"),
                         *opts])
    out = capsys.readouterr().out
    assert abs(_miou(r"^mIoU: ([0-9.]+)$", out) - trained) < 1e-2
    assert abs(res["miou"] * 100 - trained) < 1e-2
    assert "| Mean" in out


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """A nuScenes-format set, and a checkpoint of the port holding the
    bridged random weights of the JAX package's teacher of MINI -> (root,
    checkpoint, the JAX config, model and variables)."""
    from make_nusc_mini import generate

    root = str(tmp_path_factory.mktemp("nusc_mini"))
    generate(root, write_images=False)
    cfg = jax_config.load(MINI)
    jax_config.update_dotted(cfg, [f"dataset.root={root}", *MINI_OPTS])
    model = jax_builder.make_model(cfg)
    _, val_loader = jax_loaders.make_loaders(cfg, n_shards=1)
    batch = next(iter(val_loader()))
    abstract = jax.eval_shape(
        lambda f, a: model.init(jax.random.PRNGKey(0), f,
                                jax_from_precomputed(a, batch["pmask"]), False),
        batch["feats"], batch["plumbing"])
    variables = _random_variables(abstract, 17)
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "bridged.pt")
    torch.save({"format": checkpoints.FORMAT,
                "model": convert_weights.from_flax(variables["params"],
                                                   variables["batch_stats"])}, ckpt)
    return root, ckpt, cfg, model, variables


def test_per_class_iou_equals_jax_evaluate_tta(mini):
    """The CLI (one vote, the clean val pipeline) against JAX
    ``evaluate_tta`` on the JAX package's val loader of the same files:
    per-class IoU to 1e-6 and the raw-point counters equal."""
    root, ckpt, cfg, model, variables = mini
    res = evaluate.main([MINI, "--checkpoint", ckpt, "--cpu", f"dataset.root={root}",
                         *MINI_OPTS])

    _, val_loader = jax_loaders.make_loaders(cfg, n_shards=1)

    def xla_batches():
        # no TPU conv tiling: the JAX convs take their XLA gather path
        for b in val_loader():
            b = dict(b)
            b["plumbing"] = {k: v for k, v in b["plumbing"].items() if not k.startswith("cr27")}
            yield b

    st = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"], opt_state=())
    ev = jax.jit(jax_state.make_eval_step(model, tuple(cfg.capacities), cfg.data.num_classes,
                                          cfg.data.ignore_label))
    ref = jax_evaluator.evaluate_tta(ev, st, xla_batches, cfg.data.num_classes,
                                     cfg.data.ignore_label)
    for k in ("seen", "correct", "positive"):
        np.testing.assert_array_equal(res["counts"][k], ref["counts"][k], err_msg=k)
    assert res["counts"]["seen"].sum() > 1000
    np.testing.assert_allclose(res["per_class"], ref["per_class"], rtol=0, atol=1e-6)
    assert abs(res["miou"] - ref["miou"]) < 1e-6


def test_votes_differ(mini, monkeypatch):
    """``--num-vote 3``: three passes over the val scans in one order, each
    scan's three views different (fresh augmentation per pass), their
    logits summed into one finite mIoU."""
    root, ckpt, *_ = mini
    seen = []
    make = state.make_eval_step

    def recording(*args, **kw):
        step = make(*args, **kw)

        def eval_fn(batch):
            feats = np.asarray(batch["feats"])
            seen.append((batch["lidar_tokens"][0], hashlib.sha1(feats.tobytes()).hexdigest()))
            return step(batch)

        return eval_fn

    monkeypatch.setattr(state, "make_eval_step", recording)
    res = evaluate.main([MINI, "--checkpoint", ckpt, "--cpu", "--num-vote", "3",
                         f"dataset.root={root}", *MINI_OPTS])
    n = len(seen) // 3
    assert n >= 2 and len(seen) == 3 * n
    votes = [seen[i * n:(i + 1) * n] for i in range(3)]
    assert [t for t, _ in votes[0]] == [t for t, _ in votes[1]] == [t for t, _ in votes[2]]
    for i in range(n):
        assert len({votes[v][i][1] for v in range(3)}) == 3, votes
    assert np.isfinite(res["miou"]) and res["counts"]["seen"].sum() > 0
