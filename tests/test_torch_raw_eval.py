"""Raw-point scoring (``u2mkd_tpu_torch/train/evaluator.py`` and the
``Trainer``'s ``RawSpec`` rule) against the JAX package's, on the CPU: the
same logits and devoxelize information give the same raw-point logits and
exactly the same integer IoU counts. Also the criterion factories
(``train/criterions.py``) against the JAX ones.

The logits and ``infos`` are drawn from a seed: a few scans whose raw points
map to padded voxel rows through ``inverse_map``, some past the model's
capacity (dropped voxels score zeros), with keyframe and FOV masks; the
eval steps return them as the port's (torch) and the JAX package's (jnp)
steps would.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2mkd_tpu.train import criterions as jax_criterions
from u2mkd_tpu.train import evaluator as jax_evaluator
from u2mkd_tpu.train.loop import RawSpec as JaxRawSpec
from u2mkd_tpu.train.loop import Trainer as JaxTrainer

from u2mkd_tpu_torch.train import criterions, evaluator, loop, metrics
from u2mkd_tpu_torch.utils.config import Config

NCLS = 6
P = 64


def _scan(rng):
    """One scan's padded logits [P, C], pmask [P] and devoxelize info."""
    n_vox = int(rng.randint(P // 2, P + 16))  # beyond P: dropped at capacity
    n_raw = int(rng.randint(n_vox, 3 * P))
    inverse = np.concatenate([np.arange(n_vox), rng.randint(0, n_vox, n_raw - n_vox)])
    rng.shuffle(inverse)
    pmask = np.zeros(P, bool)
    pmask[:min(n_vox, P)] = True
    info = {"inverse_map": inverse.astype(np.int32),
            "labels_full": rng.randint(0, NCLS, n_raw).astype(np.int32),
            "keyframe_mask_full": rng.rand(n_raw) < 0.8,
            "fov_full": rng.rand(n_raw) < 0.5}
    return rng.randn(P, NCLS).astype(np.float32), pmask, info


def _batches(seed, n_batches=3, b=2, nested=False):
    """(batches, eval outputs): flat ones, or TSD ones with ``student``
    nesting and a pixel head."""
    rng = np.random.RandomState(seed)
    batches, outs = [], []
    for _ in range(n_batches):
        scans = [_scan(rng) for _ in range(b)]
        logits = np.stack([s[0] for s in scans])
        part = {"pmask": np.stack([s[1] for s in scans]),
                "labels": rng.randint(0, NCLS, (b, P)).astype(np.int32),
                "keyframe_mask": rng.rand(b, P) < 0.9}
        if nested:
            batches.append({"student": part,
                            "infos": [{"student": s[2], "teacher": None} for s in scans]})
            outs.append({"logits": logits, "logits_pix": rng.randn(*logits.shape)
                         .astype(np.float32)})
        else:
            batches.append(dict(part, infos=[s[2] for s in scans]))
            outs.append({"logits": logits})
    return batches, outs


def test_devoxelize_predictions_matches_jax():
    rng = np.random.RandomState(0)
    dropped = 0
    for _ in range(8):
        logits, pmask, info = _scan(rng)
        got = evaluator.devoxelize_predictions(logits.copy(), pmask, info)
        want = jax_evaluator.devoxelize_predictions(logits.copy(), pmask, info)
        dropped += int((info["inverse_map"] >= pmask.sum()).sum())
        np.testing.assert_array_equal(got, want)
    assert dropped > 0


def _steps(outs):
    """The port's and the JAX package's eval steps over ``outs`` in turn
    (cycling, one round per vote; each round's logits moved by its vote so
    that votes differ)."""
    calls = {"ours": 0, "jax": 0}

    def ours(batch):
        i = calls["ours"]
        calls["ours"] += 1
        return {k: torch.from_numpy(v + i // len(outs)) for k, v in outs[i % len(outs)].items()}

    def theirs(state, batch):
        i = calls["jax"]
        calls["jax"] += 1
        return {k: jnp.asarray(v + i // len(outs)) for k, v in outs[i % len(outs)].items()}

    return ours, theirs


@pytest.mark.parametrize("num_vote", [1, 2])
@pytest.mark.parametrize("layout", ["flat", "tsd", "padded"])
def test_evaluate_tta_matches_jax(num_vote, layout):
    """``evaluate_tta`` with one vote and with two vote-summed rounds, on
    flat batches, on TSD batches through ``sample_view``, and on batches
    without ``infos`` (scored on their padded points)."""
    batches, outs = _batches(1, nested=layout == "tsd")
    if layout == "padded":
        for b in batches:
            del b["infos"]
    view = (lambda b: dict(b["student"], infos=[i["student"] for i in b["infos"]])) \
        if layout == "tsd" else None
    ours, theirs = _steps(outs)
    got = evaluator.evaluate_tta(ours, lambda: iter(batches), NCLS, num_vote=num_vote,
                                 sample_view=view)
    want = jax_evaluator.evaluate_tta(theirs, None, lambda: iter(batches), NCLS,
                                      num_vote=num_vote, sample_view=view)
    for k in ("seen", "correct", "positive"):
        np.testing.assert_array_equal(got["counts"][k], np.asarray(want["counts"][k]), k)
    assert got["counts"]["seen"].sum() > 0
    assert got["miou"] == want["miou"]


class _JaxScorer(JaxTrainer):
    """The JAX ``Trainer``'s raw-point scoring, without its run directory."""

    def __init__(self, raw_specs):
        self.num_classes, self.ignore_label, self.raw_specs = NCLS, 0, raw_specs


def test_trainer_raw_point_counts_match_jax(tmp_path):
    """The ``Trainer``'s raw-point counters per spec (the stage-2 CLI's
    ``counts_vox`` on ``logits`` and ``counts_pix`` on ``logits_pix`` over
    the FOV, and stage 1's keyframe rule on flat batches) equal the JAX
    ``Trainer``'s; and ``evaluate`` accumulates them, not the eval step's
    padded counters, exactly."""
    for nested, specs in (
            (True, [("counts_vox", "logits", "student", None),
                    ("counts_pix", "logits_pix", "student", "fov_full")]),
            (False, [("counts", "logits", None, "keyframe_mask_full")])):
        batches, outs = _batches(2, nested=nested)
        ours = loop.Trainer.__new__(loop.Trainer)
        ours.num_classes, ours.ignore_label = NCLS, 0
        ref = _JaxScorer([JaxRawSpec(*s) for s in specs])
        want = {s[0]: {k: np.zeros(NCLS, np.int64) for k in ("seen", "correct", "positive")}
                for s in specs}
        for batch, out in zip(batches, outs):
            for spec in specs:
                got = ours._raw_point_counts({k: torch.from_numpy(v) for k, v in out.items()},
                                             batch, loop.RawSpec(*spec))
                ref_counts = ref._raw_point_counts({k: jnp.asarray(v) for k, v in out.items()},
                                                   batch, JaxRawSpec(*spec))
                for k in got:
                    np.testing.assert_array_equal(got[k], ref_counts[k])
                    want[spec[0]][k] = want[spec[0]][k] + ref_counts[k]

        def eval_step(batch, it=iter(outs)):
            out = {k: torch.from_numpy(v) for k, v in next(it).items()}
            zeros = {n: torch.zeros(NCLS, dtype=torch.int32) for n in ("seen", "correct",
                                                                        "positive")}
            return dict(out, **{s[0]: zeros for s in specs})

        trainer = loop.Trainer(
            run_dir=str(tmp_path / f"run{int(nested)}"), model=torch.nn.Linear(1, 1),
            optimizer=None, scheduler=None, generator=None, train_step=None,
            eval_step=eval_step, train_loader=None, val_loader=lambda: iter(batches),
            num_epochs=1, num_classes=NCLS, eval_counts_key=specs[0][0],
            extra_count_keys=[s[0] for s in specs[1:]],
            raw_specs=[loop.RawSpec(*s) for s in specs])
        results = trainer.evaluate()
        trainer.summary.close()
        for s in specs:
            assert want[s[0]]["seen"].sum() > 0
            assert results[s[0]] == metrics.compute_miou(want[s[0]])[0], s[0]


@pytest.mark.parametrize("name", ["cross_entropy", "lovasz"])
def test_criterions_match_jax(name):
    """``make_criterion`` and ``make_criterion_dict`` on the same logits,
    labels (the ignore index among them) and masks, with and without a
    caller mask, to 1e-5."""
    from u2mkd_tpu.utils.config import Config as JaxConfig

    rng = np.random.RandomState(3)
    logits = rng.randn(300, NCLS).astype(np.float32)
    teacher = rng.randn(300, NCLS).astype(np.float32)
    labels = rng.randint(0, NCLS, 300)
    valid = rng.rand(300) < 0.7
    feats = rng.randn(300, 8).astype(np.float32), rng.randn(300, 8).astype(np.float32)
    cfg = {"criterion": {"name": name, "ignore_index": 2}}
    ours = (criterions.make_criterion(Config({k: Config(v) for k, v in cfg.items()})),
            criterions.make_criterion_dict(Config({k: Config(v) for k, v in cfg.items()})))
    ref = (jax_criterions.make_criterion(JaxConfig({k: JaxConfig(v) for k, v in cfg.items()})),
           jax_criterions.make_criterion_dict(
               JaxConfig({k: JaxConfig(v) for k, v in cfg.items()})))
    t, j = torch.from_numpy, jnp.asarray
    pairs = []
    for mask in (None, valid):
        tm = None if mask is None else t(mask)
        jm = None if mask is None else j(mask)
        pairs.append((ours[0](t(logits), t(labels), tm), ref[0](j(logits), j(labels), jm)))
        for key in ("ce", "lovasz"):
            pairs.append((ours[1][key](t(logits), t(labels), tm),
                          ref[1][key](j(logits), j(labels), jm)))
        pairs.append((ours[1]["kl"](t(logits), t(teacher), tm),
                      ref[1]["kl"](j(logits), j(teacher), jm)))
        pairs.append((ours[1]["mse"](*map(t, feats), tm), ref[1]["mse"](*map(j, feats), jm)))
    for got, want in pairs:
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
