"""The port's loader factories and prefetch pipeline
(``u2mkd_tpu_torch/data/loaders.py``, ``prefetch.py``) against the JAX
package's, on the CPU.

``make_loaders`` and ``make_distill_loaders`` on the nuScenes-mini configs
(``configs/nuscenes/mini/``) over a set that ``tools/make_nusc_mini.generate``
writes at 300 points a scan give the JAX factories' batches, in the same
order, over two shuffled epochs: every array bitwise, ``infos`` and
``lidar_tokens`` equal, and the plumbing equal to the JAX package's host
plumbing (the port's window geometry to the JAX builder's on the same
voxels). Thread workers, process workers and no prefetch give identical
batches. Then the twins of ``tests/test_prefetch.py``, the concurrent TSD
plumbing stage at capacities the JAX package's stage cannot build, and the
synthetic loaders, whose batches the pipeline leaves as they were.

The JAX side of each comparison runs on its native library, built into a
directory of this module's own and loaded before any JAX loader runs
(``jax_native``): the JAX package builds ``native/libpointcore.so`` in
place with no lock and, after one failed load, takes its numpy builders for
the rest of the process, whose ``down8`` differs from the native one at
level 0 (``test_jax_numpy_fallback_down8_differs_at_level_0``).
"""

import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from u2mkd_tpu.data import loaders as jax_loaders
from u2mkd_tpu.data import native as jax_native_mod
from u2mkd_tpu.data import plumbing_host as jax_plumbing_host
from u2mkd_tpu.data import synthetic as jax_synthetic
from u2mkd_tpu.data import wgeom_host as jax_wgeom_host
from u2mkd_tpu.utils import config as jax_config

from test_torch_datasets import assert_same
from u2mkd_tpu_torch.data import loaders, plumbing_host, synthetic, wgeom_host
from u2mkd_tpu_torch.data.prefetch import (
    maybe_pipelined, pipelined_map, prefetch, process_pipelined_map,
)
from u2mkd_tpu_torch.train import builder
from u2mkd_tpu_torch.utils import config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
STAGE1 = "configs/nuscenes/mini/spformer_mini.yaml"
STAGE2 = "configs/nuscenes/mini/tsd_mini.yaml"


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """At most two CPU threads per test process: the tier-1 run shares the
    machine's cores among several workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mini_root(tmp_path_factory):
    from make_nusc_mini import generate

    root = str(tmp_path_factory.mktemp("nusc_mini"))
    generate(root, pts_per_scan=300)
    return root


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native library, built from a copy of ``native/``'s
    sources in a directory of this module's own and loaded, so that no JAX
    builder of this module takes the numpy fallback: its directory
    (``_native_dir``), ``_TRIED`` and ``_LIB`` are set for the module and
    restored after it. A failed build fails here, with the compiler's
    output."""
    src = os.path.join(REPO, "native")
    d = str(tmp_path_factory.mktemp("jax_native"))
    for name in ("Makefile", "pointcore.cpp"):
        shutil.copy2(os.path.join(src, name), d)
    res = subprocess.run(["make", "-C", d, "libpointcore.so"], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, f"the JAX package's native library did not build:\n" \
                                f"{res.stdout}\n{res.stderr}"
    saved = (jax_native_mod._native_dir, jax_native_mod._TRIED, jax_native_mod._LIB)
    jax_native_mod._native_dir = lambda: d
    jax_native_mod._TRIED, jax_native_mod._LIB = False, None
    try:
        lib = jax_native_mod._load()
        assert lib is not None and hasattr(lib, "build_plumbing_host"), \
            f"the JAX package's native library in {d} did not load"
        yield lib
    finally:
        jax_native_mod._native_dir, jax_native_mod._TRIED, jax_native_mod._LIB = saved


def _cfgs(path, root, *opts):
    opts = [f"dataset.root={root}", "dataset.im_cr=0.05", *opts]
    return (config.update_dotted(config.load(os.path.join(REPO, path)), list(opts)),
            jax_config.update_dotted(jax_config.load(os.path.join(REPO, path)), list(opts)))


def _host(x):
    """A port or JAX batch as nested numpy arrays."""
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    if torch.is_tensor(x):
        return x.numpy()
    return x if isinstance(x, (str, type(None))) else np.asarray(x)


def _plumbing_of(batch, part):
    return batch.pop("plumbing", None) if part is None else batch[part].pop("plumbing", None)


def _check_plumbing(ours, ref, params, caps):
    """The port's plumbing against the JAX package's host plumbing of the
    same feed: every array the port keeps, and the window geometry of the
    JAX builder on the port's model parameters."""
    for k in plumbing_host.KEYS:
        for li in range(len(caps)):
            np.testing.assert_array_equal(ours[k][li], ref[k][li], err_msg=f"{k}[{li}]")
    want = jax_wgeom_host.batch_window_geometry(ref["voxxyz"], ref["vmask"], params)
    for branch in ("cubic", "sphere"):
        for li, (g, gr) in enumerate(zip(ours["wgeom"][branch], want[branch])):
            assert sorted(g) == sorted(gr)
            for k in gr:
                np.testing.assert_array_equal(g[k], gr[k], err_msg=f"{branch}[{li}].{k}")


def _compare_streams(ours, ref, params, caps):
    """Two loaders' epochs: the same number of batches, each equal without
    its plumbing, and the first batch's plumbing of each part (``params``
    and ``caps`` keyed by part; None for a uni-modal batch) as the JAX
    package builds it."""
    assert len(ours) == len(ref) > 0
    for b, (got, want) in enumerate(zip(ours, ref)):
        got, want = _host(got), _host(want)
        for part in params:
            g_pl, w_pl = _plumbing_of(got, part), _plumbing_of(want, part)
            assert (g_pl is None) == (w_pl is None), part
            if g_pl is not None and b == 0:
                _check_plumbing(g_pl, w_pl, params[part], caps[part])
        assert_same(got, want, f"batch{b}")


def test_make_loaders_match_jax(mini_root, jax_native):
    """Stage 1 (``semantic_nusc``, one past and one future sweep, flip,
    rotate+scale): two shuffled train epochs and a val epoch."""
    cfg, jcfg = _cfgs(STAGE1, mini_root, "workers=2", "model.pallas_attention=true")
    model = builder.make_model(cfg, "cpu")
    train, val = loaders.make_loaders(cfg, model, seed=3)
    j_train, j_val = jax_loaders.make_loaders(jcfg, seed=3, n_shards=1)
    params = {None: wgeom_host.params_from_model(model)}
    caps = {None: tuple(cfg.capacities)}
    for ours, ref in ((train, j_train), (train, j_train), (val, j_val)):
        _compare_streams(list(ours()), list(ref()), params, caps)


def test_make_distill_loaders_match_jax(mini_root, jax_native):
    """Stage 2 (``lc_semantic_nusc_tsd_full``): the paired feeds, ``t2s``
    and both parts' plumbing over two shuffled train epochs; the val
    batches carry the student's plumbing only (``debug.debug_val`` off)."""
    cfg, jcfg = _cfgs(STAGE2, mini_root, "model.pallas_attention=true")
    model = builder.make_model(cfg, "cpu")
    train, val = loaders.make_distill_loaders(cfg, model, seed=4)
    j_train, j_val = jax_loaders.make_distill_loaders(jcfg, seed=4, n_shards=1)
    params = {"student": wgeom_host.params_from_model(model.model_s),
              "teacher": wgeom_host.params_from_model(model.model_t)}
    caps = {"student": tuple(cfg.student_capacities), "teacher": tuple(cfg.teacher_capacities)}
    for ours, ref in ((train, j_train), (train, j_train), (val, j_val)):
        _compare_streams(list(ours()), list(ref()), params, caps)
    v = next(iter(val()))
    assert "plumbing" in v["student"] and "plumbing" not in v["teacher"]


def test_jax_numpy_fallback_down8_differs_at_level_0(jax_native, monkeypatch):
    """A deviation of the JAX package (ROADMAP section 3): its numpy
    fallback fills level 0's ``down8`` and the last level's ``parent``,
    which no conv reads, with -1, where its native builder leaves the zeros
    it allocated, and its devoxelize weights of levels 2-4 differ from the
    native ones by an f32 rounding (within 2^-20). Every other array of the
    two builds is equal, and the port's host plumbing is the native
    build's, bitwise."""
    caps = (512, 256, 128, 64, 32)
    raw = jax_synthetic.make_batch(np.random.RandomState(5), 2, 512, voxel_size=0.1)
    args = (raw["pcoords"], raw["xyz"], raw["pmask"], caps)
    native = jax_plumbing_host.batch_plumbing(*args)
    monkeypatch.setattr(jax_plumbing_host.native, "_load", lambda: None)
    fallback = jax_plumbing_host.batch_plumbing(*args)
    ours = plumbing_host.batch_plumbing(*args)
    unread = {("down8", 0), ("parent", len(caps) - 1)}
    for k, li in unread:
        assert (native[k][li] == 0).all() and (fallback[k][li] == -1).all(), (k, li)
    for k in plumbing_host.KEYS:
        for li in range(len(caps)):
            np.testing.assert_array_equal(ours[k][li], native[k][li], err_msg=f"{k}[{li}]")
            if k == "dvw":
                np.testing.assert_allclose(fallback[k][li], native[k][li], rtol=0,
                                           atol=2.0 ** -20, err_msg=f"{k}[{li}]")
            elif (k, li) not in unread:
                np.testing.assert_array_equal(fallback[k][li], native[k][li],
                                              err_msg=f"{k}[{li}]")


@pytest.mark.parametrize("opts", [["workers=2"], ["workers=2", "worker_processes=true"],
                                  ["prefetch_depth=0"]])
def test_distill_loader_pipelines_agree(mini_root, opts):
    """Thread workers, spawned process workers, and no prefetch thread at
    all give the serial loader's batches (``workers=0``), bitwise."""
    cfg, _ = _cfgs(STAGE2, mini_root, "workers=0")
    model = builder.make_model(cfg, "cpu")
    serial = [_host(b) for b in loaders.make_distill_loaders(cfg, model, seed=1)[0]()]
    cfg, _ = _cfgs(STAGE2, mini_root, *opts)
    other = [_host(b) for b in loaders.make_distill_loaders(cfg, model, seed=1)[0]()]
    assert len(serial) == 3
    assert_same(other, serial)


def test_to_device_keeps_host_keys():
    """``to_device`` makes a tensor of every array but the host-local
    subtrees; on the CPU the tensors share the arrays' memory."""
    batch = {"a": np.arange(4, dtype=np.int32), "nested": {"b": [np.ones((2, 3), bool)]},
             "infos": [{"inverse_map": np.arange(3)}], "lidar_tokens": ["tok"]}
    out = loaders.to_device(batch, torch.device("cpu"))
    assert torch.is_tensor(out["a"]) and out["a"].dtype == torch.int32
    assert out["nested"]["b"][0].dtype == torch.bool
    assert out["infos"] is batch["infos"] and out["lidar_tokens"] == ["tok"]
    out["a"][0] = 7
    assert batch["a"][0] == 7


@pytest.mark.parametrize("depth", [2, 0])
def test_device_loader_takes_any_iterable(depth):
    """``device_loader`` over a loader that returns a plain iterator (no
    ``close``), with and without the prefetch thread: every batch, in
    order, its arrays as tensors and its host keys as they were."""
    batches = [{"a": np.full(3, i, np.int32), "infos": [{"i": i}]} for i in range(5)]
    got = list(loaders.device_loader(lambda: iter(batches), "cpu", depth)())
    assert [int(b["a"][0]) for b in got] == list(range(5))
    assert all(torch.is_tensor(b["a"]) and b["infos"] == [{"i": i}] for i, b in enumerate(got))


def test_device_batches_are_not_copied_again():
    """The steps' readers take a batch the loaders uploaded without a second
    copy: ``batch_reader``'s tensors and ``from_precomputed``'s plumbing
    share the uploaded tensors' memory."""
    from u2mkd_tpu_torch.models import plumbing as P
    from u2mkd_tpu_torch.models.spvcnn import teacher_model
    from u2mkd_tpu_torch.train.state import batch_reader

    caps = (256, 128, 64, 32, 16)
    model = teacher_model(num_classes=5, cr=0.25, voxel_size=0.2, head_dim=4, device="cpu")
    raw = synthetic.make_batch(np.random.RandomState(0), 1, 256, voxel_size=0.2)
    raw = loaders.PlumbingStage(caps, wgeom_host.params_from_model(model))(raw)
    batch = loaders.to_device(raw, torch.device("cpu"))
    _, plumbing_of, tensor_of = batch_reader(model, caps)
    assert tensor_of(batch, "feats", torch.float32).data_ptr() == batch["feats"].data_ptr()
    pl = plumbing_of(batch)
    arrays = batch["plumbing"]
    assert pl.levels[1].nbr27.data_ptr() == arrays["nbr27"][1].data_ptr()
    assert pl.p2v[0].data_ptr() == arrays["p2v"][0].data_ptr()
    assert pl.wgeom["cubic"][0].order.dtype == torch.int64
    assert pl.pmask.data_ptr() == batch["pmask"].data_ptr()
    ref = P.from_precomputed(raw["plumbing"], raw["pmask"], "cpu", model.point_levels)
    assert torch.equal(ref.levels[1].nbr27, pl.levels[1].nbr27)


def test_loaders_refuse_what_waits_for_item_6(mini_root, monkeypatch):
    """Item 6, data parallelism, is ported: ``train.multihost`` shards the
    loaders by rank, and what they refuse is a multi-process run that is not
    data parallel (batch 3 at two processes); Waymo's instance augmentation
    still has no parameters."""
    from u2mkd_tpu_torch.parallel import mesh

    cfg, _ = _cfgs(STAGE1, mini_root, "train.multihost=true", "batch_size=3")
    with monkeypatch.context() as m:
        m.setattr(mesh, "world_size", lambda group=None: 2)
        with pytest.raises(ValueError, match="not data parallel"):
            loaders.make_loaders(cfg, builder.make_model(cfg, "cpu"))
    cfg, _ = _cfgs(STAGE1, mini_root, "dataset.name=semantic_waymo", "dataset.inst_aug=true")
    with pytest.raises(NotImplementedError, match="Waymo"):
        loaders.make_loaders(cfg, builder.make_model(cfg, "cpu"))


# ---- the twins of tests/test_prefetch.py ----

def test_order_preserved():
    def slow_sq(x):
        time.sleep(0.05 * (8 - x) / 8)  # later items finish first
        return x * x

    assert list(pipelined_map(slow_sq, range(8), workers=4)) == [x * x for x in range(8)]


def test_exception_propagates():
    def boom(x):
        if x == 3:
            raise ValueError("x3")
        return x

    with pytest.raises(ValueError, match="x3"):
        list(pipelined_map(boom, range(8), workers=2))
    with pytest.raises(ValueError, match="x3"):
        list(prefetch(pipelined_map(boom, range(8), workers=2), depth=2))


def test_bounded_in_flight():
    live, peak = [], []
    lock = threading.Lock()

    def track(x):
        with lock:
            live.append(x)
            peak.append(len(live))
        time.sleep(0.02)
        with lock:
            live.remove(x)
        return x

    list(pipelined_map(track, range(20), workers=3, depth=4))
    assert max(peak) <= 4


def test_prefetch_close_stops_worker():
    produced = []
    done = threading.Event()

    def src():
        for i in range(1000):
            produced.append(i)
            yield i
        done.set()

    gen = prefetch(src(), depth=2)
    assert next(gen) == 0
    gen.close()
    n_at_close = len(produced)
    time.sleep(0.5)
    assert len(produced) <= n_at_close + 2
    assert not done.is_set()


def test_prefetch_sentinel_survives_full_queue():
    got = []
    finished = threading.Event()

    def consume():
        for item in prefetch(iter(range(3)), depth=1):
            time.sleep(0.3)  # consumer slower than producer
            got.append(item)
        finished.set()

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    assert finished.wait(10.0), "consumer hung: end-of-epoch sentinel lost"
    assert got == [0, 1, 2]


def test_prefetch_close_unwinds_pipeline():
    """Closing a loader's iterator stops the prefetch thread, the plumbing
    pool and the source: through ``maybe_pipelined`` and through
    :func:`loaders.device_loader`."""
    for wrap in ("prefetch", "device_loader"):
        consumed = []

        def src():
            for i in range(1000):
                consumed.append(i)
                yield i

        if wrap == "prefetch":
            gen = prefetch(maybe_pipelined(lambda x: x + 1, src(), workers=2), depth=2)
            assert next(gen) == 1
        else:
            gen = loaders.device_loader(
                lambda: maybe_pipelined(lambda x: {"x": np.array([x + 1])}, src(), workers=2),
                "cpu", depth=2)()
            assert int(next(gen)["x"][0]) == 1
        gen.close()
        n = len(consumed)
        time.sleep(0.5)
        assert len(consumed) <= n + 8, wrap


def test_process_pipelined_map_matches_inline():
    """Process workers (spawned) build the inline plumbing, through pickle
    round trips."""
    caps = (256, 128, 64, 32, 16)
    batches = [synthetic.make_batch(np.random.RandomState(i), 1, 256, voxel_size=0.2)
               for i in range(3)]
    got = list(process_pipelined_map(loaders.PlumbingStage(caps), iter(batches), workers=2))
    assert len(got) == 3
    for b, raw in zip(got, batches):
        want = plumbing_host.batch_plumbing(raw["pcoords"], raw["xyz"], raw["pmask"], caps)
        assert_same(b["plumbing"], want)


def test_plumbing_stage_tsd_concurrent_feeds():
    """The TSD stage builds both feeds concurrently and matches the serial
    build, at the capacities (192, ...) at which the JAX package's stage
    raises (its TPU conv tiling needs multiples of 128 above 128)."""
    s_caps = (192, 96, 48, 24, 12)
    t_caps = (256, 128, 64, 32, 16)
    raw = synthetic.make_multimodal_batch(np.random.RandomState(1), 1, 192, 256,
                                          voxel_size=0.3, num_cams=2, im_hw=(16, 24))
    stage = loaders.PlumbingStage(None, tsd_caps={"student": s_caps, "teacher": t_caps})
    out = stage({k: dict(v) if isinstance(v, dict) else v for k, v in raw.items()})
    for key, caps in (("student", s_caps), ("teacher", t_caps)):
        want = plumbing_host.batch_plumbing(raw[key]["pcoords"], raw[key]["xyz"],
                                            raw[key]["pmask"], caps)
        assert_same(out[key]["plumbing"], want)


def test_synthetic_loaders_unchanged_by_pipeline():
    """The synthetic loaders, now through the real loaders' pipeline (four
    plumbing threads, a prefetch thread), give the batches of the serial
    construction: each scan drawn in turn from the seed, its plumbing and
    the model's window geometry built inline."""
    cfg = config.update_dotted(
        config.load(os.path.join(REPO, "configs/synthetic/train/spformer_tiny.yaml")),
        ["data.training_size=8", "workers=4", "prefetch_depth=2"])
    model = builder.make_model(cfg, "cpu")
    train, _ = builder.make_synthetic_loaders(cfg, model, seed=5)
    rng = np.random.RandomState(5)
    params = wgeom_host.params_from_model(model)
    got = [_host(b) for b in train()]
    assert len(got) == 4
    for g in got:
        want = synthetic.make_batch(rng, cfg.batch_size, cfg.dataset.num_points,
                                    cfg.dataset.voxel_size)
        want["plumbing"] = plumbing_host.batch_plumbing(
            want["pcoords"], want["xyz"], want["pmask"], tuple(cfg.capacities),
            wgeom_params=params)
        assert_same(g, want)

    cfg = config.update_dotted(
        config.load(os.path.join(REPO, "configs/synthetic/train/tsd_tiny.yaml")),
        ["data.training_size=4", "workers=4", "prefetch_depth=2"])
    model = builder.make_model(cfg, "cpu")
    train, _ = builder.make_synthetic_distill_loaders(cfg, model)
    rng = np.random.RandomState(cfg.train.seed % (2 ** 31))
    caps = {"student": tuple(cfg.get_path("student_capacities") or cfg.capacities),
            "teacher": tuple(cfg.teacher_capacities)}
    for g in [_host(b) for b in train()]:
        want = synthetic.make_multimodal_batch(
            rng, cfg.batch_size, cfg.dataset.num_points, cfg.dataset.teacher_points,
            cfg.dataset.voxel_size, num_cams=cfg.dataset.num_cams,
            im_hw=tuple(cfg.dataset.image_size))
        for part, sub in (("student", model.model_s), ("teacher", model.model_t)):
            w = want[part]
            w["plumbing"] = plumbing_host.batch_plumbing(
                w["pcoords"], w["xyz"], w["pmask"], caps[part],
                wgeom_params=wgeom_host.params_from_model(sub))
        assert_same(g, want)
