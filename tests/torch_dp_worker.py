"""One rank of a data-parallel run of the port, for
``tests/test_torch_parallel*.py`` and ``tests/test_torch_remat.py`` (on the
CPU) and ``tests/test_torch_cuda.py`` (on the card), which start one process
per rank through :func:`spawn`, or through :func:`start` and
:func:`collect` to work while the ranks run:

    python tests/torch_dp_worker.py TASK PORT RANK WORLD IN.pkl OUT.pkl [BACKEND]

The rank joins a group (gloo unless BACKEND says otherwise) at
``127.0.0.1:PORT``, reads the task's inputs from ``IN.pkl`` (numpy arrays;
each rank takes its own scan), runs the task and writes its outputs, as
numpy, to ``OUT.pkl``. The tasks ``mean_of_scans`` and ``distill_grads``
run in one process (WORLD 1) and use no group: the JAX comparisons run
them beside their JAX programs. Imports torch and the port only (no JAX).
"""

import contextlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

import torch


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


def _state(model):
    return {k: _np(v) for k, v in model.state_dict().items()}


def task_bn(args, rank, group):
    """The synced MaskedBatchNorm on this rank's rows and the synced
    BatchNorm2d on its maps, in training mode: outputs, running statistics
    and the gradients of sum(y * cotangent) with respect to the input, the
    scale and the bias."""
    from u2mkd_tpu_torch.models.blocks import MaskedBatchNorm
    from u2mkd_tpu_torch.models.swiftnet import BatchNorm2d

    out = {}
    for name, bn, x, mask, g in (
            ("masked", MaskedBatchNorm(args["x"].shape[-1], process_group=group),
             args["x"][rank:rank + 1], args["mask"][rank:rank + 1], args["g"][rank:rank + 1]),
            ("image", BatchNorm2d(args["img"].shape[1], process_group=group),
             args["img"][2 * rank:2 * rank + 2], None, args["gimg"][2 * rank:2 * rank + 2])):
        with torch.no_grad():
            bn.weight.copy_(torch.as_tensor(args[f"{name}_scale"]))
            bn.bias.copy_(torch.as_tensor(args[f"{name}_bias"]))
        bn.train()
        xt = torch.tensor(x, requires_grad=True)
        y = bn(xt, torch.as_tensor(mask)) if mask is not None else bn(xt)
        (y * torch.as_tensor(g)).sum().backward()
        out[name] = {"y": _np(y), "mean": _np(bn.running_mean), "var": _np(bn.running_var),
                     "dx": _np(xt.grad), "dscale": _np(bn.weight.grad),
                     "dbias": _np(bn.bias.grad)}
    return out


def task_teacher(args, rank, group):
    """The conv-only SPVCNN's data-parallel eval step on the start weights,
    then one data-parallel train step (plain SGD) on this rank's scan."""
    from u2mkd_tpu_torch.models.spvcnn import SPVCNN
    from u2mkd_tpu_torch.parallel import mesh
    from u2mkd_tpu_torch.train import optim, state

    caps = tuple(args["caps"])
    model = SPVCNN(num_classes=args["ncls"], cr=0.25, sphereformer=False, dropout_rate=0.0,
                   process_group=group)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in args["state"].items()})
    opt, _ = optim.make_optimizer(model.named_parameters(), "sgd", args["lr"])
    step = mesh.data_parallel_step(state.make_train_step(model, opt, caps, process_group=group),
                                   model, group)
    ev = mesh.data_parallel_eval(state.make_eval_step(model, caps, args["ncls"],
                                                      process_group=group), model, group)
    batch = args["batches"][rank]
    res = ev(batch)
    aux = step(batch)
    return {"loss": float(aux["loss"]), "state": _state(model),
            "counts": {k: _np(v) for k, v in res["counts"].items()}, "pred": _np(res["pred"])}


def task_distill(args, rank, group):
    """The stage-2 data-parallel train step on this rank's scan from the
    given weights (the BN layers named in ``local_bn`` unsynced), then the
    data-parallel eval step; then, from the same weights, the step with its
    BN sums' backward reduction dropped on rank 1
    (``chip_smoke.dropped_bn_backward_sum``)."""
    from u2mkd_tpu_torch.models.tsd import TSDFull
    from u2mkd_tpu_torch.parallel import mesh
    from u2mkd_tpu_torch.train import distill

    import chip_smoke

    s_caps, t_caps = tuple(args["s_caps"]), tuple(args["t_caps"])
    batch = args["batches"][rank]
    out = {}
    for tag in ("dp", "fault"):
        model = TSDFull(process_group=group, **args["model"])
        model.load_state_dict({k: torch.as_tensor(v) for k, v in args["state"].items()})
        for name in args.get("local_bn", ()):  # BN layers left to each rank's own batch
            model.get_submodule(name).process_group = None
        opt, _ = distill.make_frozen_teacher_optimizer(model, "sgd_spformer", args["lr"])
        step = mesh.data_parallel_step(distill.make_distill_train_step(
            model, opt, s_caps, t_caps, process_group=group), model, group)
        with (chip_smoke.dropped_bn_backward_sum() if tag == "fault" and rank == 1
              else contextlib.nullcontext()):
            aux = step(batch)
        out[tag] = {"aux": {k: float(v) for k, v in aux.items()}, "state": _state(model)}
        if tag == "dp":
            ev = mesh.data_parallel_distill_eval(distill.make_distill_eval_step(
                model, s_caps, t_caps, args["model"]["num_classes"], process_group=group),
                model, group)
            res = ev(batch)
            local = distill.make_distill_eval_step(model, s_caps, t_caps,
                                                   args["model"]["num_classes"])(batch)
            out[tag]["counts"] = {k: {n: _np(v) for n, v in res[k].items()}
                                  for k in ("counts_vox", "counts_pix")}
            out[tag]["local_counts"] = {k: {n: _np(v) for n, v in local[k].items()}
                                        for k in ("counts_vox", "counts_pix")}
    return out


def task_unet(args, rank, group):
    """The SphereFormer U-Net's data-parallel train step (``sgd_spformer``)
    on this rank's scan from the given weights, then its data-parallel and
    single-process eval steps; then, from the same weights, the step with
    its BN sums' backward reduction dropped on rank 1
    (``chip_smoke.dropped_bn_backward_sum``)."""
    from u2mkd_tpu_torch.models.sphereformer_unet import SphereFormerSemantic
    from u2mkd_tpu_torch.parallel import mesh
    from u2mkd_tpu_torch.train import optim, state

    import chip_smoke

    caps, ncls = tuple(args["caps"]), args["model"]["num_classes"]
    batch = args["batches"][rank]
    out = {}
    for tag in ("dp", "fault"):
        model = SphereFormerSemantic(process_group=group, **args["model"])
        model.load_state_dict({k: torch.as_tensor(v) for k, v in args["state"].items()})
        opt, _ = optim.make_optimizer(model.named_parameters(), "sgd_spformer", args["lr"])
        step = mesh.data_parallel_step(state.make_train_step(model, opt, caps,
                                                             process_group=group), model, group)
        with (chip_smoke.dropped_bn_backward_sum() if tag == "fault" and rank == 1
              else contextlib.nullcontext()):
            aux = step(batch)
        out[tag] = {"loss": float(aux["loss"]), "state": _state(model)}
        if tag == "dp":
            ev = mesh.data_parallel_eval(state.make_eval_step(model, caps, ncls,
                                                              process_group=group), model, group)
            out[tag]["counts"] = {n: _np(v) for n, v in ev(batch)["counts"].items()}
            local = state.make_eval_step(model, caps, ncls)(batch)
            out[tag]["local_counts"] = {n: _np(v) for n, v in local["counts"].items()}
    return out


def task_remat(args, rank, group):
    """The stage-2 data-parallel train step on this rank's scan from the
    given weights, with dropout and drop path drawn from a generator of the
    rank's seed, once with ``remat=False`` and once with ``remat=True``."""
    from u2mkd_tpu_torch.models.tsd import TSDFull
    from u2mkd_tpu_torch.parallel import mesh
    from u2mkd_tpu_torch.train import distill

    out = {}
    for remat in (False, True):
        model = TSDFull(process_group=group, **args["model"])
        model.load_state_dict({k: torch.as_tensor(v) for k, v in args["state"].items()})
        opt, _ = distill.make_frozen_teacher_optimizer(model, "sgd_spformer", args["lr"])
        gen = torch.Generator().manual_seed(args["seed"] + rank)
        step = mesh.data_parallel_step(distill.make_distill_train_step(
            model, opt, tuple(args["s_caps"]), tuple(args["t_caps"]), generator=gen,
            process_group=group, remat=remat), model, group)
        aux = step(args["batches"][rank])
        out[remat] = {"aux": {k: float(v) for k, v in aux.items()}, "state": _state(model),
                      "generator": _np(gen.get_state())}
    return out


def task_card_teacher(args, rank, group):
    """On the card: the flagship teacher's (``teacher_model``, K1-K5)
    data-parallel train step on this rank's scan from the given weights."""
    from u2mkd_tpu_torch.models.spvcnn import teacher_model
    from u2mkd_tpu_torch.parallel import mesh
    from u2mkd_tpu_torch.train import optim, state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = teacher_model(device="cuda", process_group=group, **args["model"])
    model.load_state_dict({k: torch.as_tensor(v) for k, v in args["state"].items()})
    opt, _ = optim.make_optimizer(model.named_parameters(), "sgd_spformer", args["lr"])
    step = mesh.data_parallel_step(state.make_train_step(model, opt, tuple(args["caps"]),
                                                         process_group=group), model, group)
    aux = step(args["batches"][rank])
    return {"loss": float(aux["loss"]), "state": _state(model)}


def task_mean_of_scans(args, rank=0, group=None):
    """One process, no group: the stage-2 step on the batch of both scans
    whose objective is the mean of the two scans' losses
    (``chip_smoke.mean_of_scans_distill_step``) from the given weights, and
    from copies of them with every parameter times (1 + 2^-23 N(0, 1))
    drawn from each seed of ``args["nudges"]`` -> {"reference" or the seed:
    (the state after the step, its loss)}."""
    from u2mkd_tpu_torch.models.tsd import TSDFull
    from u2mkd_tpu_torch.train import distill

    import chip_smoke

    out = {}
    for tag in ("reference", *args["nudges"]):
        model = TSDFull(**args["model"])
        model.load_state_dict({k: torch.as_tensor(v) for k, v in args["state"].items()})
        if tag != "reference":
            gen = torch.Generator().manual_seed(tag)
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + 2.0 ** -23 * torch.randn(p.shape, generator=gen))
        opt, _ = distill.make_frozen_teacher_optimizer(model, "sgd_spformer", args["lr"])
        loss = chip_smoke.mean_of_scans_distill_step(
            model, opt, tuple(args["s_caps"]), tuple(args["t_caps"]))(args["batch"])["loss"]
        out[tag] = (_state(model), loss.item())
    return out


def task_distill_grads(args, rank=0, group=None):
    """One process, no group: a stage-2 train step (``args["remat"]``) on
    ``args["batch"]`` from each state of ``args["runs"]`` ({tag: (state,
    fault)}), dropout and drop path drawn from a generator seeded
    ``args["seed"]``, a run with a ``fault`` under
    ``chip_smoke.planted_remat_fault(fault)`` -> {tag: (the loss terms, the
    student's gradients)}."""
    from u2mkd_tpu_torch.models.tsd import TSDFull
    from u2mkd_tpu_torch.train import distill

    import chip_smoke

    out = {}
    for tag, (state, fault) in args["runs"].items():
        model = TSDFull(**args["model"])
        model.load_state_dict({k: torch.as_tensor(v) for k, v in state.items()})
        opt, _ = distill.make_frozen_teacher_optimizer(model, "sgd_spformer", args["lr"])
        step = distill.make_distill_train_step(
            model, opt, tuple(args["s_caps"]), tuple(args["t_caps"]),
            generator=torch.Generator().manual_seed(args["seed"]), remat=args["remat"])
        with chip_smoke.planted_remat_fault(fault) if fault else contextlib.nullcontext():
            terms = {k: v.item() for k, v in step(args["batch"]).items()}
        out[tag] = (terms, {n: _np(p.grad).copy() for n, p in model.model_s.named_parameters()})
    return out


TASKS = {"bn": task_bn, "teacher": task_teacher, "distill": task_distill,
         "remat": task_remat, "card_teacher": task_card_teacher, "unet": task_unet,
         "mean_of_scans": task_mean_of_scans, "distill_grads": task_distill_grads}


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start(task, args, tmp_path, world=2, backend="gloo", timeout=240):
    """Start ``task`` in ``world`` ranks, processes of this file on a free
    port, and return at once -> a handle for :func:`collect`, which waits
    for them; the caller may work meanwhile. ``timeout`` seconds count from
    here."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fd, inp = tempfile.mkstemp(prefix=f"{task}_", suffix=".pkl", dir=str(tmp_path))
    with os.fdopen(fd, "wb") as f:
        pickle.dump(args, f)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    stem = inp[:-len(".pkl")]
    outs = [f"{stem}_out{r}.pkl" for r in range(world)]
    logs = [f"{stem}_log{r}.txt" for r in range(world)]
    procs = []
    for r in range(world):
        # the rank's output goes to a file: a pipe that nobody reads while
        # the caller works could fill and stop the rank
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), task, str(port), str(r),
                 str(world), inp, outs[r], backend], cwd=repo, env=env, stdout=log,
                stderr=subprocess.STDOUT))
    return procs, outs, logs, time.monotonic() + timeout


def collect(handle):
    """Wait for the ranks of :func:`start` -> each rank's outputs; a rank
    that fails or outlives its time fails the caller with its output."""
    procs, outs, logs, deadline = handle
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        with open(logs[r]) as f:
            log = f.read()
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    res = []
    for out in outs:
        with open(out, "rb") as f:
            res.append(pickle.load(f))
    return res


def spawn(task, args, tmp_path, world=2, backend="gloo", timeout=240):
    """``task`` in ``world`` ranks, processes of this file on a free port,
    each with ``timeout`` seconds -> each rank's outputs; a rank that fails
    fails the caller with its output."""
    return collect(start(task, args, tmp_path, world, backend, timeout))


def main():
    task, port, rank, world, inp, out = sys.argv[1:7]
    backend = sys.argv[7] if len(sys.argv) > 7 else "gloo"
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from u2mkd_tpu_torch.parallel import mesh

    mesh.initialize_distributed(f"127.0.0.1:{port}", world, rank, backend)
    with open(inp, "rb") as f:
        args = pickle.load(f)
    res = TASKS[task](args, rank, mesh.data_group())
    with open(out, "wb") as f:
        pickle.dump(res, f)
    mesh.shutdown()


if __name__ == "__main__":
    main()
