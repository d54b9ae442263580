"""Weight bridge from the JAX package's flax variables to the port.

``from_flax(params, batch_stats)`` takes the nested dicts of numpy arrays of
a flax model (``variables["params"]``, ``variables["batch_stats"]``) and
returns a state dict for its counterpart in the port: a SPVCNN for
:class:`~u2mkd_tpu_torch.models.spvcnn.SPVCNN`, a whole ``TSDFull`` tree
(``model_s``, ``model_t``) for :class:`~u2mkd_tpu_torch.models.tsd.TSDFull`,
the SphereFormer U-Net's (its nested ``u`` scopes and a
``transformer_block`` per level), ``CLFM``'s and ``WindowMultiheadSA``'s
(with a Fourier ``gauss_B``, which keeps its name and layout). The port's
module names mirror the flax tree (the SwiftNet stages, the fusion layers
and the learners included), so the bridge is a rename:

  * ``SparseConv_i`` / ``SparseDownConv_0`` / ``SparseDeconv_0`` -> ``conv{i}``,
    ``MaskedBatchNorm_i`` -> ``bn{i}``, ``Dense_i`` -> ``fc{i}``;
  * a Dense ``kernel`` [in, out] becomes ``weight`` [out, in] (``nn.Linear``);
    a sparse conv ``kernel`` [K, Cin, Cout] keeps the JAX layout; a flax
    ``nn.Conv`` kernel [kh, kw, Cin, Cout] (HWIO) becomes ``weight`` [Cout,
    Cin, kh, kw] (``nn.Conv2d``);
  * ``scale`` -> ``weight`` (LayerNorm and the BNs); BN ``mean``/``var`` from
    ``batch_stats`` -> ``running_mean``/``running_var``;
  * RPE tables ``rel_*`` [L2, 3, h, d] keep name and layout.

The importers of torch checkpoints of the reference (port of
``u2mkd_tpu/models/convert_weights.py``) build that flax-shaped tree from a
reference state dict and hand it to :func:`from_flax`, so that layouts are
decided in one place:

  * :func:`load_teacher_pt`: a reference ``SPVCNN_SPFORMER`` ``.pt`` (the
    stage-1 teacher the stage-2 CLI loads into ``model_t``; reference
    ``core/nusc_trainers.py:190-199``), strictly. torchsparse 1.4's
    ``Conv3d.kernel`` is ``[K, Cin, Cout]`` (``[Cin, Cout]`` for ks=1) and
    gathers the input at ``output + offset[k]`` into ``W[k]``, as the port's
    convs do, but it enumerates the offsets in another order: odd-volume
    kernels z-outer/x-fastest, even-volume (ks=2) kernels x-outer/z-fastest
    (``torchsparse/nn/utils/kernel.py``), while :func:`spconv.kernel_offsets`
    is z-outer/x-fastest with (0,0,0) first. :func:`_ts_kernel_perm` matches
    the offset tuples; the transposed convs reuse the forward kmap with the
    same indexing, so the ks=2 permutation applies to them too.
  * :func:`load_imagenet_pretrain`: torchvision's ResNet-18 into the image
    branch (reference ``swiftnet.py:338-343``). The reference's stem is
    stride 1 where torchvision's is stride 2; the weights transfer unchanged.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from u2mkd_tpu_torch.ops.spconv import kernel_offsets

_MODULE_RENAMES = (
    (re.compile(r"^(SparseConv|SparseDownConv|SparseDeconv)_(\d+)$"), r"conv\2"),
    (re.compile(r"^MaskedBatchNorm_(\d+)$"), r"bn\1"),
    (re.compile(r"^Dense_(\d+)$"), r"fc\1"),
)
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Dict, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        if hasattr(val, "items"):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _key(path: Tuple[str, ...], leaf: str) -> str:
    out = []
    for name in path:
        for pat, rep in _MODULE_RENAMES:
            name = pat.sub(rep, name)
        out.append(name)
    return ".".join(out + [leaf])


def from_flax(params: Dict, batch_stats: Dict) -> Dict[str, torch.Tensor]:
    """Flax ``params`` and ``batch_stats`` (nested dicts of arrays) -> a
    state dict of f32 tensors (copies) for the port's counterpart."""
    sd = {}
    for path, arr in _leaves(params):
        leaf = path[-1]
        if leaf == "kernel" and arr.ndim == 2:
            name, arr = "weight", arr.T
        elif leaf == "kernel" and arr.ndim == 4:
            name, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif leaf == "scale":
            name = "weight"
        else:
            name = leaf
        sd[_key(path[:-1], name)] = torch.from_numpy(np.array(arr, np.float32))
    for path, arr in _leaves(batch_stats):
        sd[_key(path[:-1], _STAT_NAMES[path[-1]])] = torch.from_numpy(np.array(arr, np.float32))
    return sd


def _conv(w) -> np.ndarray:
    """torch conv [O, I, kh, kw] -> flax [kh, kw, I, O]."""
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _lin(w) -> np.ndarray:
    """torch Linear [out, in] -> flax Dense [in, out]."""
    return np.ascontiguousarray(np.asarray(w).T)


def _count(tree) -> int:
    return sum(_count(v) for v in tree.values()) if isinstance(tree, dict) else 1


def convert_resnet_to_swiftnet(state_dict: Dict, layers=(2, 2, 2, 2)) -> Tuple[dict, dict]:
    """A torchvision ResNet state dict -> flax-shaped (params, batch_stats)
    trees of the image branch (``pix_branch``): ``conv1``/``bn1`` and
    ``layer{L}.{B}.conv{1,2}``/``bn{1,2}``/``downsample.{0,1}`` ->
    ``layer{L}_{B}`` blocks. Keys absent from ``state_dict`` are absent from
    the trees."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    params: dict = {}
    stats: dict = {}

    def bn(prefix):
        return ({"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]},
                {"mean": sd[f"{prefix}.running_mean"], "var": sd[f"{prefix}.running_var"]})

    if "conv1.weight" in sd:
        params["conv1"] = {"kernel": _conv(sd["conv1.weight"])}
    if "bn1.weight" in sd:
        params["bn1"], stats["bn1"] = bn("bn1")
    for li, n_blocks in enumerate(layers):
        for bi in range(n_blocks):
            t = f"layer{li + 1}.{bi}"
            scope = f"layer{li + 1}_{bi}"
            blk: dict = {}
            if f"{t}.conv1.weight" in sd:
                blk["conv1"] = {"kernel": _conv(sd[f"{t}.conv1.weight"])}
                blk["conv2"] = {"kernel": _conv(sd[f"{t}.conv2.weight"])}
            for bn_i in (1, 2):
                if f"{t}.bn{bn_i}.weight" in sd:
                    blk[f"bn{bn_i}"], stats.setdefault(scope, {})[f"bn{bn_i}"] = bn(
                        f"{t}.bn{bn_i}")
            if f"{t}.downsample.0.weight" in sd:
                blk["down_conv"] = {"kernel": _conv(sd[f"{t}.downsample.0.weight"])}
                blk["down_bn"], stats.setdefault(scope, {})["down_bn"] = bn(f"{t}.downsample.1")
            if blk:
                params[scope] = blk
    return params, stats


def convert_swiftnet_full(state_dict: Dict, layers=(2, 2, 2, 2)) -> Tuple[dict, dict]:
    """A whole reference ``SwiftNetResNet`` state dict -> flax-shaped trees:
    the ResNet backbone, the SPP (``spp.spp.{spp_bn,spp0..2,spp_fuse}``) and
    the decoder (``upsample.{i}.{bottleneck,blend_conv}``; reference
    ``swiftnet.py:120-330``)."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    params, stats = convert_resnet_to_swiftnet(sd, layers)

    def put_brc(scope, leaf, prefix):
        """A ``_BNReluConv``: its norm (BN) and conv."""
        if f"{prefix}.conv.weight" not in sd:
            return
        params.setdefault(scope, {})[leaf] = {
            "norm": {"scale": sd[f"{prefix}.norm.weight"], "bias": sd[f"{prefix}.norm.bias"]},
            "conv": {"kernel": _conv(sd[f"{prefix}.conv.weight"])}}
        stats.setdefault(scope, {})[leaf] = {
            "norm": {"mean": sd[f"{prefix}.norm.running_mean"],
                     "var": sd[f"{prefix}.norm.running_var"]}}

    for name in ("spp_bn", "spp0", "spp1", "spp2", "spp_fuse"):
        put_brc("spp", name, f"spp.spp.{name}")
    for i in range(3):
        put_brc(f"up{i}", "bottleneck", f"upsample.{i}.bottleneck")
        put_brc(f"up{i}", "blend_conv", f"upsample.{i}.blend_conv")
    return params, stats


def _ts_offsets(ks: int) -> np.ndarray:
    """torchsparse 1.4's ``get_kernel_offsets`` order: per axis
    ``arange(-ks//2+1, ks//2+1)``; odd kernel volume z-outer/x-fastest,
    even x-outer/z-fastest."""
    rng = list(range(-ks // 2 + 1, ks // 2 + 1))
    if (ks ** 3) % 2 == 1:
        offs = [(x, y, z) for z in rng for y in rng for x in rng]
    else:
        offs = [(x, y, z) for x in rng for y in rng for z in rng]
    return np.asarray(offs, np.int64)


def _ts_kernel_perm(ks: int) -> np.ndarray:
    """perm[k] = the torchsparse index of the port's offset k, so that
    ``w[perm]`` puts a torchsparse kernel in :func:`kernel_offsets` order."""
    lut = {tuple(o): i for i, o in enumerate(_ts_offsets(ks))}
    return np.asarray([lut[tuple(o)] for o in kernel_offsets(ks).astype(np.int64)], np.int64)


class _TorchKeyReader:
    """A state dict that records which keys were read and which were
    missing, so that the teacher import can be strict (the reference loads
    its stage-1 teacher with ``strict=True``, ``nusc_trainers.py:199``)."""

    def __init__(self, sd: Dict):
        self.sd = {k: np.asarray(v) for k, v in sd.items()}
        self.used = set()
        self.missing: List[str] = []

    def __contains__(self, key: str) -> bool:
        return key in self.sd

    def take(self, key: str) -> Optional[np.ndarray]:
        if key not in self.sd:
            self.missing.append(key)
            return None
        self.used.add(key)
        return self.sd[key]

    def unused(self) -> List[str]:
        return sorted(k for k in self.sd
                      if k not in self.used and not k.endswith("num_batches_tracked"))


def convert_spvcnn_spformer(state_dict: Dict) -> Tuple[dict, dict, _TorchKeyReader]:
    """A reference ``SPVCNN_SPFORMER`` state dict -> flax-shaped (params,
    batch_stats) trees of ``SPVCNN(sphereformer=True)`` and the key reader.
    Key map (reference ``spvcnn_spformer.py:36-117``, ``build_blocks.py:21-84``):

      stem.{0,3}/.{1,4}          -> stem{0,1}/{SparseConv_0, MaskedBatchNorm_0}
      vox_downs.{i}.0.net.{0,1}  -> down{i}_conv
      vox_downs.{i}.{1,2}        -> down{i}_res{0,1} (net.0/1/3/4 + downsample)
      transformer_blocks.{i}     -> sphereformer{i+1} (norms, attention, MLP, RPE tables)
      vox_ups.{i}.0 / .1.{0,1}   -> up{i}_deconv / up{i}_res{0,1}
      point_transforms.{i}.{0,1} -> point_transform{i}/{Dense_0, MaskedBatchNorm_0}
      classifier_vox.0           -> classifier_vox
    """
    r = _TorchKeyReader(state_dict)
    perm = {3: _ts_kernel_perm(3), 2: _ts_kernel_perm(2)}
    params: dict = {}
    stats: dict = {}

    def sp_kernel(key, ks):
        w = r.take(key)
        if w is None:
            return None
        if ks == 1:
            return w[None] if w.ndim == 2 else w
        return np.ascontiguousarray(w[perm[ks]])

    def put_bn(scope, leaf, prefix):
        w = r.take(f"{prefix}.weight")
        if w is None:
            return
        params.setdefault(scope, {})[leaf] = {"scale": w, "bias": r.take(f"{prefix}.bias")}
        stats.setdefault(scope, {})[leaf] = {"mean": r.take(f"{prefix}.running_mean"),
                                             "var": r.take(f"{prefix}.running_var")}

    def put_res_block(scope, prefix):
        blk = params.setdefault(scope, {})
        blk["SparseConv_0"] = {"kernel": sp_kernel(f"{prefix}.net.0.kernel", 3)}
        put_bn(scope, "MaskedBatchNorm_0", f"{prefix}.net.1")
        blk["SparseConv_1"] = {"kernel": sp_kernel(f"{prefix}.net.3.kernel", 3)}
        put_bn(scope, "MaskedBatchNorm_1", f"{prefix}.net.4")
        if f"{prefix}.downsample.0.kernel" in r:
            blk["SparseConv_2"] = {"kernel": sp_kernel(f"{prefix}.downsample.0.kernel", 1)}
            put_bn(scope, "MaskedBatchNorm_2", f"{prefix}.downsample.1")

    # the stem: Sequential(conv, BN, ReLU, conv, BN, ReLU)
    for ours, t_conv, t_bn in (("stem0", "stem.0", "stem.1"), ("stem1", "stem.3", "stem.4")):
        params[ours] = {"SparseConv_0": {"kernel": sp_kernel(f"{t_conv}.kernel", 3)}}
        put_bn(ours, "MaskedBatchNorm_0", t_bn)

    for i in range(4):
        scope = f"down{i}_conv"
        params[scope] = {"SparseDownConv_0": {
            "kernel": sp_kernel(f"vox_downs.{i}.0.net.0.kernel", 2)}}
        put_bn(scope, "MaskedBatchNorm_0", f"vox_downs.{i}.0.net.1")
        put_res_block(f"down{i}_res0", f"vox_downs.{i}.1")
        put_res_block(f"down{i}_res1", f"vox_downs.{i}.2")

    for i in range(4):
        t = f"transformer_blocks.{i}"
        attn = {"qkv": {"kernel": _lin(r.take(f"{t}.attn.qkv.weight")),
                        "bias": r.take(f"{t}.attn.qkv.bias")},
                "proj": {"kernel": _lin(r.take(f"{t}.attn.proj.weight")),
                         "bias": r.take(f"{t}.attn.proj.bias")}}
        for ours_n, theirs_n in (("q", "query"), ("k", "key"), ("v", "value")):
            attn[f"rel_{ours_n}_cubic"] = r.take(f"{t}.attn.relative_pos_{theirs_n}_table")
            attn[f"rel_{ours_n}_sphere"] = r.take(
                f"{t}.attn.relative_pos_{theirs_n}_table_sphere")
        params[f"sphereformer{i + 1}"] = {
            "attn": attn,
            "norm1": {"scale": r.take(f"{t}.norm1.weight"), "bias": r.take(f"{t}.norm1.bias")},
            "norm2": {"scale": r.take(f"{t}.norm2.weight"), "bias": r.take(f"{t}.norm2.bias")},
            "mlp_fc1": {"kernel": _lin(r.take(f"{t}.mlp.fc1.weight")),
                        "bias": r.take(f"{t}.mlp.fc1.bias")},
            "mlp_fc2": {"kernel": _lin(r.take(f"{t}.mlp.fc2.weight")),
                        "bias": r.take(f"{t}.mlp.fc2.bias")}}

    for i in range(4):
        scope = f"up{i}_deconv"
        params[scope] = {"SparseDeconv_0": {
            "kernel": sp_kernel(f"vox_ups.{i}.0.net.0.kernel", 2)}}
        put_bn(scope, "MaskedBatchNorm_0", f"vox_ups.{i}.0.net.1")
        put_res_block(f"up{i}_res0", f"vox_ups.{i}.1.0")
        put_res_block(f"up{i}_res1", f"vox_ups.{i}.1.1")

    for i in range(3):
        t = f"point_transforms.{i}"
        params[f"point_transform{i}"] = {"Dense_0": {"kernel": _lin(r.take(f"{t}.0.weight")),
                                                     "bias": r.take(f"{t}.0.bias")}}
        put_bn(f"point_transform{i}", "MaskedBatchNorm_0", f"{t}.1")

    params["classifier_vox"] = {"kernel": _lin(r.take("classifier_vox.0.weight")),
                                "bias": r.take("classifier_vox.0.bias")}
    return params, stats, r


def _strip_prefixes(sd: Dict, extra: str = "") -> Dict:
    """Unwrap a trainer's nesting and DDP's naming: a raw state dict,
    ``{'model': sd}`` (reference ``spformer_trainer.py:124-130``),
    ``module.``-prefixed keys (stripped by the reference's loader,
    ``nusc_trainers.py:192-196``), and an ``extra`` prefix (``model_t.``
    takes the teacher out of a stage-2 checkpoint)."""
    if "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    for prefix in ("module.", extra):
        if prefix and any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    return sd


def _read_state_dict(path: str) -> Dict:
    return torch.load(path, map_location="cpu", weights_only=True)


def _numpy(sd: Dict) -> Dict[str, np.ndarray]:
    return {k: v.numpy() if torch.is_tensor(v) else v for k, v in sd.items()}


def load_teacher_pt(path: str, model: torch.nn.Module, scope: Optional[str] = None,
                    sub_prefix: str = "") -> Dict[str, List[str]]:
    """Load a reference ``SPVCNN_SPFORMER`` ``.pt`` into ``model`` (strict):
    every parameter and BN statistic of the target is assigned, with its
    shape; leftover tensors of the file are reported. ``scope`` names the
    target submodule (``'model_t'``: the TSD wrapper's frozen teacher,
    reference ``nusc_trainers.py:190-199``; None: ``model`` itself);
    ``sub_prefix='model_t.'`` takes the teacher out of a stage-2
    checkpoint. -> {"loaded": the target's keys, "leftover": the file's
    unused keys}."""
    return teacher_from_state_dict(_read_state_dict(path), model, scope, sub_prefix, path)


def teacher_from_state_dict(state: Dict, model: torch.nn.Module, scope: Optional[str] = None,
                            sub_prefix: str = "", source: str = "") -> Dict[str, List[str]]:
    """:func:`load_teacher_pt` on what such a file holds (``source`` names
    it in errors)."""
    sd = _numpy(_strip_prefixes(state, extra=sub_prefix))
    params, stats, reader = convert_spvcnn_spformer(sd)
    if reader.missing:
        raise ValueError(f"teacher checkpoint {source!r}: {len(reader.missing)} expected keys "
                         f"absent (first: {reader.missing[:5]}): not an SPVCNN_SPFORMER "
                         f"state_dict?")
    target = model.get_submodule(scope) if scope else model
    want = target.state_dict()
    got = from_flax(params, stats)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"teacher import mismatch: {len(missing)} target tensors unassigned "
                         f"(first: {missing[:3]}), {len(extra)} converted tensors unknown "
                         f"(first: {extra[:3]})")
    for k, v in want.items():
        if tuple(v.shape) != tuple(got[k].shape):
            raise ValueError(f"teacher import shape mismatch at {k}: target "
                             f"{tuple(v.shape)} vs checkpoint {tuple(got[k].shape)} "
                             f"(wrong cr_t / num_classes?)")
    leftover = reader.unused()
    if leftover:
        print(f"[convert_weights] teacher import: {len(leftover)} torch tensors unused "
              f"(first: {leftover[:5]})")
    target.load_state_dict(got)
    return {"loaded": sorted(got), "leftover": leftover}


def load_imagenet_pretrain(path: str, model: torch.nn.Module,
                           scope: str = "pix_branch") -> int:
    """Load a torchvision ResNet checkpoint into ``model``'s submodule
    ``scope`` (the image branch of the student) -> the number of tensors
    loaded. Expected file (reference ``swiftnet.py:338-343``): torchvision's
    ``resnet18-5c106cde.pth``; its 122 entries are 102 tensors and 20
    ``num_batches_tracked`` counters, and the backbone takes 100 of the
    tensors (all but ``fc.weight``/``fc.bias``, which the reference drops
    with ``strict=False``). A file that matches no backbone tensor raises;
    a matched tensor of another shape than its target raises."""
    sd = _read_state_dict(path)
    params, stats = convert_resnet_to_swiftnet(_numpy(sd))
    n_loaded = _count(params) + _count(stats)
    if n_loaded == 0:
        raise ValueError(f"ImageNet pretrain {path!r}: no torchvision-resnet keys found (got "
                         f"{sorted(sd)[:5]}...): wrong file? Expected a "
                         f"resnet18-5c106cde.pth-style state_dict")
    target = model.get_submodule(scope)
    want = target.state_dict()
    got = from_flax(params, stats)
    for k, v in got.items():
        if k not in want or tuple(want[k].shape) != tuple(v.shape):
            raise ValueError(f"ImageNet pretrain {path!r}: {k} {tuple(v.shape)} has no target "
                             f"of that shape in {scope}")
    target.load_state_dict(got, strict=False)
    print(f"[convert_weights] loaded {n_loaded} backbone tensors from {path}")
    return n_loaded
