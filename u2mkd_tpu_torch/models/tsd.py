"""TSD wrapper: the frozen multisweep teacher and the cross-modal student.

Port of ``u2mkd_tpu/models/tsd.py``: ``model_s`` is the MSP2IFM student,
with an adapt layer mapping its stage-4 point features to the teacher's
width; ``model_t`` is the SPVCNN + SphereFormer teacher at ``cr_t`` on the
multisweep cloud. The teacher always runs in eval mode, without gradients,
and its outputs are detached. A ``process_group`` syncs the student's BN
statistics across data-parallel ranks; the frozen teacher, in eval mode,
takes none (as in JAX).
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch
from torch import nn

from u2mkd_tpu_torch.core.device import resolve_device
from u2mkd_tpu_torch.models.msp2ifm import SPVCNNSwiftNetMSP2IFM
from u2mkd_tpu_torch.models.plumbing import UNetPlumbing
from u2mkd_tpu_torch.models.spvcnn import SPVCNN


class TSDFull(nn.Module):
    def __init__(self, num_classes: int = 17, cr: float = 1.0, cr_t: float = 2.0,
                 in_channel: int = 4, in_channel_t: int = 4,
                 window_size=(0.3, 0.3, 0.3), window_size_sphere=(2.0, 2.0, 120.0),
                 quant_size=(0.3 / 24,) * 3, quant_size_sphere=(2.0 / 24, 2.0 / 24, 5.0),
                 window_size_scale=(2.0, 2.0), dropout_rate: float = 0.3,
                 drop_path_rate: float = 0.3, sphere_a: float = 0.0125,
                 head_dim: int = 16, run_pix_decoder: bool = True,
                 pallas_attention: bool = False, pallas_cubic: bool = True, generator=None,
                 process_group=None):
        super().__init__()
        self.cr, self.cr_t = cr, cr_t
        self.process_group = process_group
        self.in_channel, self.in_channel_t = in_channel, in_channel_t
        self.run_pix_decoder = run_pix_decoder
        self._common = dict(
            num_classes=num_classes, window_size=window_size,
            window_size_sphere=window_size_sphere, quant_size=quant_size,
            quant_size_sphere=quant_size_sphere, window_size_scale=window_size_scale,
            dropout_rate=dropout_rate, drop_path_rate=drop_path_rate, sphere_a=sphere_a,
            head_dim=head_dim, pallas_attention=pallas_attention, pallas_cubic=pallas_cubic)
        self.model_s = self.make_student(generator)
        self.model_t = self.make_teacher(generator)
        self.model_t.eval()

    def make_student(self, generator=None) -> SPVCNNSwiftNetMSP2IFM:
        """The student of this configuration: ``cr``, with its stage-4
        features adapted to the teacher's width, int(cr_t * 256), its BN
        synced over ``process_group``."""
        return SPVCNNSwiftNetMSP2IFM(
            cr=self.cr, in_channel=self.in_channel, adapt_out_ch=int(self.cr_t * 256),
            run_pix_decoder=self.run_pix_decoder, generator=generator,
            process_group=self.process_group, **self._common)

    def make_teacher(self, generator=None) -> SPVCNN:
        """The teacher of this configuration: SPVCNN + SphereFormer at
        ``cr_t``, returning its stage-4 point features."""
        return SPVCNN(cr=self.cr_t, in_channel=self.in_channel_t, return_point_feats=True,
                      generator=generator, **self._common)

    def train(self, mode: bool = True) -> "TSDFull":
        super().train(mode)
        self.model_t.eval()  # the teacher is frozen: eval mode always
        return self

    def set_plain(self, plain: bool) -> None:
        """Run the kernels' plain versions (True) or the kernels (False), in
        the student and the teacher."""
        self.model_s.set_plain(plain)
        self.model_t.set_plain(plain)

    def forward(self, student_batch: Dict[str, torch.Tensor], student_plumbing: UNetPlumbing,
                teacher_batch: Optional[Dict[str, torch.Tensor]] = None,
                teacher_plumbing: Optional[UNetPlumbing] = None,
                run_teacher: bool = True,
                generator: Optional[torch.Generator] = None, remat: bool = False) -> Dict:
        """Batches hold device tensors: the student's ``feats``, ``images``,
        ``pix_coords``, ``cam_masks`` and ``fov_mask``; the teacher's
        ``feats``. In training mode the student's dropout and drop path draw
        from ``generator`` (on the features' device). ``remat`` runs the
        student's segments checkpointed (the frozen teacher, without
        gradients, keeps nothing for a backward). Returns {"stu": the
        student's outputs} and, with ``run_teacher``, {"t": the teacher's
        outputs, detached}."""
        sb = student_batch
        out = {"stu": self.model_s(sb["feats"], student_plumbing, sb["images"],
                                   sb["pix_coords"], sb["cam_masks"], sb["fov_mask"],
                                   generator=generator, remat=remat)}
        if run_teacher:
            out["t"] = self.frozen_teacher(teacher_batch, teacher_plumbing)
        return out

    def frozen_teacher(self, teacher_batch: Dict[str, torch.Tensor],
                       teacher_plumbing: UNetPlumbing) -> Dict[str, torch.Tensor]:
        """The teacher's outputs on its own cloud: eval mode, no gradients,
        detached."""
        with torch.no_grad():
            t_out = self.model_t(teacher_batch["feats"], teacher_plumbing)
        return {k: v.detach() for k, v in t_out.items()}

    def lidar_only(self, student_batch: Dict[str, torch.Tensor],
                   student_plumbing: UNetPlumbing,
                   generator: Optional[torch.Generator] = None, remat: bool = False) -> Dict:
        """The camera-free student path (JAX ``lidar_only``): the student's
        LiDAR branch with each stage's learner in place of the image
        features. In training mode its dropout draws from ``generator`` (on
        the features' device), and ``remat`` runs its segments
        checkpointed, as in :meth:`forward`."""
        return self.model_s(student_batch["feats"], student_plumbing, None, None, None, None,
                            lidar_only=True, generator=generator, remat=remat)


def tsd_model(num_classes: int = 17, cr: float = 1.0, cr_t: float = 2.0,
              voxel_size: float = 0.05, head_dim: int = 16, seed: int = 0,
              device: Optional[Union[str, torch.device]] = None,
              pallas_attention: bool = True) -> TSDFull:
    """The stage-2 model of ``configs/nuscenes/train/spformer_tsd_full_ours_star.yaml``
    with the window geometry the JAX package's config factory derives from
    it: windows of 6 voxels quantized in 24 steps, sphere windows [2 deg,
    2 deg, 120 m] quantized in [2/24 deg, 2/24 deg, 5 m], both doubling per
    level; both models' attention runs kernel K3 unless ``pallas_attention``
    is off, as the config sets it. Random weights from ``seed``, in eval
    mode, on ``device`` (CUDA unless asked otherwise)."""
    dev = resolve_device(device)
    ws = voxel_size * 6
    gen = torch.Generator().manual_seed(seed)
    model = TSDFull(
        num_classes=num_classes, cr=cr, cr_t=cr_t, window_size=(ws, ws, ws),
        quant_size=(ws / 24, ws / 24, ws / 24), window_size_sphere=(2.0, 2.0, 120.0),
        quant_size_sphere=(2.0 / 24, 2.0 / 24, 5.0), window_size_scale=(2.0, 2.0),
        sphere_a=0.0125, head_dim=head_dim, pallas_attention=pallas_attention, generator=gen)
    return model.to(dev).eval()
