"""Scan-mixing augmentations: PolarMix and LaserMix.

Port of ``u2mkd_tpu/data/mix.py``, the reference's config-gated mixers
(``core/datasets/utils.py:460-648``):

  * PolarMix (Xiao et al. 2022): swap an azimuth sector between two scans
    (p=0.5) and paste rotated copies of instance-class points.
  * LaserMix (Kong et al. 2023): split both scans into pitch-angle bands
    and interleave them.

No loader calls them, in either package.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class PolarMix:
    def __init__(self, instance_classes: Sequence[int],
                 rng: np.random.RandomState | None = None):
        self.instance_classes = list(instance_classes)
        self.rng = rng or np.random.RandomState()

    def __call__(self, pts1, labels1, pts2, labels2,
                 alpha: float | None = None, beta: float | None = None,
                 omegas: Sequence[float] | None = None):
        """``omegas``: explicit rotate-paste angles (reference PolarMix draws
        them once in __init__, utils.py:463); default draws from ``rng``."""
        rng = self.rng
        if alpha is None:
            alpha = rng.random() * np.pi * 2 / 3
        if beta is None:
            beta = alpha + np.pi  # sector width pi by convention
        out_pts, out_labels = pts1, labels1

        if rng.random() < 0.5:  # sector swap
            yaw1 = -np.arctan2(pts1[:, 1], pts1[:, 0])
            yaw2 = -np.arctan2(pts2[:, 1], pts2[:, 0])
            in1 = (yaw1 > alpha) & (yaw1 < beta)
            in2 = (yaw2 > alpha) & (yaw2 < beta)
            out_pts = np.concatenate([pts1[~in1], pts2[in2]])
            out_labels = np.concatenate([labels1[~in1], labels2[in2]])

        # rotate-paste instance points from scan 2 (original + 2 rotated copies)
        inst = np.isin(labels2, self.instance_classes)
        if inst.any():
            pi = pts2[inst]
            li = labels2[inst]
            if omegas is None:
                omegas = [rng.random() * np.pi * 2 / 3,
                          (rng.random() + 1) * np.pi * 2 / 3]
            copies, lcopies = [pi], [li]
            for om in omegas:
                c, s = np.cos(om), np.sin(om)
                rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
                p = pi.copy()
                p[:, :3] = pi[:, :3] @ rot
                copies.append(p)
                lcopies.append(li)
            out_pts = np.concatenate([out_pts] + copies)
            out_labels = np.concatenate([out_labels] + lcopies)
        return out_pts, out_labels


class LaserMix:
    def __init__(self, num_areas: List[int], pitch_angles: Tuple[float, float],
                 prob: float = 1.0, rng: np.random.RandomState | None = None):
        assert pitch_angles[1] > pitch_angles[0]
        self.num_areas = list(num_areas)
        self.pitch_angles = pitch_angles
        self.prob = prob
        self.rng = rng or np.random.RandomState()

    def __call__(self, pts1, labels1, pts2, labels2):
        rng = self.rng
        if rng.rand() > self.prob:
            return pts1, labels1, np.ones(len(pts1), bool)
        lo = self.pitch_angles[0] / 180 * np.pi
        hi = self.pitch_angles[1] / 180 * np.pi

        def pitch(p):
            rho = np.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2)
            return np.clip(np.arctan2(p[:, 2], rho), lo + 1e-5, hi - 1e-5)

        p1, p2 = pitch(pts1), pitch(pts2)
        n = rng.choice(self.num_areas)
        bands = np.linspace(hi, lo, n + 1)
        out_p, out_l, src1 = [], [], []
        for i in range(n):
            lo_b, hi_b = bands[i + 1], bands[i]
            if i % 2 == 0:
                m = (p1 > lo_b) & (p1 <= hi_b)
                out_p.append(pts1[m])
                out_l.append(labels1[m])
                src1.append(np.ones(int(m.sum()), bool))
            else:
                m = (p2 > lo_b) & (p2 <= hi_b)
                out_p.append(pts2[m])
                out_l.append(labels2[m])
                src1.append(np.zeros(int(m.sum()), bool))
        return (np.concatenate(out_p), np.concatenate(out_l),
                np.concatenate(src1))
