"""The port's random init is one function of the seed on every machine.

torch's ``nn.init.trunc_normal_`` drew by the inverse CDF of one uniform
draw up to torch 2.12 and by rejection sampling from 2.13, so the same seed
gave the stage-2 student one init under torch 2.11 (the card's) and
another under torch 2.13. The port draws its truncated normals itself
(``models/blocks.trunc_normal_``); ``chip_smoke.py`` checks the digest of
the ablation's student init on the card against STUDENT_INIT_SHA256.
"""

import numpy as np
import torch

import chip_smoke
from u2mkd_tpu_torch.models.blocks import trunc_normal_

# nn.init.trunc_normal_(torch.empty(8), std=0.02, a=-0.04, b=0.04) from a
# CPU generator seeded 1588147245 (configs/default.yaml's train.seed), as
# torch 2.11.0+cu128 drew it on the card's machine
CARD_TRUNC_NORMAL = [-0.035493042320013046, 0.0027849103789776564, 0.03538075089454651,
                     -0.030654842033982277, 0.022469161078333855, -0.01010205689817667,
                     -0.03860197588801384, -0.006392244715243578]


def test_trunc_normal_draws_as_the_card():
    gen = torch.Generator().manual_seed(1588147245)
    got = trunc_normal_(torch.empty(8), 0.02, -0.04, 0.04, gen)
    np.testing.assert_array_equal(got.numpy(), np.asarray(CARD_TRUNC_NORMAL, np.float32))


def test_trunc_normal_is_truncated_and_scaled():
    gen = torch.Generator().manual_seed(0)
    x = trunc_normal_(torch.empty(200000), 0.5, -1.0, 1.0, gen)
    assert x.min() >= -1.0 and x.max() <= 1.0
    # N(0, 0.5) truncated at +-2 std keeps 0.774 of the unit normal's variance
    assert abs(x.std().item() - 0.5 * 0.87962566103423978) < 2e-3


def test_mini_student_init_is_pinned():
    """The ablation's student from ``tsd_mini.yaml``'s seed, whatever the
    global generator holds."""
    torch.manual_seed(123)
    assert chip_smoke.student_init_digest() == chip_smoke.STUDENT_INIT_SHA256
