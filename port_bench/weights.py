"""Random weights from the seed, made by the benchmark and handed alike to
the program and to the reference.

One ``randn`` call on the model's device fills every float parameter and
buffer of a state dict, taken in the order of their sorted names, so two
models with the same names and shapes receive the same values whatever
built them. Each tensor is scaled by a rule on its name and shape: matrix
and kernel weights by 1/sqrt(fan-in), the attention's position tables by
0.02, norm scales near 1, biases near 0, BN running means 0 and running
variances 1.
"""

from __future__ import annotations

from typing import Dict

import torch


def _fan_in(name: str, shape) -> int:
    numel = 1
    for s in shape:
        numel *= s
    if len(shape) == 3:      # sparse conv kernels [K, Cin, Cout]
        return numel // shape[-1]
    return numel // shape[0]  # Linear [out, in], Conv2d [out, in, kh, kw]


def fill(model: torch.nn.Module, seed: int) -> None:
    """Overwrite every float parameter and buffer of ``model`` in place with
    values drawn from ``seed`` on the model's device."""
    state: Dict[str, torch.Tensor] = {k: v for k, v in model.state_dict().items()
                                      if v.is_floating_point()}
    names = sorted(state)
    device = state[names[0]].device
    total = sum(state[k].numel() for k in names)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    noise = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    at = 0
    with torch.no_grad():
        for k in names:
            t = state[k]
            n = noise[at:at + t.numel()].view(t.shape)
            at += t.numel()
            leaf = k.rsplit(".", 1)[-1]
            if leaf == "running_mean":
                val = torch.zeros_like(n)
            elif leaf == "running_var":
                val = torch.ones_like(n)
            elif leaf.startswith("rel_"):
                val = 0.02 * n
            elif t.dim() == 1:
                val = 1.0 + 0.1 * n if leaf == "weight" else 0.02 * n
            else:
                val = n * _fan_in(k, tuple(t.shape)) ** -0.5
            t.copy_(val.to(t.dtype))


def nudge(model: torch.nn.Module, seed: int) -> None:
    """Move every float parameter of ``model`` by one ulp of its type, up or
    down as a draw from ``seed`` says: the least change the type can hold."""
    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(int(seed))
    with torch.no_grad():
        for _, p in sorted(model.named_parameters()):
            if p.is_floating_point():
                up = torch.rand(p.shape, generator=gen, device=p.device) < 0.5
                inf = torch.tensor(float("inf"), dtype=p.dtype, device=p.device)
                p.copy_(torch.nextafter(p, torch.where(up, inf, -inf)))
