"""Initial weights made by the benchmark from the run's seed, on the device,
in two calls (one uniform draw, one normal draw for all leaves), in
float32, the type they train in. The harness copies them into the
program's parameters before its first step and hands the same tensors to
the plain reference.

Each leaf follows the initializer its role has in the published model
(han.pdf §5.3; the reference TF code's glorot-uniform kernels, zero
biases and normal(0.1) semantic-attention weights): a name ending in
``bias`` (not ``b_omega``) is zero, a ``semantic.`` leaf is normal with
std 0.1, any other leaf glorot-uniform with the fans of flax's
``variance_scaling`` (the last two axes are in and out, the leading axes
a receptive field).
"""

from __future__ import annotations

import math

import torch


def _kind(name: str) -> str:
    if name.startswith("semantic."):
        return "normal"
    if name.endswith("bias"):
        return "zero"
    return "glorot"


def make_weights(shapes: dict, seed: int, device) -> dict:
    """name → float32 tensor on ``device`` for every (name, shape) of
    ``shapes``, in name order."""
    names = sorted(shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = {n: math.prod(shapes[n]) for n in names}
    n_uniform = sum(sizes[n] for n in names if _kind(n) == "glorot")
    n_normal = sum(sizes[n] for n in names if _kind(n) == "normal")
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    normal = torch.randn(n_normal, generator=gen, device=device)
    out, iu, inn = {}, 0, 0
    for n in names:
        shape, size = tuple(shapes[n]), sizes[n]
        kind = _kind(n)
        if kind == "zero":
            out[n] = torch.zeros(shape, device=device)
        elif kind == "normal":
            out[n] = (normal[inn:inn + size] * 0.1).reshape(shape)
            inn += size
        else:
            receptive = math.prod(shape[:-2])
            fan_in = (shape[-2] if len(shape) > 1 else 1) * receptive
            fan_out = shape[-1] * receptive
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            out[n] = ((uniform[iu:iu + size] * 2.0 - 1.0) * limit).reshape(shape)
            iu += size
    return out
