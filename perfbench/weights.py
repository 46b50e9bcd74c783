"""Seeded weights, made on the device in two large draws.

Each tensor of a state dict gets the init of its kind, by name (the
schemes of the mamba and SegFormer references): Mamba's ``A_log`` =
log(1..N), ``D`` = 1, ``dt_proj.bias`` the inverse softplus of a
log-uniform dt in [1e-3, 0.1], ``dt_proj.weight`` U(+-rank^-0.5), the
causal conv U(+-width^-0.5); the embedding and the Mamba layers' MLP
N(0, 0.02); norms 1 and 0 (BatchNorm statistics 0 and 1); every other
weight U(+-fan_in^-0.5), every other bias 0.  One ``torch.rand`` and one
``torch.randn`` on a generator on the device, seeded from ``seed``, feed
every tensor.  The same seed gives the same dict; the program and the
reference both load it.
"""

from __future__ import annotations

import math
import re

import torch

_A_LOG = re.compile(r"(^|\.)A(_[a-z])?_log$")
_D = re.compile(r"(^|\.)D(_[a-z])?$")
_NORM = re.compile(r"(norm|layer_norm|batch_norm)[^.]*\.(weight|bias)$")
_NORMAL = re.compile(r"(embedding\.weight|mlp\.fc[12]\.weight)$")


def generator(seed, device):
    return torch.Generator(device=device).manual_seed(int(seed) % 2 ** 63)


def kind(name, shape):
    """(kind, argument): "const" value, "arange_log", "uniform" bound,
    "normal" std or "dt_bias"."""
    if name.endswith("num_batches_tracked"):
        return "const", 0
    if name.endswith("running_mean"):
        return "const", 0.0
    if name.endswith("running_var"):
        return "const", 1.0
    if _A_LOG.search(name):
        return "arange_log", None
    if _D.search(name):
        return "const", 1.0
    m = _NORM.search(name)
    if m:
        return "const", 1.0 if m.group(2) == "weight" else 0.0
    if "dt_proj" in name and name.endswith("bias"):
        return "dt_bias", None
    if "dt_proj" in name:
        return "uniform", shape[1] ** -0.5
    if "conv1d" in name:
        return "uniform", shape[-1] ** -0.5 if name.endswith("weight") else 0.5
    if _NORMAL.search(name):
        return "normal", 0.02
    if name.endswith("bias"):
        return "const", 0.0
    return "uniform", 1.0 / math.sqrt(math.prod(shape[1:]) or 1)


def make(shapes, seed, device, dtype=torch.float32):
    """{name: tensor} for ``shapes`` ({name: (shape, dtype)} as a state dict
    gives them), from ``seed``, on ``device``."""
    kinds = {n: kind(n, s) for n, (s, _) in shapes.items()}
    size = lambda n: math.prod(shapes[n][0])
    n_uniform = sum(size(n) for n, (k, _) in kinds.items()
                    if k in ("uniform", "dt_bias"))
    n_normal = sum(size(n) for n, (k, _) in kinds.items() if k == "normal")
    gen = generator(seed, device)
    uni = torch.rand(n_uniform, generator=gen, device=device, dtype=dtype)
    nor = torch.randn(n_normal, generator=gen, device=device, dtype=dtype)
    out, iu, inn = {}, 0, 0
    for name, (shape, dt) in shapes.items():
        k, arg = kinds[name]
        n = size(name)
        if k == "uniform":
            t = (uni[iu:iu + n] * 2 - 1) * arg
            iu += n
        elif k == "dt_bias":
            lo, hi = math.log(1e-3), math.log(0.1)
            dts = torch.exp(uni[iu:iu + n] * (hi - lo) + lo).clamp(min=1e-4)
            t = dts + torch.log(-torch.expm1(-dts))
            iu += n
        elif k == "normal":
            t = nor[inn:inn + n] * arg
            inn += n
        elif k == "arange_log":
            t = torch.log(torch.arange(1, shape[-1] + 1, device=device,
                                       dtype=dtype)).expand(shape)
        else:
            t = torch.full(shape, arg, device=device,
                           dtype=dt if not dt.is_floating_point else dtype)
        out[name] = t.reshape(shape).to(dt if not dt.is_floating_point
                                        else dtype).contiguous()
    return out


def shapes_of(module):
    """{name: (shape, dtype)} of a module's state dict (on any device,
    the meta device included)."""
    return {n: (tuple(t.shape), t.dtype)
            for n, t in module.state_dict().items()}
