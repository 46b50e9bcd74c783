"""Shared layers: the random layers (Dropout, DropPath, FastDropout and
``fast_keep_mask``), ``checkpoint`` (remat of a layer that keeps their
draws), 3-D depthwise conv, Mix-FFN Mlp, and seeded weight init.

Port of the JAX package's ``nn/layers.py``.  Tokens stay channels-last
``(B, N, C)``; ``DWConv3d`` convolves them in that layout
(``kernels/dwconv3d.py``).  State-dict keys are the reference Vivim's
(``mlp.fc1``, ``mlp.dwconv.dwconv``, ``mlp.fc2``).

Random numbers come only from explicit ``torch.Generator``s, as JAX's come
from explicit keys: a random layer in training draws from its
``generator`` attribute, which whoever runs the step sets
(``use_generator``; the train step passes the one it owns), and raises
when none is set.  The global random state is never read.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from vivim_tpu_torch.kernels import dwconv3d
from vivim_tpu_torch.parallel import comm
from vivim_tpu_torch.utils.profiling import span


class Stochastic(nn.Module):
    """Base of the layers that draw random numbers in training, from
    ``self.generator`` (a ``torch.Generator`` on the activations' device).
    Identity in eval and at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator = None

    def active(self):
        if self.rate == 0.0 or not self.training:
            return False
        if self.generator is None:
            raise RuntimeError(
                f"{type(self).__name__} draws from an explicit generator in "
                "training: set one with use_generator(model, generator)")
        return True


def use_generator(model: nn.Module, generator) -> nn.Module:
    """Point every random layer under ``model`` at ``generator``."""
    for m in model.modules():
        if isinstance(m, Stochastic):
            m.generator = generator
    return model


def checkpoint(module: nn.Module, *args):
    """``module(*args)`` under ``torch.utils.checkpoint`` (non-reentrant):
    the activations inside are dropped after the forward and recomputed in
    the backward (the JAX package's ``nn.remat`` of a layer).

    The recompute must repeat the forward exactly, and two things would
    make it differ:
    - the random layers inside draw from explicit generators, which
      checkpoint's own RNG stash does not cover: the generators' states are
      saved before the forward, set again for the recompute, and put back
      after it, so the recompute draws the forward's masks and every later
      draw is the one it would be without remat;
    - under ``torch.func.functional_call`` (the bf16 step's cast
      parameters) the module holds the swapped-in tensors only during the
      forward: the recompute runs on the same tensors.

    A BatchNorm inside would update its running statistics twice: the
    region must hold none.  Without autograd this is ``module(*args)``."""
    mods = list(module.modules())
    if any(isinstance(m, nn.modules.batchnorm._BatchNorm) for m in mods):
        raise ValueError(f"{type(module).__name__} holds a BatchNorm: its "
                         "running statistics would update again in the "
                         "recompute")
    if not torch.is_grad_enabled():
        return module(*args)
    gens = list({id(m.generator): m.generator for m in mods
                 if isinstance(m, Stochastic) and m.generator is not None}
                .values())
    saved = [g.get_state() for g in gens]
    params = dict(module.named_parameters())
    forward_done = False

    def run(*a):
        nonlocal forward_done
        if not forward_done:
            forward_done = True
            return module(*a)
        now = [g.get_state() for g in gens]
        for g, s in zip(gens, saved):
            g.set_state(s)
        try:
            return torch.func.functional_call(module, params, a)
        finally:  # also when checkpoint stops the recompute early
            for g, s in zip(gens, now):
                g.set_state(s)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False,
                                             preserve_rng_state=False)


def fast_keep_mask(generator, keep: float, shape, device):
    """Keep-mask from uint8 random bits: ``bits < round(keep * 256)``, the
    keep probability quantized to 1/256.  Returns (mask, the exact
    quantized keep, for rescaling)."""
    q = int(round(keep * 256.0))
    if q >= 256:  # keep so close to 1 that the uint8 grid rounds to "all"
        return torch.ones(shape, dtype=torch.bool, device=device), 1.0
    bits = torch.randint(0, 256, tuple(shape), generator=generator,
                         device=device, dtype=torch.uint8)
    return bits < q, q / 256.0


class Dropout(Stochastic):
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale the kept
    by 1/(1 - rate).  ``broadcast_dims`` share one draw along those axes
    (``(1, 2)`` on (N, H, W, C) is channelwise Dropout2d).  With
    ``seq_group``, x is this rank's shard of dim 1 of that group's tensor:
    the mask is drawn whole, as one device draws it, and this rank keeps
    its slice."""

    def __init__(self, rate: float, broadcast_dims=()):
        super().__init__(rate)
        self.broadcast_dims = tuple(broadcast_dims)

    def forward(self, x, seq_group=None):
        if not self.active():
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.rate
        n = comm.size(seq_group)
        shape = [1 if i in self.broadcast_dims else s * (n if i == 1 else 1)
                 for i, s in enumerate(x.shape)]
        mask = torch.rand(shape, generator=self.generator,
                          device=x.device) < keep
        if n > 1 and 1 not in self.broadcast_dims:
            ls = x.shape[1]
            mask = mask.narrow(1, comm.rank(seq_group) * ls, ls)
        return torch.where(mask, x / keep, 0.0)


class DropPath(Stochastic):
    """Stochastic depth: in training, zero a sample's branch with
    probability ``rate`` and scale survivors by 1/(1-rate)."""

    def __init__(self, rate: float = 0.0):
        super().__init__(rate)

    def forward(self, x):
        if not self.active():
            return x
        keep = 1.0 - self.rate
        mask = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1),
                          generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, 0.0)


class FastDropout(Stochastic):
    """Dropout through ``fast_keep_mask`` (uint8 random bits), as the JAX
    package's ``FastDropout``."""

    def forward(self, x):
        if not self.active():
            return x
        mask, keep = fast_keep_mask(self.generator, 1.0 - self.rate, x.shape,
                                    x.device)
        return torch.where(mask, x / keep, 0.0)


class DWConv3d(nn.Module):
    """Depthwise 3x3x3 conv over (T, H, W) on frame-major tokens
    (reference vivim.py DWConv; key ``dwconv.dwconv``).

    The conv runs in fp32 whatever the input dtype (input, weight and bias
    cast up, the output cast back), as the JAX package sums this conv's taps
    in fp32: on the card one hand-written kernel forward and two backward
    (``kernels/dwconv3d.py``), reading the tokens channels-last and the
    weight in ``nn.Conv3d``'s layout; on the CPU ``F.conv3d``.  Its span
    ``dwconv3d`` covers the forward (the casts and the kernel)."""

    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv3d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x, nframes: int, H: int, W: int, seq_group=None):
        """x: (B, N, C) tokens, or with ``seq_group`` this rank's shard of
        them: the conv then runs on the whole sequence, gathered
        (``comm.seq_gather_partial``), and returns this rank's slice."""
        if seq_group is not None:
            ls = x.shape[1]
            whole = self(comm.seq_gather_partial(x, seq_group), nframes, H,
                         W)
            return whole.narrow(1, comm.rank(seq_group) * ls, ls)
        if x.shape[1] != nframes * H * W:
            raise ValueError(f"{x.shape[1]} tokens != {nframes}x{H}x{W}")
        with span("dwconv3d"):
            conv = self.dwconv
            return dwconv3d.DWConv3dFn.apply(
                x.float(), conv.weight.float(), conv.bias.float(), nframes,
                H, W).to(x.dtype)


class Mlp(nn.Module):
    """fc1 -> 3-D depthwise conv -> GELU -> dropout -> fc2 -> dropout.

    GELU is the exact erf form unless ``gelu_approximate`` (tanh form)."""

    def __init__(self, dim, hidden_dim=None, out_dim=None,
                 dropout_rate: float = 0.0, gelu_approximate: bool = False):
        super().__init__()
        hidden = hidden_dim or dim
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv3d(hidden)
        self.fc2 = nn.Linear(hidden, out_dim or dim)
        self.drop = Dropout(dropout_rate)
        self.approximate = "tanh" if gelu_approximate else "none"

    def forward(self, x, nframes: int, H: int, W: int, seq_group=None):
        """x: (B, N, C) tokens, or with ``seq_group`` this rank's shard."""
        x = self.fc1(x)
        x = self.dwconv(x, nframes, H, W, seq_group)
        x = self.drop(F.gelu(x, approximate=self.approximate), seq_group)
        return self.drop(self.fc2(x), seq_group)

    def init_parameters(self, gen):
        for lin in (self.fc1, self.fc2):  # trunc-normal(0.02), vivim.py:84-97
            nn.init.trunc_normal_(lin.weight, std=0.02, a=-2.0, b=2.0,
                                  generator=gen)
            nn.init.zeros_(lin.bias)


@torch.no_grad()
def init_weights(root: nn.Module, gen: torch.Generator) -> nn.Module:
    """Seeded init of every parameter under ``root`` (CPU generator).

    Plain Linear / conv layers get U(+-1/sqrt(fan_in)) weights and zero
    biases, norms unit scale and zero shift, BatchNorm running stats
    (0, 1); then modules with a scheme of their own (``init_parameters``)
    overwrite theirs.
    """
    for m in root.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d, nn.Conv3d)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            nn.init.uniform_(m.weight, -bound, bound, generator=gen)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm2d)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    for m in root.modules():
        if hasattr(m, "init_parameters"):
            m.init_parameters(gen)
    return root
