"""The plain reference of Vivim (MiT encoder, temporal Mamba layers, the
all-MLP decode), its training loss and its optimizer, in float32 PyTorch.

It follows the reference Vivim (Nicolo2277/Vivim ``modeling/vivim.py``)
as the program defines it: the per-stage SegFormer LayerNorm skipped, the
Mamba drop-path rate indexed by stage, LayerNorm eps 1e-6 in the MiT
stages and 1e-5 in the Mamba layers, the spatial-reduction conv padded
like "SAME", the eval decode fused per scale before the upsample and the
train decode fused after the gated per-scale dropout, BatchNorm with the
biased batch variance.  The tri-directional mixer (bimamba v3) runs its
three directions one after the other, each through the float64 scan of
``reference/scan.py`` (no kernel), and averages them.

The random layers draw from one ``torch.Generator`` in the order the
forward meets them, with the same calls (``torch.rand`` for Dropout and
DropPath, uint8 ``torch.randint`` for the quantized keep masks), so a
generator seeded as the program's train state draws the masks the
program drew.  Without a generator a random layer is the identity (the
FLOP count runs so, on the meta device).

Parameter names are the program's state-dict keys, so one state dict made
by the benchmark loads into both.  Imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference import scan as scan_lib

LN_EPS_MIT = 1e-6
LN_EPS_MAMBA = 1e-5


class Random(nn.Module):
    """A layer that draws in training from ``self.generator``."""

    def __init__(self, rate):
        super().__init__()
        self.rate = rate
        self.generator = None

    def active(self):
        return self.training and self.rate > 0.0 and self.generator is not None


def keep_mask(gen, keep, shape, device):
    """uint8 bits < round(keep * 256), and that quantized keep."""
    q = int(round(keep * 256.0))
    if q >= 256:
        return torch.ones(shape, dtype=torch.bool, device=device), 1.0
    bits = torch.randint(0, 256, tuple(shape), generator=gen, device=device,
                         dtype=torch.uint8)
    return bits < q, q / 256.0


class Dropout(Random):
    def __init__(self, rate, broadcast_dims=()):
        super().__init__(rate)
        self.broadcast_dims = tuple(broadcast_dims)

    def forward(self, x):
        if not self.active():
            return x
        keep = 1.0 - self.rate
        shape = [1 if i in self.broadcast_dims else s
                 for i, s in enumerate(x.shape)]
        mask = torch.rand(shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, 0.0)


class DropPath(Random):
    def forward(self, x):
        if not self.active():
            return x
        keep = 1.0 - self.rate
        mask = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1),
                          generator=self.generator, device=x.device) < keep
        return torch.where(mask, x / keep, 0.0)


class QuantizedDropout(Random):
    def forward(self, x):
        if not self.active():
            return x
        mask, keep = keep_mask(self.generator, 1.0 - self.rate, x.shape,
                               x.device)
        return torch.where(mask, x / keep, 0.0)


class ScaleDropout(Random):
    """With probability 1/2 a quantized dropout of the whole scale."""

    def forward(self, x):
        if not self.active():
            return x
        gate = torch.rand((), generator=self.generator, device=x.device) < 0.5
        mask, keep = keep_mask(self.generator, 1.0 - self.rate, x.shape,
                               x.device)
        return torch.where(gate, torch.where(mask, x / keep, 0.0), x)


def gelu(x, exact):
    return F.gelu(x, approximate="none" if exact else "tanh")


def resize(x, size):
    """Half-pixel bilinear resize of (N, H, W, C)."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                         mode="bilinear", align_corners=False
                         ).permute(0, 2, 3, 1)


def same_pads(n, k, s):
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


# ---------------------------------------------------------------- MiT


class PatchEmbed(nn.Module):
    def __init__(self, patch, stride, cin, cout):
        super().__init__()
        self.proj = nn.Conv2d(cin, cout, patch, stride, padding=patch // 2)
        self.layer_norm = nn.LayerNorm(cout, eps=LN_EPS_MIT)

    def forward(self, x):
        x = self.proj(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        n, h, w, c = x.shape
        return self.layer_norm(x.reshape(n, h * w, c)), h, w


class Attention(nn.Module):
    def __init__(self, dim, heads, sr, attn_drop, hidden_drop):
        super().__init__()
        self.heads, self.sr_ratio = heads, sr
        core = {k: nn.Linear(dim, dim) for k in ("query", "key", "value")}
        if sr > 1:
            core["sr"] = nn.Conv2d(dim, dim, sr, sr)
            core["layer_norm"] = nn.LayerNorm(dim, eps=LN_EPS_MIT)
        self.self = nn.ModuleDict(core)
        self.output = nn.ModuleDict({"dense": nn.Linear(dim, dim)})
        self.attn_drop = Dropout(attn_drop)
        self.out_drop = Dropout(hidden_drop)

    def forward(self, x, H, W):
        n, L, c = x.shape
        hd = c // self.heads
        core = self.self
        q = core["query"](x)
        kv = x
        if self.sr_ratio > 1:
            s = self.sr_ratio
            xs = x.reshape(n, H, W, c).permute(0, 3, 1, 2)
            ph, pw = same_pads(H, s, s), same_pads(W, s, s)
            xs = core["sr"](F.pad(xs, (pw[0], pw[1], ph[0], ph[1])))
            kv = core["layer_norm"](xs.flatten(2).transpose(1, 2))
        split = lambda t: t.reshape(n, -1, self.heads, hd).transpose(1, 2)
        k, v = split(core["key"](kv)), split(core["value"](kv))
        probs = ((split(q) @ k.transpose(-1, -2)) / math.sqrt(hd)).softmax(-1)
        ctx = (self.attn_drop(probs) @ v).transpose(1, 2).reshape(n, L, c)
        return self.out_drop(self.output["dense"](ctx))


class MixFFN(nn.Module):
    def __init__(self, dim, hidden, drop, exact):
        super().__init__()
        self.dense1 = nn.Linear(dim, hidden)
        self.dwconv = nn.Module()
        self.dwconv.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1,
                                       groups=hidden)
        self.dense2 = nn.Linear(hidden, dim)
        self.drop = Dropout(drop)
        self.exact = exact

    def forward(self, x, H, W):
        n, L, _ = x.shape
        x = self.dense1(x).reshape(n, H, W, -1).permute(0, 3, 1, 2)
        x = self.dwconv.dwconv(x).permute(0, 2, 3, 1).reshape(n, L, -1)
        x = self.drop(gelu(x, self.exact))
        return self.drop(self.dense2(x))


class MiTLayer(nn.Module):
    def __init__(self, dim, heads, sr, mlp_ratio, drop_path, seg, exact):
        super().__init__()
        self.layer_norm_1 = nn.LayerNorm(dim, eps=LN_EPS_MIT)
        self.attention = Attention(dim, heads, sr,
                                   seg["attention_probs_dropout_prob"],
                                   seg["hidden_dropout_prob"])
        self.layer_norm_2 = nn.LayerNorm(dim, eps=LN_EPS_MIT)
        self.mlp = MixFFN(dim, dim * mlp_ratio, seg["hidden_dropout_prob"],
                          exact)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, H, W):
        x = x + self.drop_path(self.attention(self.layer_norm_1(x), H, W))
        return x + self.drop_path(self.mlp(self.layer_norm_2(x), H, W))


class MiT(nn.Module):
    def __init__(self, seg, exact):
        super().__init__()
        depths = seg["depths"]
        total = sum(depths)
        rates = [seg["drop_path_rate"] * i / max(total - 1, 1)
                 for i in range(total)]
        cins = [seg["num_channels"]] + list(seg["hidden_sizes"][:-1])
        self.patch_embeddings = nn.ModuleList(
            PatchEmbed(seg["patch_sizes"][i], seg["strides"][i], cins[i],
                       seg["hidden_sizes"][i]) for i in range(len(depths)))
        self.block = nn.ModuleList()
        start = 0
        for i, d in enumerate(depths):
            self.block.append(nn.ModuleList(
                MiTLayer(seg["hidden_sizes"][i], seg["num_attention_heads"][i],
                         seg["sr_ratios"][i], seg["mlp_ratios"][i],
                         rates[start + j], seg, exact) for j in range(d)))
            start += d
        # the stage norms Vivim skips (kept: they are state-dict keys)
        self.layer_norm = nn.ModuleList(
            nn.LayerNorm(h, eps=LN_EPS_MIT) for h in seg["hidden_sizes"])

    def stage(self, i, x):
        tokens, H, W = self.patch_embeddings[i](x)
        for layer in self.block[i]:
            tokens = layer(tokens, H, W)
        return tokens, H, W


# ---------------------------------------------------------------- Mamba

DIRECTIONS = ("", "_b", "_s")


def frame_to_position(x, T):
    n, L, c = x.shape
    return x.reshape(n, T, L // T, c).transpose(1, 2).reshape(n, L, c)


def position_to_frame(x, T):
    n, L, c = x.shape
    return x.reshape(n, L // T, T, c).transpose(1, 2).reshape(n, L, c)


def no_scan(u, delta, A, B, C, D=None, z=None, delta_bias=None,
            delta_softplus=False):
    """The scan's stand-in in a FLOP count on the meta device (the scan's
    work is counted apart, from its frozen work counts)."""
    return u * z


def mixer_direction(x, z, p, scan):
    """One direction of a Mamba mixer: causal depthwise conv and SiLU, the
    x / dt projections, the scan gated by z.  ``p``: conv1d (weight (d, 1,
    W), bias), x_proj, dt_proj (weight, bias), A_log, D."""
    L = x.shape[1]
    w = p["conv1d.weight"]
    xc = F.conv1d(x.transpose(1, 2), w, p["conv1d.bias"],
                  padding=w.shape[-1] - 1, groups=w.shape[0])[..., :L]
    xc = F.silu(xc).transpose(1, 2)
    rank = p["dt_proj.weight"].shape[1]
    n = p["A_log"].shape[1]
    x_dbl = xc @ p["x_proj.weight"].t()
    delta = x_dbl[..., :rank] @ p["dt_proj.weight"].t()
    return scan(xc, delta, -torch.exp(p["A_log"]), x_dbl[..., rank:rank + n],
                x_dbl[..., rank + n:], D=p["D"], z=z,
                delta_bias=p["dt_proj.bias"], delta_softplus=True)


class Mixer(nn.Module):
    """Mamba mixer, parameters under the mamba reference's names, per
    direction suffix; ``directions`` 3 (bimamba v3, Vivim) or 1 (LM)."""

    def __init__(self, dim, d_state, d_conv, expand, directions=3):
        super().__init__()
        d = expand * dim
        rank = math.ceil(dim / 16)
        self.suffixes = DIRECTIONS[:directions]
        self.in_proj = nn.Linear(dim, 2 * d, bias=False)
        for s in self.suffixes:
            setattr(self, f"conv1d{s}", nn.Conv1d(d, d, d_conv, groups=d))
            setattr(self, f"x_proj{s}", nn.Linear(d, rank + 2 * d_state,
                                                  bias=False))
            setattr(self, f"dt_proj{s}", nn.Linear(rank, d))
            setattr(self, f"A{s}_log", nn.Parameter(torch.empty(d, d_state)))
            setattr(self, f"D{s}", nn.Parameter(torch.empty(d)))
        self.out_proj = nn.Linear(d, dim, bias=False)
        self.scan = scan_lib.selective_scan

    def params(self, s):
        return {"conv1d.weight": getattr(self, f"conv1d{s}").weight,
                "conv1d.bias": getattr(self, f"conv1d{s}").bias,
                "x_proj.weight": getattr(self, f"x_proj{s}").weight,
                "dt_proj.weight": getattr(self, f"dt_proj{s}").weight,
                "dt_proj.bias": getattr(self, f"dt_proj{s}").bias,
                "A_log": getattr(self, f"A{s}_log"),
                "D": getattr(self, f"D{s}")}

    def forward(self, x, T=1):
        xz = self.in_proj(x)
        d = xz.shape[-1] // 2
        if len(self.suffixes) == 1:
            out = mixer_direction(xz[..., :d], xz[..., d:], self.params(""),
                                  self.scan)
            return self.out_proj(out)
        views = (lambda t: t, lambda t: t.flip(1),
                 lambda t: frame_to_position(t, T))
        backs = (lambda t: t, lambda t: t.flip(1),
                 lambda t: position_to_frame(t, T))
        out = 0.0
        for s, view, back in zip(self.suffixes, views, backs):
            v = view(xz)
            out = out + back(mixer_direction(v[..., :d], v[..., d:],
                                             self.params(s), self.scan))
        return self.out_proj(out / 3.0)


class DWConv3d(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dwconv = nn.Conv3d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x, T, H, W):
        n, L, c = x.shape
        y = self.dwconv(x.reshape(n, T, H, W, c).permute(0, 4, 1, 2, 3))
        return y.permute(0, 2, 3, 4, 1).reshape(n, L, c)


class Mlp(nn.Module):
    def __init__(self, dim, hidden, exact):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv3d(hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.drop = Dropout(0.0)
        self.exact = exact

    def forward(self, x, T, H, W):
        x = self.dwconv(self.fc1(x), T, H, W)
        x = self.drop(gelu(x, self.exact))
        return self.drop(self.fc2(x))


class MambaLayer(nn.Module):
    def __init__(self, dim, cfg, drop_path, exact):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS_MAMBA)
        self.mamba = Mixer(dim, cfg["d_state"], cfg["d_conv"], cfg["expand"])
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS_MAMBA)
        self.mlp = Mlp(dim, int(dim * cfg["mlp_ratio"]), exact)
        self.drop_path = DropPath(drop_path)

    def forward(self, x, T, H, W):
        x = x + self.drop_path(self.mamba(self.norm1(x), T))
        return x + self.drop_path(self.mlp(self.norm2(x), T, H, W))


# ---------------------------------------------------------------- Vivim


class Vivim(nn.Module):
    """(B, T, H, W, 3) clips -> (B, T, H, W, classes) logits."""

    def __init__(self, cfg):
        super().__init__()
        seg = cfg["segformer"]
        exact = cfg["gelu"] == "exact"
        hid = seg["decoder_hidden_size"]
        sizes = seg["hidden_sizes"]
        depths = cfg["mamba_depths"]
        total = sum(depths)
        self.encoder = nn.Module()
        self.encoder.downsample_layers = MiT(seg, exact)
        self.encoder.stages = nn.ModuleList(
            nn.ModuleList(nn.Sequential(MambaLayer(
                sizes[i], cfg, cfg["drop_path_rate"] * i / max(total - 1, 1),
                exact)) for _ in range(depths[i]))
            for i in range(len(depths)))
        self.decoder = nn.Module()
        self.decoder.linear_c = nn.ModuleList(
            nn.ModuleDict({"proj": nn.Linear(c, hid)}) for c in sizes)
        self.decoder.linear_fuse = nn.Conv2d(len(sizes) * hid, hid, 1,
                                             bias=False)
        self.decoder.batch_norm = nn.BatchNorm2d(hid, eps=1e-5, momentum=0.1)
        self.out = nn.Conv2d(hid, cfg["num_classes"], 1)
        self.scale_drop = ScaleDropout(cfg["dropout_rate"] / 2)
        self.head_drop = nn.ModuleList(
            QuantizedDropout(seg["classifier_dropout_prob"]) for _ in range(2))
        self.feature_drop = Dropout(cfg["dropout_rate"], broadcast_dims=(1, 2))

    def set_generator(self, gen):
        for m in self.modules():
            if isinstance(m, Random):
                m.generator = gen

    def set_scan(self, fn):
        for m in self.modules():
            if isinstance(m, Mixer):
                m.scan = fn

    def forward(self, clip):
        B, T, H, W, _ = clip.shape
        h = clip.reshape(B * T, H, W, -1)
        feats = []
        mit = self.encoder.downsample_layers
        for i, stage in enumerate(self.encoder.stages):
            tokens, Hi, Wi = mit.stage(i, h)
            t5 = tokens.reshape(B, T * Hi * Wi, -1)
            for block in stage:
                t5 = block[0](t5, T, Hi, Wi)
            h = t5.reshape(B * T, Hi, Wi, -1)
            feats.append(h)
        hmap = self.decode_train(feats) if self.training \
            else self.decode_eval(feats)
        hmap = torch.relu(hmap)
        for drop in self.head_drop:
            hmap = drop(hmap)
        hmap = self.feature_drop(hmap)
        logits = hmap @ self.out.weight[:, :, 0, 0].t() + self.out.bias
        return resize(logits, (H, W)).reshape(B, T, H, W, -1)

    def decode_eval(self, feats):
        size = feats[0].shape[1:3]
        dec = self.decoder
        hid = dec.batch_norm.num_features
        n = len(feats)
        Wf = dec.linear_fuse.weight[:, :, 0, 0]
        hmap = 0.0
        for i, f in enumerate(feats):
            j = n - 1 - i        # the fuse concatenates the reversed scales
            t = dec.linear_c[i]["proj"](f) @ Wf[:, j * hid:(j + 1) * hid].t()
            hmap = hmap + resize(t, size)
        bn = dec.batch_norm
        return ((hmap - bn.running_mean) * torch.rsqrt(bn.running_var + bn.eps)
                * bn.weight + bn.bias)

    def decode_train(self, feats):
        size = feats[0].shape[1:3]
        dec = self.decoder
        scales = [self.scale_drop(resize(dec.linear_c[i]["proj"](f), size))
                  for i, f in enumerate(feats)]
        hmap = torch.cat(scales[::-1], -1) @ dec.linear_fuse.weight[:, :, 0,
                                                                     0].t()
        bn = dec.batch_norm
        mean = hmap.mean((0, 1, 2))
        var = hmap.var((0, 1, 2), unbiased=False)
        with torch.no_grad():
            bn.running_mean.lerp_(mean, bn.momentum)
            bn.running_var.lerp_(var, bn.momentum)
            bn.num_batches_tracked += 1
        return (hmap - mean) * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias


# ---------------------------------------------------------------- training

EPS = 1e-6


def recall_focused_loss(logits, targets, num_classes):
    """0.4 * class-weighted focal (alpha .05 / .475 / .475, gamma 2) + 0.6
    * Tversky (alpha 0.3 on false positives, beta 0.7 on false negatives),
    over (N, H, W, C) logits and (N, H, W) targets."""
    p = torch.softmax(logits, -1)
    t = F.one_hot(targets.long(), num_classes).to(p.dtype)
    tp = (p * t).sum((1, 2))
    fp = (p * (1 - t)).sum((1, 2))
    fn = ((1 - p) * t).sum((1, 2))
    tversky = (1 - ((tp + EPS) / (tp + 0.3 * fp + 0.7 * fn + EPS)).mean(0)
               ).mean()
    alpha = torch.tensor((0.05, 0.475, 0.475), dtype=p.dtype,
                         device=p.device)[:num_classes]
    focal_w = t * (1 - p) ** 2 + (1 - t) * p ** 2
    bce = -t * torch.log(p + EPS) - (1 - t) * torch.log(1 - p + EPS)
    focal = (alpha * focal_w * bce).mean((0, 1, 2)).sum()
    return 0.4 * focal + 0.6 * tversky


def clip_loss(model, clip, masks, num_classes):
    """The loss over every frame of a (B, T, ...) batch."""
    logits = model(clip)
    B, T, H, W, C = logits.shape
    return recall_focused_loss(logits.reshape(B * T, H, W, C),
                               masks.argmax(-1).reshape(B * T, H, W),
                               num_classes)


def decays(model):
    """{name: decayed}: weights of two or more dimensions, not A_log."""
    return {n: p.dim() >= 2 and not (n.split(".")[-1].startswith("A")
                                     and n.endswith("_log"))
            for n, p in model.named_parameters()}


class AdamW:
    """Global-norm clipping at ``clip``, then AdamW (0.9, 0.999, 1e-8) with
    a cosine from ``lr`` to ``lr * eta_min`` over ``total`` steps (the
    first update at ``lr``), weight decay on ``decays``."""

    def __init__(self, model, lr, weight_decay, total, eta_min=0.01,
                 clip=1.0):
        self.model = model
        self.lr, self.wd, self.total, self.eta_min = lr, weight_decay, total, \
            eta_min
        self.clip = clip
        self.decays = decays(model)
        self.mu = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
        self.nu = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
        self.count = 0
        self.last_grads = None

    def rate(self):
        frac = min(self.count, self.total) / max(self.total, 1)
        return self.lr * ((1 - self.eta_min) * 0.5 * (1 + math.cos(
            math.pi * frac)) + self.eta_min)

    @torch.no_grad()
    def step(self):
        named = [(n, p) for n, p in self.model.named_parameters()
                 if p.grad is not None]
        norm = torch.sqrt(sum((p.grad.double() ** 2).sum() for _, p in named))
        scale = self.clip / max(float(norm), self.clip)
        lr = self.rate()
        self.count += 1
        t = self.count
        self.last_grads = {}
        for n, p in named:
            g = p.grad * scale
            self.last_grads[n] = g
            self.mu[n].mul_(0.9).add_(g, alpha=0.1)
            self.nu[n].mul_(0.999).addcmul_(g, g, value=0.001)
            upd = (self.mu[n] / (1 - 0.9 ** t)) / (
                torch.sqrt(self.nu[n] / (1 - 0.999 ** t)) + 1e-8)
            if self.decays[n] and self.wd:
                upd = upd + self.wd * p
            p.sub_(lr * upd)
        return norm


def build(cfg, device):
    """The reference model on ``device`` (the meta device gives shapes)."""
    with torch.device(device):
        return Vivim(cfg)
