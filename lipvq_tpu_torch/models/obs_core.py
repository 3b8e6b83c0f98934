"""Visual and scan encoder cores and the image randomizers (counterpart of
``lipvq_tpu/models/obs_core.py``).

- ``ResNet18Conv`` / ``ResNet34Conv`` / ``ResNet50Conv`` (``ResNetConv``):
  the ResNet trunk without avgpool and fc, [B, 3, H, W] -> [B, C, H/32,
  W/32]; FiLM after each stage when given a condition
- ``ShallowConv``, ``Conv1dBase`` (range scans), ``SpatialSoftmax``,
  ``SpatialMeanPool``, ``CrossAttentionConditioner``
- ``ColorRandomizer``, ``GaussianNoiseRandomizer``, ``CropRandomizer``
- ``VisualCore``: randomizers -> backbone -> pool -> linear + ReLU;
  ``build_core`` picks it (``VisualCoreLanguageConditioned``: FiLM on the
  ``lang_emb`` key) or ``ScanCore``
- ``PretrainedReprConv`` / ``R3MConv`` / ``MVPConv``: a frozen ResNet-18,
  randomly initialized only

Observations stay NHWC float in [0, 1] (the JAX package's contract).
``VisualCore`` takes them so and hands its trunk a contiguous [B, C, H, W]
copy: cuDNN's fp32 convolutions on the H100 run NCHW kernels and transpose
a ``channels_last`` input to them, which measured slower (``PERF.md``);
every trunk module here takes and returns channels-first tensors. Module and parameter names are flax's, joined by
dots (``utils/jax_weights.py`` maps them). BatchNorm statistics advance only
with ``train=True``; the randomizers draw from the ``generator`` passed with
it (the algo's dropout generator, as JAX draws from its ``"dropout"`` RNG)
and are the identity otherwise.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from lipvq_tpu_torch.models.base_nets import (
    BatchNorm,
    Conv,
    FiLMLayer,
    MultiHeadDotProductAttention,
    TorchLinear,
)

_PAD1 = ((1, 1), (1, 1))


def _need_generator(generator):
    if generator is None:
        raise ValueError("a randomizer in training needs a torch.Generator")
    return generator


# ---------------------------------------------------------------------------
# ResNet trunks
# ---------------------------------------------------------------------------

class _BasicBlock(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(in_features, features, (3, 3), stride, _PAD1, bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv(features, features, (3, 3), 1, _PAD1, bias=False)
        self.bn2 = BatchNorm(features)
        self.downsample = in_features != features or stride != 1
        if self.downsample:
            self.downsample_conv = Conv(in_features, features, (1, 1), stride, bias=False)
            self.downsample_bn = BatchNorm(features)
        self.out_features = features

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = self.bn2(self.conv2(y), train)
        residual = x
        if self.downsample:
            residual = self.downsample_bn(self.downsample_conv(x), train)
        return F.relu(y + residual)


class _Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 with 4x expansion."""

    def __init__(self, in_features: int, features: int, stride: int = 1):
        super().__init__()
        out = 4 * features
        self.conv1 = Conv(in_features, features, (1, 1), bias=False)
        self.bn1 = BatchNorm(features)
        self.conv2 = Conv(features, features, (3, 3), stride, _PAD1, bias=False)
        self.bn2 = BatchNorm(features)
        self.conv3 = Conv(features, out, (1, 1), bias=False)
        self.bn3 = BatchNorm(out)
        self.downsample = in_features != out or stride != 1
        if self.downsample:
            self.downsample_conv = Conv(in_features, out, (1, 1), stride, bias=False)
            self.downsample_bn = BatchNorm(out)
        self.out_features = out

    def forward(self, x, train: bool = False):
        y = F.relu(self.bn1(self.conv1(x), train))
        y = F.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        residual = x
        if self.downsample:
            residual = self.downsample_bn(self.downsample_conv(x), train)
        return F.relu(y + residual)


class ResNetConv(nn.Module):
    """ResNet trunk: a 7x7 stride-2 stem (``stem_conv``, ``stem_bn``), a
    3x3 stride-2 max-pool, four stages ``layer{s}_{b}`` of basic blocks
    (depth 18 / 34, 512 channels out) or bottlenecks (depth 50, 2048), and,
    with ``film_cond_dim``, ``FiLMLayer`` ``film{s}`` after each stage."""

    depth = 18

    def __init__(self, in_channels: int = 3, film_cond_dim: int | None = None,
                 depth: int | None = None):
        super().__init__()
        depth = self.depth if depth is None else depth
        blocks = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}[depth]
        block_cls = _Bottleneck if depth >= 50 else _BasicBlock
        self.stem_conv = Conv(in_channels, 64, (7, 7), 2, ((3, 3), (3, 3)), bias=False)
        self.stem_bn = BatchNorm(64)
        self.stages = []
        width = 64
        for si, (feats, n_blocks) in enumerate(zip((64, 128, 256, 512), blocks)):
            names = []
            for bi in range(n_blocks):
                block = block_cls(width, feats, (1 if si == 0 else 2) if bi == 0 else 1)
                self.add_module(f"layer{si + 1}_{bi}", block)
                names.append(f"layer{si + 1}_{bi}")
                width = block.out_features
            if film_cond_dim is not None:
                self.add_module(f"film{si + 1}", FiLMLayer(width, film_cond_dim))
            self.stages.append(names)
        self.film = film_cond_dim is not None
        self.out_channels = width

    def forward(self, x, train: bool = False, film_cond=None):
        if (film_cond is not None) != self.film:
            raise ValueError("a FiLM trunk takes a condition, and only a FiLM trunk does")
        x = F.relu(self.stem_bn(self.stem_conv(x), train))
        x = F.max_pool2d(x, 3, 2, 1)
        for si, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x, train)
            if self.film:
                x = getattr(self, f"film{si + 1}")(x, film_cond)
        return x


class ResNet18Conv(ResNetConv):
    depth = 18


class ResNet34Conv(ResNetConv):
    depth = 34


class ResNet50Conv(ResNetConv):
    depth = 50


class ShallowConv(nn.Module):
    """Four 3x3 stride-2 convs with bias and ReLU (``conv0``..``conv3``,
    32 -> 256 channels); it takes no FiLM condition."""

    out_channels = 256
    film = False

    def __init__(self, in_channels: int = 3, film_cond_dim: int | None = None):
        super().__init__()
        widths = (in_channels, 32, 64, 128, 256)
        for i in range(4):
            self.add_module(f"conv{i}", Conv(widths[i], widths[i + 1], (3, 3), 2, _PAD1))

    def forward(self, x, train: bool = False, film_cond=None):
        for i in range(4):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return x


class Conv1dBase(nn.Module):
    """1-D convs with bias, flax's SAME padding and ReLU over a scan [B, L]
    or [B, L, C] (``conv{i}``), flattened in flax's [B, L', C'] order."""

    def __init__(self, in_channels: int = 1, channels: tuple = (32, 64, 64),
                 kernel_sizes: tuple = (8, 4, 2), strides: tuple = (4, 2, 1)):
        super().__init__()
        self.strides = tuple(strides)
        widths = (in_channels,) + tuple(channels)
        for i, (k, s) in enumerate(zip(kernel_sizes, strides)):
            self.add_module(f"conv{i}", Conv(widths[i], widths[i + 1], (k,), s))
        self.n_convs = len(channels)
        self.out_channels = widths[-1]

    def out_length(self, length: int) -> int:
        for s in self.strides:
            length = -(-length // s)
        return length

    def forward(self, x, train: bool = False):
        if x.ndim == 2:
            x = x[..., None]
        x = x.transpose(1, 2)  # [B, C, L]
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
        return x.transpose(1, 2).reshape(x.shape[0], -1)


class SpatialSoftmax(nn.Module):
    """Spatial-softmax keypoints: a 1x1 ``kp_conv`` (with bias) where
    ``num_kp`` differs from the input's channels, then per channel a softmax
    over H*W (divided by the temperature, learnable as ``log_temperature``)
    and its expected (x, y) on linspace(-1, 1) grids -> [B, 2 * num_kp],
    interleaved [c0x, c0y, c1x, ...]."""

    def __init__(self, in_channels: int, num_kp: int = 32, temperature: float = 1.0,
                 learnable_temperature: bool = False):
        super().__init__()
        self.temperature = temperature
        self.kp_conv = Conv(in_channels, num_kp, (1, 1)) if num_kp != in_channels else None
        self.log_temperature = (nn.Parameter(torch.empty(1))
                                if learnable_temperature else None)
        self.out_features = 2 * num_kp

    def init_weights(self, generator: torch.Generator) -> None:
        if self.log_temperature is not None:
            with torch.no_grad():
                self.log_temperature.fill_(math.log(self.temperature))

    def forward(self, x, train: bool = False):
        if self.kp_conv is not None:
            x = self.kp_conv(x)
        b, c, h, w = x.shape
        temperature = (self.log_temperature.exp() if self.log_temperature is not None
                       else self.temperature)
        attention = torch.softmax(x.reshape(b, c, h * w) / temperature, dim=-1)
        pos_x = torch.linspace(-1.0, 1.0, w, device=x.device)
        pos_y = torch.linspace(-1.0, 1.0, h, device=x.device)
        ex = (attention * pos_x.repeat(h)).sum(-1)
        ey = (attention * pos_y.repeat_interleave(w)).sum(-1)
        return torch.stack([ex, ey], dim=-1).reshape(b, 2 * c)


class SpatialMeanPool(nn.Module):
    """Mean over the spatial dims."""

    def forward(self, x, train: bool = False):
        return x.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# Randomizers: NHWC in, NHWC out; the identity outside training
# ---------------------------------------------------------------------------

class ColorRandomizer:
    """Per-image brightness, contrast and saturation jitter, factors
    U(1 - m, 1 + m), clipped to [0, 1]."""

    def __init__(self, brightness: float = 0.3, contrast: float = 0.3,
                 saturation: float = 0.3):
        self.brightness, self.contrast, self.saturation = brightness, contrast, saturation

    def __call__(self, x, train: bool = False, generator=None):
        if not train:
            return x
        generator = _need_generator(generator)
        br, ct, st = (1.0 + (2.0 * torch.rand((x.shape[0], 1, 1, 1), generator=generator,
                                              device=x.device) - 1.0) * m
                      for m in (self.brightness, self.contrast, self.saturation))
        x = x * br
        mean = x.mean(dim=(1, 2, 3), keepdim=True)
        x = (x - mean) * ct + mean
        gray = x.mean(dim=-1, keepdim=True)
        x = gray + (x - gray) * st
        return x.clamp(0.0, 1.0)


class GaussianNoiseRandomizer:
    """Additive N(noise_mean, noise_std) pixel noise, clipped to ``limits``."""

    def __init__(self, noise_mean: float = 0.0, noise_std: float = 0.3,
                 limits: tuple | None = (0.0, 1.0)):
        self.noise_mean, self.noise_std, self.limits = noise_mean, noise_std, limits

    def __call__(self, x, train: bool = False, generator=None):
        if not train:
            return x
        noise = torch.randn(x.shape, generator=_need_generator(generator), device=x.device)
        x = x + self.noise_mean + self.noise_std * noise
        return x if self.limits is None else x.clamp(*self.limits)


class CropRandomizer:
    """``num_crops`` random crops per image at train time, folded into the
    batch (image-major) and mean-pooled over the crops by ``forward_out``;
    the center crop at ((h - ch) // 2, (w - cw) // 2) otherwise."""

    def __init__(self, crop_height: int, crop_width: int, num_crops: int = 1):
        self.crop_height, self.crop_width, self.num_crops = crop_height, crop_width, num_crops

    def forward_in(self, x, train: bool, generator=None):
        """[B, H, W, C] -> [B * num_crops, ch, cw, C] (train) or [B, ch, cw, C]."""
        b, h, w, _ = x.shape
        ch, cw = self.crop_height, self.crop_width
        if not train:
            y0, x0 = (h - ch) // 2, (w - cw) // 2
            return x[:, y0:y0 + ch, x0:x0 + cw]
        generator = _need_generator(generator)
        n = b * self.num_crops
        ys = torch.randint(0, h - ch + 1, (n,), generator=generator, device=x.device)
        xs = torch.randint(0, w - cw + 1, (n,), generator=generator, device=x.device)
        img = torch.arange(b, device=x.device).repeat_interleave(self.num_crops)
        rows = ys[:, None] + torch.arange(ch, device=x.device)
        cols = xs[:, None] + torch.arange(cw, device=x.device)
        return x[img[:, None, None], rows[:, :, None], cols[:, None, :]]

    def forward_out(self, feats, train: bool):
        if not train:
            return feats
        return feats.reshape(-1, self.num_crops, feats.shape[-1]).mean(dim=1)


# ---------------------------------------------------------------------------
# Cores
# ---------------------------------------------------------------------------

class CrossAttentionConditioner(nn.Module):
    """The feature map's H*W positions query one language token through
    flax's ``MultiHeadDotProductAttention`` (``cross_attention``: qkv and
    output width C, 8 heads)."""

    def __init__(self, channels: int, cond_dim: int, num_heads: int = 8):
        super().__init__()
        self.cross_attention = MultiHeadDotProductAttention(channels, num_heads,
                                                            kv_dim=cond_dim)

    def forward(self, feat_map, lang_emb):
        b, c, h, w = feat_map.shape
        x = feat_map.permute(0, 2, 3, 1).reshape(b, h * w, c)
        x = self.cross_attention(x, lang_emb[:, None, :])
        return x.reshape(b, h, w, c).permute(0, 3, 1, 2)


# backbone name -> trunk (unknown names take ResNet-18, as in the JAX package)
BACKBONES = {
    "ResNet18Conv": ResNet18Conv, "ResNet18ConvFiLM": ResNet18Conv,
    "ResNet34Conv": ResNet34Conv, "ResNet34ConvFiLM": ResNet34Conv,
    "ResNet50Conv": ResNet50Conv, "ResNet50ConvFiLM": ResNet50Conv,
    "ResNet18ConvCrossAttention": ResNet18Conv, "ShallowConv": ShallowConv,
}


class VisualCore(nn.Module):
    """Randomizers -> ``backbone`` -> ``pool`` -> ``proj`` + ReLU, mean over
    crops at train time. ``input_shape`` is the observation's [H, W, C];
    ``lang_dim`` the width of the ``lang_emb`` the core is called with (None:
    never), which FiLM (``film``) and the cross-attention backbone
    (``xattn``) need."""

    def __init__(self, input_shape, feature_dimension: int = 64,
                 backbone: str = "ResNet18Conv", pool: str = "SpatialSoftmax",
                 num_kp: int = 32, crop_height: int = 0, crop_width: int = 0,
                 num_crops: int = 1, film: bool = False, color_jitter: bool = False,
                 gaussian_noise: bool = False, lang_dim: int | None = None):
        super().__init__()
        self.color = ColorRandomizer() if color_jitter else None
        self.noise = GaussianNoiseRandomizer() if gaussian_noise else None
        self.crop = (CropRandomizer(crop_height, crop_width, num_crops)
                     if crop_height and crop_width else None)
        film_dim = lang_dim if film else None
        self.backbone = BACKBONES.get(backbone, ResNet18Conv)(input_shape[-1], film_dim)
        channels = self.backbone.out_channels
        self.xattn = (CrossAttentionConditioner(channels, lang_dim)
                      if backbone.endswith("CrossAttention") and lang_dim else None)
        if pool == "SpatialSoftmax":
            self.pool = SpatialSoftmax(channels, num_kp)
            pooled = self.pool.out_features
        else:
            self.pool, pooled = SpatialMeanPool(), channels
        self.proj = TorchLinear(pooled, feature_dimension)

    def forward(self, x, train: bool = False, generator=None, lang_emb=None):
        """x [B, H, W, C] float in [0, 1] -> [B, feature_dimension]."""
        if self.color is not None:
            x = self.color(x, train, generator)
        if self.noise is not None:
            x = self.noise(x, train, generator)
        if self.crop is not None:
            x = self.crop.forward_in(x, train, generator)
        h = self.backbone(x.permute(0, 3, 1, 2).contiguous(), train,
                          lang_emb if self.backbone.film else None)
        if self.xattn is not None:
            h = self.xattn(h, lang_emb)
        f = F.relu(self.proj(self.pool(h, train)))
        if self.crop is not None:
            f = self.crop.forward_out(f, train)
        return f


class PretrainedReprConv(nn.Module):
    """A frozen ResNet-18 trunk (``backbone``) standing for a pretrained
    visual representation (the reference's R3M / MVP wrappers). Randomly
    initialized only: the JAX package loads a converted flax checkpoint,
    which the port cannot read yet."""

    def __init__(self, in_channels: int = 3, ckpt_path: str | None = None,
                 freeze: bool = True):
        super().__init__()
        if ckpt_path is not None:
            raise NotImplementedError(
                "loading pretrained visual weights (ckpt_path) is not ported yet "
                "(ROADMAP §1 item 14); the trunk runs with random init only")
        self.freeze = freeze
        self.backbone = ResNet18Conv(in_channels)
        self.out_channels = self.backbone.out_channels

    def forward(self, x, train: bool = False, film_cond=None):
        h = self.backbone(x, train and not self.freeze)
        return h.detach() if self.freeze else h


class R3MConv(PretrainedReprConv):
    pass


class MVPConv(PretrainedReprConv):
    pass


class ScanCore(nn.Module):
    """Range-scan encoder: ``conv1d`` (Conv1dBase) -> ``proj`` + ReLU.
    ``input_shape`` is the scan's [L] or [L, C]."""

    def __init__(self, input_shape, feature_dimension: int = 64):
        super().__init__()
        shape = tuple(input_shape)
        self.conv1d = Conv1dBase(shape[1] if len(shape) > 1 else 1)
        flat = self.conv1d.out_length(shape[0]) * self.conv1d.out_channels
        self.proj = TorchLinear(flat, feature_dimension)

    def forward(self, x, train: bool = False, generator=None, lang_emb=None):
        return F.relu(self.proj(self.conv1d(x, train)))


def parse_core(core_name: str) -> tuple[str, dict]:
    """'VisualCore:feature_dimension=64,num_kp=32' -> (class name, kwargs);
    digit strings become ints."""
    kwargs = {}
    if ":" in core_name:
        core_name, arg_str = core_name.split(":", 1)
        for pair in arg_str.split(","):
            k, v = pair.split("=")
            kwargs[k] = int(v) if v.isdigit() else v
    return core_name, kwargs


def build_core(core_name: str, shape, lang_dim: int | None = None) -> nn.Module:
    """The core a spec string names, for an observation of ``shape``;
    ``lang_dim`` is the ``lang_emb`` width a language-conditioned core is
    called with."""
    name, kwargs = parse_core(core_name)
    if name == "VisualCore":
        return VisualCore(shape, **kwargs)
    if name == "VisualCoreLanguageConditioned":
        return VisualCore(shape, film=True, lang_dim=lang_dim, **kwargs)
    if name == "ScanCore":
        for k in ("num_kp", "crop_height", "crop_width", "num_crops"):
            kwargs.pop(k, None)
        return ScanCore(shape, **kwargs)
    raise KeyError(f"Unknown encoder core {name!r}")
