"""ResNet-152 feature trunk, the offline image-feature extractor (port of
``vqa_attention_networks_tpu/models/resnet.py``).

The reference's ``FeaturesExtractor`` (extract_image_features.py:19-26):
torchvision's ``resnet152`` without avgpool and fc, fed 448 x 448
ImageNet-normalised images, giving a [14, 14, 2048] -> [196, 2048] grid an
image.

- Inference only: every batch norm is folded into a per-channel scale and
  bias when the weights are loaded (``_fold_bn``), and the forward is the
  JAX package's: conv, times scale, plus bias, in the compute dtype.
- Convolutions are ``F.conv2d`` with torch's symmetric ``k // 2``
  padding, which is what JAX's ``_conv`` pads explicitly (XLA's "SAME"
  would pad (0, 1) under stride 2 on even inputs and shift every stride-2
  stage by a pixel). JAX runs them as ``lax.conv`` outside any Pallas
  kernel, so cuDNN is their port: no TPU kernel is on this path.
- Channels-last on the card (cuDNN's fast layout); the input is NHWC and
  the output [N, H*W, C] f32, as in JAX.
- Weights: torchvision's state dict as an ``.npz`` (``load_torchvision``;
  the file ``cli.extract_features convert_weights`` writes), a JAX-layout
  parameter tree (``load_params``, the folded form ``resnet.
  convert_torchvision_resnet152`` returns), or a random trunk from an
  explicit ``torch.Generator`` (``random_params``). The stage depths come
  from the weights, so a depth-reduced trunk runs through the same code.

Architecture (ResNet v1.5 bottleneck, as torchvision): a 7x7/2 stem and a
3x3/2 max pool, then stages [3, 8, 36, 3] of widths [64, 128, 256, 512] x 4,
stride 2 on the 3x3 of each stage's first block after the first stage.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

STAGES = (3, 8, 36, 3)
WIDTHS = (64, 128, 256, 512)
EXPANSION = 4

# ImageNet's statistics, as torchvision's Normalize takes them
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

BN_EPS = 1e-5
# the folded scale of each block's last batch norm in a random trunk
RESIDUAL_SCALE = 0.2


class ConvBN(nn.Module):
    """A bias-free convolution and its folded batch norm: ``conv(x, w) *
    scale + bias``. ``w`` is [O, I, kh, kw] (torch's layout); the
    parameters stay f32 and are cast to x's dtype in the forward."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k),
                                   requires_grad=False)
        self.scale = nn.Parameter(torch.ones(cout), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(cout), requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        y = F.conv2d(x, self.weight.to(x.dtype), stride=self.stride,
                     padding=k // 2)
        shape = (1, -1, 1, 1)
        return y * self.scale.to(x.dtype).view(shape) \
            + self.bias.to(x.dtype).view(shape)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, width: int, stride: int, downsample: bool):
        super().__init__()
        cout = width * EXPANSION
        self.conv1 = ConvBN(cin, width, 1)
        self.conv2 = ConvBN(width, width, 3, stride)  # stride on the 3x3
        self.conv3 = ConvBN(width, cout, 1)
        self.downsample = ConvBN(cin, cout, 1, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.conv1(x))
        out = torch.relu(self.conv2(out))
        out = self.conv3(out)
        shortcut = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + shortcut)


class ResNetTrunk(nn.Module):
    """[N, H, W, 3] preprocessed float -> [N, (H/32)*(W/32), 2048] f32."""

    def __init__(self, stages: Tuple[int, ...] = STAGES):
        super().__init__()
        self.stages = tuple(stages)
        self.stem = ConvBN(3, 64, 7, stride=2)
        cin = 64
        for s, n_blocks in enumerate(self.stages):
            width = WIDTHS[s]
            blocks = []
            for b in range(n_blocks):
                blocks.append(Bottleneck(cin, width,
                                         2 if (b == 0 and s > 0) else 1,
                                         downsample=b == 0))
                cin = width * EXPANSION
            setattr(self, f"layer{s + 1}", nn.Sequential(*blocks))

    def forward(self, images: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        x = images.to(dtype).permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        x = torch.relu(self.stem(x))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for s in range(len(self.stages)):
            x = getattr(self, f"layer{s + 1}")(x)
        n, c, h, w = x.shape
        return x.permute(0, 2, 3, 1).reshape(n, h * w, c).float()


def preprocess(images_uint8: torch.Tensor, size: int = 448) -> torch.Tensor:
    """[N, H, W, 3] uint8 -> resized, ImageNet-normalised f32 NHWC
    (extract_image_features.py:55-60). The resize is skipped when the
    images already have the size (the extractor resizes on the host)."""
    x = images_uint8.float() / 255.0
    if tuple(x.shape[1:3]) != (size, size):
        # jax.image.resize "bilinear": half-pixel centres, antialiased
        # when it shrinks
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size),
                          mode="bilinear", align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def extract(trunk: ResNetTrunk, images_uint8: torch.Tensor,
            dtype: torch.dtype = torch.bfloat16,
            size: int = 448) -> torch.Tensor:
    """uint8 images -> feature grid."""
    return trunk(preprocess(images_uint8, size), dtype)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _fold_bn(gamma, beta, mean, var, eps: float = BN_EPS):
    scale = gamma / np.sqrt(var + eps)
    return scale.astype(np.float32), (beta - mean * scale).astype(np.float32)


def _stages_of(keys, prefix: str = "layer") -> Tuple[int, ...]:
    """The stage depths a set of torchvision-style keys holds."""
    stages = tuple(
        1 + max((int(k.split(".")[1]) for k in keys
                 if k.startswith(f"{prefix}{s + 1}.")), default=-1)
        for s in range(4))
    if 0 in stages:
        raise ValueError(
            f"state_dict is missing an entire residual stage: {stages}")
    return stages


def _conv_bn_entries(stages: Tuple[int, ...]) -> List[Tuple[str, str, str]]:
    """(module path in the trunk, torchvision conv key, torchvision bn key)
    of every folded conv."""
    out = [("stem", "conv1.weight", "bn1")]
    for s, n_blocks in enumerate(stages):
        for b in range(n_blocks):
            pre = f"layer{s + 1}.{b}"
            for i in (1, 2, 3):
                out.append((f"{pre}.conv{i}", f"{pre}.conv{i}.weight",
                            f"{pre}.bn{i}"))
            if b == 0:
                out.append((f"{pre}.downsample",
                            f"{pre}.downsample.0.weight",
                            f"{pre}.downsample.1"))
    return out


def _set(trunk: ResNetTrunk, path: str, w: np.ndarray, scale: np.ndarray,
         bias: np.ndarray) -> None:
    mod = trunk.get_submodule(path)
    for name, value in (("weight", w), ("scale", scale), ("bias", bias)):
        target = getattr(mod, name)
        value = torch.tensor(np.asarray(value, np.float32))
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(f"{path}.{name}: shape {tuple(value.shape)}, "
                             f"expected {tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(value)


def load_torchvision(state_dict: Mapping[str, np.ndarray]) -> ResNetTrunk:
    """torchvision ``resnet152().state_dict()`` (numpy arrays, e.g. the
    ``.npz`` of ``convert_weights``) -> a trunk on the CPU, each batch norm
    folded. Any torchvision-layout bottleneck ResNet loads: the depths
    come from the keys, and a missing key raises."""
    stages = _stages_of(state_dict)
    trunk = ResNetTrunk(stages)
    for path, conv, bn in _conv_bn_entries(stages):
        scale, bias = _fold_bn(
            np.asarray(state_dict[bn + ".weight"], np.float32),
            np.asarray(state_dict[bn + ".bias"], np.float32),
            np.asarray(state_dict[bn + ".running_mean"], np.float32),
            np.asarray(state_dict[bn + ".running_var"], np.float32))
        _set(trunk, path, state_dict[conv], scale, bias)
    return trunk


def load_params(params: Mapping) -> ResNetTrunk:
    """A JAX-layout tree (``{"stem": {"w" [kh, kw, I, O], "scale",
    "bias"}, "layer1": [block, ...], ...}``, as JAX's
    ``convert_torchvision_resnet152`` and ``random_init`` give it) -> a
    trunk on the CPU holding the same folded weights."""
    stages = tuple(len(params[f"layer{s + 1}"]) for s in range(4)
                   if f"layer{s + 1}" in params)
    trunk = ResNetTrunk(stages)

    def put(path: str, p: Mapping) -> None:
        w = np.transpose(np.asarray(p["w"], np.float32), (3, 2, 0, 1))
        _set(trunk, path, w, p["scale"], p["bias"])

    put("stem", params["stem"])
    for s in range(len(stages)):
        for b, block in enumerate(params[f"layer{s + 1}"]):
            for name in ("conv1", "conv2", "conv3", "downsample"):
                if name in block:
                    put(f"layer{s + 1}.{b}.{name}", block[name])
    return trunk


def random_params(generator: torch.Generator,
                  stages: Tuple[int, ...] = STAGES) -> ResNetTrunk:
    """A He-normal random trunk drawn from ``generator``, its batch norms
    the identity except each block's last, whose scale is
    ``RESIDUAL_SCALE``: for pipeline tests and throughput work. (With every
    batch norm the identity, as JAX's ``random_init`` has them, the
    residual stream doubles its variance in each of the 50 blocks and the
    grid reaches ~1e10, past an f16 store's range.) Real features need
    torchvision's pretrained weights (``load_torchvision``)."""
    trunk = ResNetTrunk(stages)
    with torch.no_grad():
        for name, mod in trunk.named_modules():
            if isinstance(mod, ConvBN):
                o, i, kh, kw = mod.weight.shape
                mod.weight.copy_(torch.randn(mod.weight.shape,
                                             generator=generator)
                                 * (2.0 / (i * kh * kw)) ** 0.5)
                if name.endswith(".conv3"):
                    mod.scale.fill_(RESIDUAL_SCALE)
    return trunk


def load(weights_path: Optional[str]) -> ResNetTrunk:
    """The trunk of a torchvision ``.npz``, or a random one drawn from seed
    0 when ``weights_path`` is None."""
    if weights_path:
        with np.load(weights_path) as f:
            return load_torchvision(dict(f))
    return random_params(torch.Generator().manual_seed(0))

