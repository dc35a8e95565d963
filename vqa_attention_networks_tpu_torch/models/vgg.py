"""VGG-19 convolutional trunk with feature taps (port of
``vqa_attention_networks_tpu/models/vgg.py``).

The reference's predict script taps torchvision's ``vgg19.features`` at
module indices {27, 36} (predict_pytorch.py:34-37): pool4 (14 x 14 x 512 at
224 input, the grid it flattens to [1, 196, 512], predict_pytorch.py:48-50)
and pool5 (7 x 7 x 512). Convolutions are ``F.conv2d`` (3 x 3, padding 1,
which is JAX's "SAME" at stride 1), pools 2 x 2 / 2; JAX runs them as
``lax.conv`` and ``reduce_window`` outside any Pallas kernel, so cuDNN is
their port. NHWC in, NHWC out, as in JAX. Weights convert from torchvision
``vgg19().state_dict()`` (``load_torchvision``), from JAX's parameter tree
(``load_params``), or are drawn from a ``torch.Generator``
(``random_params``).
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# torchvision vgg19.features: conv widths and "M" for a max pool; a conv
# occupies two module indices (conv, ReLU), a pool one
VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M")

# the torchvision module indices the reference taps (predict_pytorch.py:35)
DEFAULT_TAPS = (27, 36)


def _module_index_map() -> List[Tuple[str, int]]:
    """torchvision's Sequential indices: [(kind, conv ordinal or -1)]."""
    modules: List[Tuple[str, int]] = []
    conv_i = 0
    for item in VGG19_CFG:
        if item == "M":
            modules.append(("pool", -1))
        else:
            modules.append(("conv", conv_i))
            modules.append(("relu", conv_i))
            conv_i += 1
    return modules


class VGG19Trunk(nn.Module):
    """The 16 convolutions of VGG-19 (weights [O, I, 3, 3] and biases, f32,
    cast to the compute dtype in the forward)."""

    def __init__(self):
        super().__init__()
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        cin = 3
        for item in VGG19_CFG:
            if item == "M":
                continue
            self.weights.append(nn.Parameter(torch.empty(item, cin, 3, 3),
                                             requires_grad=False))
            self.biases.append(nn.Parameter(torch.zeros(item),
                                            requires_grad=False))
            cin = item

    def forward(self, images: torch.Tensor,
                taps: Sequence[int] = DEFAULT_TAPS,
                dtype: torch.dtype = torch.bfloat16) -> List[torch.Tensor]:
        """[N, H, W, 3] preprocessed float -> the activations at the tapped
        module indices, ascending, each [N, h, w, C] f32."""
        x = images.to(dtype).permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        max_tap = max(taps)
        outs = []
        for idx, (kind, conv_i) in enumerate(_module_index_map()):
            if kind == "conv":
                x = F.conv2d(x, self.weights[conv_i].to(dtype),
                             self.biases[conv_i].to(dtype), padding=1)
            elif kind == "relu":
                x = torch.relu(x)
            else:
                x = F.max_pool2d(x, 2, stride=2)
            if idx in taps:
                outs.append(x.permute(0, 2, 3, 1).float())
            if idx >= max_tap:
                break
        return outs


def grid_features(trunk: VGG19Trunk, images: torch.Tensor, tap: int = 27,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[N, H, W, 3] -> [N, L, C], the grid at one tap: the shape the
    predict path feeds the models (predict_pytorch.py:48-50)."""
    (feat,) = trunk(images, taps=(tap,), dtype=dtype)
    n, h, w, c = feat.shape
    return feat.reshape(n, h * w, c)


def _load(convs: Sequence[Tuple[np.ndarray, np.ndarray]]) -> VGG19Trunk:
    trunk = VGG19Trunk()
    if len(convs) != len(trunk.weights):
        raise ValueError(f"vgg19 weights hold {len(convs)} convs, expected "
                         f"{len(trunk.weights)}")
    with torch.no_grad():
        for i, (w, b) in enumerate(convs):
            for target, value in ((trunk.weights[i], w),
                                  (trunk.biases[i], b)):
                value = torch.tensor(np.asarray(value, np.float32))
                if tuple(value.shape) != tuple(target.shape):
                    raise ValueError(
                        f"conv {i}: shape {tuple(value.shape)}, expected "
                        f"{tuple(target.shape)}")
                target.copy_(value)
    return trunk


def load_torchvision(state_dict: Mapping[str, np.ndarray]) -> VGG19Trunk:
    """torchvision ``vgg19().state_dict()`` (numpy) -> a trunk on the CPU.
    The convs are found by scanning for ``features.<i>.weight`` in index
    order (the Sequential indices are sparse: ReLU and pools hold no
    parameters)."""
    conv_indices = sorted(
        int(k.split(".")[1]) for k in state_dict
        if k.startswith("features.") and k.endswith(".weight"))
    return _load([(state_dict[f"features.{i}.weight"],
                   state_dict[f"features.{i}.bias"]) for i in conv_indices])


def load_params(params: Mapping) -> VGG19Trunk:
    """JAX's tree (``{"convs": [{"w" [3, 3, I, O], "b"}, ...]}``) -> a
    trunk on the CPU."""
    return _load([(np.transpose(np.asarray(c["w"]), (3, 2, 0, 1)), c["b"])
                  for c in params["convs"]])


def random_params(generator: torch.Generator) -> VGG19Trunk:
    """He-normal weights and zero biases, drawn from ``generator``."""
    trunk = VGG19Trunk()
    with torch.no_grad():
        for w in trunk.weights:
            fan_in = w.shape[1] * 9
            w.copy_(torch.randn(w.shape, generator=generator)
                    * (2.0 / fan_in) ** 0.5)
    return trunk


def load(weights_path: Optional[str]) -> VGG19Trunk:
    """The trunk of a torchvision ``.npz``, or a random one drawn from seed
    0 when ``weights_path`` is None."""
    if weights_path:
        with np.load(weights_path) as f:
            return load_torchvision(dict(f))
    return random_params(torch.Generator().manual_seed(0))
