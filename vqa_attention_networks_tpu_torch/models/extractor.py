"""Image -> feature grid, shared by ``cli.predict`` and the server's
/predict_image (port of ``vqa_attention_networks_tpu/models/extractor.py``;
the reference's flow is predict_pytorch.py:34-44, offline extraction is
``cli/extract_features.py``).

One implementation of the image -> [196, C] stage, so that predict-time,
serve-time and extracted features cannot drift apart in preprocessing:
BILINEAR resize (torchvision Resize's default; PIL's own default, BICUBIC,
would skew the features), a uint8 feed for the ResNet trunk (which
normalises on the device, ``resnet.preprocess``), and ImageNet
normalisation on the host for the VGG tap, as the extraction CLI does.

PIL is imported inside the functions that decode or resize: the module
imports without it, and ``from_array`` takes an image already decoded and
resized.
"""

from __future__ import annotations

import io
from typing import Optional, Union

import numpy as np
import torch

from vqa_attention_networks_tpu_torch.device import cuda_device
from vqa_attention_networks_tpu_torch.models import resnet, vgg


class GridExtractor:
    """Image bytes, a PIL image or a uint8 array -> [regions, channels] f32
    feature grid, with the trunk on ``device`` (default: the card).

    The trunk runs once at construction on a blank image (``warmup``), so
    a server pays cuDNN's first-call cost at start-up, not inside the
    first user request. ``dtype`` is the trunk's compute dtype (bf16, as
    JAX's extractor)."""

    #: both taps give a 14 x 14 grid (resnet152 at 448, vgg19's pool4 at 224)
    regions = 196

    def __init__(self, backbone: str, weights_path: Optional[str] = None,
                 warmup: bool = True,
                 device: Union[str, torch.device, None] = None,
                 dtype: torch.dtype = torch.bfloat16):
        if backbone not in ("resnet152", "vgg19"):
            raise ValueError(
                f"unknown backbone {backbone!r}: choose resnet152 (training "
                "features) or vgg19 (the reference predict script's tap, "
                "predict_pytorch.py:34-37)"
            )
        self.backbone = backbone
        self.random_weights = weights_path is None
        self.device = torch.device(device) if device is not None \
            else cuda_device()
        self.dtype = dtype
        if backbone == "resnet152":
            self.size, self.channels = 448, 2048
            self.trunk = resnet.load(weights_path).to(self.device).eval()
        else:
            self.size, self.channels = 224, 512
            self.trunk = vgg.load(weights_path).to(self.device).eval()
        if warmup:
            self.from_array(np.zeros((self.size, self.size, 3), np.uint8))

    def batch(self, images: np.ndarray) -> torch.Tensor:
        """[N, size, size, 3] uint8 (already resized) -> [N, regions,
        channels] f32 on the device (the caller copies it out)."""
        x = torch.from_numpy(np.array(images, np.uint8))
        with torch.inference_mode():
            if self.backbone == "resnet152":
                return resnet.extract(self.trunk, x.to(self.device),
                                      self.dtype, self.size)
            arr = x.numpy().astype(np.float32) / 255.0
            arr = (arr - resnet.IMAGENET_MEAN) / resnet.IMAGENET_STD
            return vgg.grid_features(self.trunk,
                                     torch.from_numpy(arr).to(self.device),
                                     dtype=self.dtype)

    def from_array(self, image: np.ndarray) -> np.ndarray:
        """[size, size, 3] uint8 -> [regions, channels] f32 grid."""
        return self.batch(np.asarray(image, np.uint8)[None]).cpu().numpy()[0]

    def from_pil(self, img) -> np.ndarray:
        """PIL image -> [regions, channels] f32 grid."""
        from PIL import Image

        img = img.convert("RGB").resize(
            (self.size, self.size), Image.BILINEAR
        )
        return self.from_array(np.asarray(img, np.uint8))

    def from_bytes(self, image_bytes: bytes) -> np.ndarray:
        """Encoded image bytes -> grid. A decode failure raises ValueError
        (a client error); a failure of the trunk propagates unchanged (a
        server error): callers map them to 400 and 500."""
        from PIL import Image

        try:
            img = Image.open(io.BytesIO(image_bytes))
            img.load()
        except Exception:
            raise ValueError("could not decode image") from None
        return self.from_pil(img)
