"""Image feature-extraction CLI (the port's copy of
``vqa_attention_networks_tpu/cli/extract_features.py``, the counterpart of
extract_image_features.py).

Batches COCO ``{split}2014`` images through the ResNet-152 trunk
(``models/resnet.py``) and writes one packed feature store per split
(``data/feature_store.py``). The host decodes the images and resizes them
to the target resolution with BILINEAR (torchvision Resize's default,
extract_image_features.py:56) on a thread pool, one batch ahead of the
device; ImageNet normalisation runs on the device on the uint8 batch.

The same flags as the JAX CLI, and one more: ``--device`` (default
``cuda``; ``cpu`` for tests, nothing falls back to the CPU by itself).

Pretrained weights: ``--weights`` names an ``.npz`` of torchvision's
``resnet152`` state dict (``convert_weights`` below writes one from a
``.pth``). The published accuracies sit on those features
(extract_image_features.py:22); without weights a random trunk (seed 0) is
used and a warning printed: pipeline testing only.
"""

import argparse
import os
from os.path import join

import numpy as np
import torch

from vqa_attention_networks_tpu_torch.data.feature_store import (
    FeatureStoreWriter,
)
from vqa_attention_networks_tpu_torch.device import cuda_device
from vqa_attention_networks_tpu_torch.models import resnet

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def load_resnet(weights_path=None) -> resnet.ResNetTrunk:
    if not weights_path:
        print("WARNING: no --weights given; using a RANDOM ResNet-152 "
              "trunk. Features will not match the reference's pretrained "
              "features.")
    return resnet.load(weights_path)


def _load_image(path: str, size: int) -> np.ndarray:
    from PIL import Image

    # BILINEAR, as torchvision's Resize((448, 448)) in the reference
    # (extract_image_features.py:56); Pillow's own default is BICUBIC
    img = Image.open(path).convert("RGB").resize(
        (size, size), Image.BILINEAR
    )
    return np.asarray(img, np.uint8)


def _image_id(name: str):
    """COCO_{split}2014_{id:012d}.jpg -> id; None for unparseable names."""
    try:
        return int(os.path.splitext(name)[0].split("_")[-1])
    except ValueError:
        return None


def _decode_chunk(pool, image_dir: str, chunk, size: int, bs: int):
    batch = np.zeros((bs, size, size, 3), np.uint8)
    futures = [
        pool.submit(_load_image, join(image_dir, name), size)
        for name in chunk
    ]
    ids = []
    for i, (name, fut) in enumerate(zip(chunk, futures)):
        batch[i] = fut.result()
        ids.append(_image_id(name))
    return batch, ids


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="extract image features")
    parser.add_argument("--split", type=str, default="train", help="train|val")
    parser.add_argument("--output_dir", type=str, default="data")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--feature_type", type=str, default="resnet152")
    parser.add_argument("--image_dir", type=str, default=None,
                        help="defaults to data/vqa/{split}2014")
    parser.add_argument("--weights", type=str, default=None,
                        help=".npz of torchvision resnet152 state_dict")
    parser.add_argument("--size", type=int, default=448,
                        help="input resolution (reference: 448; the grid is "
                             "size/32 x size/32 regions)")
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        help="trunk compute dtype: bfloat16 (fast) or "
                             "float32 (reference-exact features)")
    parser.add_argument("--store_dtype", type=str, default="float16",
                        help="on-disk store dtype: float16 (default) or "
                             "int8 (quantized with per-channel scales — "
                             "half the disk/host bytes; an existing f16 "
                             "store converts with "
                             "data.feature_store.quantize_store)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default: the card; an error without "
                             "one) | cpu (for tests)")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    from concurrent.futures import ThreadPoolExecutor

    args = parse_args(argv)
    if args.dtype not in _DTYPES:
        raise SystemExit(f"--dtype {args.dtype!r}: bfloat16 or float32")
    device = (cuda_device() if args.device == "cuda"
              else torch.device(args.device))
    image_dir = args.image_dir or f"data/vqa/{args.split}2014"
    all_names = sorted(
        x for x in os.listdir(image_dir) if not x.startswith(".")
    )
    names = [
        x for x in all_names
        if x.lower().endswith(_IMAGE_EXTS) and _image_id(x) is not None
    ]
    skipped = len(all_names) - len(names)
    if skipped:
        print(f"WARNING: skipping {skipped} non-image / non-COCO-named "
              f"files in {image_dir}")
    print(f"total image count: {len(names)}")
    if args.size != 448:
        print(f"WARNING: --size {args.size} != 448: features will have a "
              f"{args.size // 32}x{args.size // 32} grid and will NOT match "
              "the reference's 14x14 features")

    trunk = load_resnet(args.weights).to(device).eval()
    dtype = _DTYPES[args.dtype]

    def extract(batch: np.ndarray) -> torch.Tensor:
        with torch.inference_mode():
            return resnet.extract(trunk, torch.from_numpy(batch).to(device),
                                  dtype, args.size)

    out_dir = join(args.output_dir, f"{args.feature_type}_{args.split}")
    bs = args.batch_size
    grid = (args.size // 32) ** 2  # ResNet downsamples 32x: 448 -> 14x14
    chunks = [names[s : s + bs] for s in range(0, len(names), bs)]
    with FeatureStoreWriter(out_dir, num_regions=grid,
                            dtype=args.store_dtype) as writer, \
            ThreadPoolExecutor(max_workers=8) as pool:
        # decode chunk t+1 on host threads while the device runs chunk t
        # (the launches return at once; the copy to the host waits)
        pending = None  # (device output, ids, n)
        for ci, chunk in enumerate(chunks):
            batch, ids = _decode_chunk(pool, image_dir, chunk, args.size, bs)
            dev = extract(batch)
            if pending is not None:
                p_dev, p_ids, p_n = pending
                writer.append_batch(p_ids, p_dev[:p_n].cpu().numpy())
            pending = (dev, ids, len(chunk))
            if ci % 50 == 0:
                print(f"{ci * bs + len(chunk)}/{len(names)}", flush=True)
        if pending is not None:
            p_dev, p_ids, p_n = pending
            writer.append_batch(p_ids, p_dev[:p_n].cpu().numpy())
    print(f"wrote packed feature store to {out_dir}")


def convert_weights(argv=None) -> None:
    """Offline: a torch ``.pth`` state_dict -> an ``.npz`` of numpy
    arrays."""
    parser = argparse.ArgumentParser()
    parser.add_argument("pth")
    parser.add_argument("npz")
    args = parser.parse_args(argv)
    sd = torch.load(args.pth, map_location="cpu", weights_only=True)
    np.savez(args.npz, **{k: v.numpy() for k, v in sd.items()})
    print(f"converted {len(sd)} tensors -> {args.npz}")


if __name__ == "__main__":
    main()
