"""The port's image backbones and extractor (``models/resnet.py``,
``models/vgg.py``, ``models/extractor.py``) against the JAX package's, on
the CPU.

- The trunks take JAX's own parameters (the folded batch norms of
  ``resnet.convert_torchvision_resnet152``, the converted VGG convs) and
  must give JAX's f32 activations within a relative error of 1e-4 of the
  largest |value|, the bound of ``tests/test_torch_parity.py`` (f32 on both
  sides; they differ in the order of the convolutions' sums): ResNet-152 at
  full depth at 64 x 64, where every stride-2 stage boundary is crossed
  (the padding trap), and a depth-(1, 1, 1, 1) trunk at 448, the
  production grid; VGG-19's two taps at 64 x 64.
- The port reads torchvision's state dict from an ``.npz`` into the same
  folded weights JAX's converter makes (to 1e-6 relative: both fold in
  f32 numpy).
- Preprocessing: ImageNet's constants are JAX's; the resize equals
  ``jax.image.resize``'s bilinear (antialiased when it shrinks) to 1e-5.
- The extractor: its constants, the decode-error classification, and its
  grid on a PIL image against JAX's trunk on the same preprocessed pixels.
"""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vqa_attention_networks_tpu.models import extractor as jax_extractor
from vqa_attention_networks_tpu.models import resnet as jr
from vqa_attention_networks_tpu.models import vgg as jv
from vqa_attention_networks_tpu_torch.models import resnet, vgg
from vqa_attention_networks_tpu_torch.models.extractor import GridExtractor

REL_ERR = 1e-4  # tests/test_torch_parity.py's bound, f32 on both sides
FOLD_RTOL = 1e-6
# bf16 trunks in both packages: each layer rounds its output to bf16, and
# the two sum in other orders, so an element can round one bf16 ulp apart
# (2^-8 relative) at any layer; over VGG's ten convolutions to pool4 that
# stays within 2^-4 of the largest |value| (measured 9.8e-3 to 1.3e-2
# over three seeds)
BF16_REL_ERR = 2.0 ** -4


def _rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def resnet_state_dict(stages, seed: int) -> dict:
    """A torchvision-layout ``resnet`` state dict (numpy) with random
    weights and batch-norm statistics away from their defaults, bounded
    so the activations stay finite through 50 blocks."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv_bn(conv, bn, cin, cout, k):
        sd[conv] = (rng.standard_normal((cout, cin, k, k))
                    * (1.0 / (cin * k * k)) ** 0.5).astype(np.float32)
        sd[bn + ".weight"] = rng.uniform(0.8, 1.2, cout).astype(np.float32)
        sd[bn + ".bias"] = (0.05 * rng.standard_normal(cout)).astype(
            np.float32)
        sd[bn + ".running_mean"] = (0.1 * rng.standard_normal(cout)).astype(
            np.float32)
        sd[bn + ".running_var"] = rng.uniform(0.5, 1.5, cout).astype(
            np.float32)
        sd[bn + ".num_batches_tracked"] = np.asarray(7, np.int64)

    conv_bn("conv1.weight", "bn1", 3, 64, 7)
    cin = 64
    for s, n_blocks in enumerate(stages):
        width = resnet.WIDTHS[s]
        for b in range(n_blocks):
            pre = f"layer{s + 1}.{b}"
            conv_bn(f"{pre}.conv1.weight", f"{pre}.bn1", cin, width, 1)
            conv_bn(f"{pre}.conv2.weight", f"{pre}.bn2", width, width, 3)
            conv_bn(f"{pre}.conv3.weight", f"{pre}.bn3", width, width * 4, 1)
            if b == 0:
                conv_bn(f"{pre}.downsample.0.weight", f"{pre}.downsample.1",
                        cin, width * 4, 1)
            cin = width * 4
    return sd


def vgg_state_dict(seed: int) -> dict:
    """A torchvision-layout ``vgg19().state_dict()`` (numpy), random."""
    rng = np.random.default_rng(seed)
    sd, idx, cin = {}, 0, 3
    for item in vgg.VGG19_CFG:
        if item == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = (
            rng.standard_normal((item, cin, 3, 3))
            * (2.0 / (cin * 9)) ** 0.5).astype(np.float32)
        sd[f"features.{idx}.bias"] = (0.05 * rng.standard_normal(item)
                                      ).astype(np.float32)
        idx += 2
        cin = item
    return sd


def _images(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("stages,size,n", [
    (resnet.STAGES, 64, 2),  # full depth: every stride-2 boundary
    ((1, 1, 1, 1), 448, 1),  # the production grid, depth cut
], ids=["full_depth_64", "depth1_448"])
def test_resnet_matches_jax_apply(stages, size, n):
    params = jr.convert_torchvision_resnet152(
        resnet_state_dict(stages, seed=1))
    trunk = resnet.load_params(params).eval()
    assert trunk.stages == stages
    x = _images((n, size, size, 3), seed=2)
    want = np.asarray(jr.apply(params, jnp.asarray(x), dtype=jnp.float32))
    with torch.no_grad():
        got = trunk(torch.from_numpy(x), torch.float32).numpy()
    assert got.shape == want.shape == (n, (size // 32) ** 2, 2048)
    assert _rel_err(got, want) < REL_ERR


def test_vgg_taps_match_jax_apply():
    params = jv.convert_torchvision_vgg19(vgg_state_dict(seed=5))
    trunk = vgg.load_params(params)
    x = _images((2, 64, 64, 3), seed=6)
    wants = jv.apply(params, jnp.asarray(x), dtype=jnp.float32)
    with torch.no_grad():
        gots = trunk(torch.from_numpy(x), dtype=torch.float32)
        grid = vgg.grid_features(trunk, torch.from_numpy(x),
                                 dtype=torch.float32)
    # module indices 27 / 36 are pool4 / pool5: /16 and /32
    assert [tuple(g.shape) for g in gots] == [(2, 4, 4, 512), (2, 2, 2, 512)]
    for got, want in zip(gots, wants):
        assert _rel_err(got.numpy(), want) < REL_ERR
    assert grid.shape == (2, 16, 512)
    np.testing.assert_array_equal(grid.numpy(),
                                  gots[0].reshape(2, 16, 512).numpy())
    assert [k for k, _ in vgg._module_index_map()] == \
        [k for k, _ in jv._module_index_map()]
    assert vgg.VGG19_CFG == jv.VGG19_CFG and vgg.DEFAULT_TAPS == \
        jv.DEFAULT_TAPS


def test_torchvision_npz_key_mapping(tmp_path):
    """The ``.npz`` of torchvision's state dicts (what ``convert_weights``
    writes) loads into the weights JAX's converters make: each batch norm
    folded as (x - mean) / sqrt(var + eps) * gamma + beta."""
    sd = resnet_state_dict((1, 1, 1, 1), seed=3)
    np.savez(tmp_path / "resnet.npz", **sd)
    trunk = resnet.load(str(tmp_path / "resnet.npz"))
    assert trunk.stages == (1, 1, 1, 1)
    want = jr.convert_torchvision_resnet152(sd)
    got = {name: (m.weight.detach().numpy(), m.scale.detach().numpy(),
                  m.bias.detach().numpy())
           for name, m in trunk.named_modules()
           if isinstance(m, resnet.ConvBN)}
    assert len(got) == 1 + 4 * 4  # the stem, 3 convs and a shortcut a stage

    def jax_leaf(path):
        node = want
        for key in path.split("."):
            node = node[int(key)] if key.isdigit() else node[key]
        return node

    for path, (w, scale, bias) in got.items():
        ref = jax_leaf(path)
        np.testing.assert_allclose(
            w, np.transpose(ref["w"], (3, 2, 0, 1)), rtol=FOLD_RTOL)
        np.testing.assert_allclose(scale, ref["scale"], rtol=FOLD_RTOL)
        np.testing.assert_allclose(bias, ref["bias"], rtol=FOLD_RTOL,
                                   atol=1e-7)
    x = np.random.default_rng(4).standard_normal(64).astype(np.float32)
    bn = {k: sd["bn1." + k] for k in ("weight", "bias", "running_mean",
                                      "running_var")}
    np.testing.assert_allclose(
        x * got["stem"][1] + got["stem"][2],
        (x - bn["running_mean"]) / np.sqrt(bn["running_var"] + 1e-5)
        * bn["weight"] + bn["bias"], rtol=1e-5, atol=1e-5)
    # a missing stage is refused, as JAX's converter refuses it
    partial = {k: v for k, v in sd.items() if not k.startswith("layer3.")}
    with pytest.raises(ValueError, match="missing an entire residual stage"):
        resnet.load_torchvision(partial)

    vsd = vgg_state_dict(seed=7)
    np.savez(tmp_path / "vgg.npz", **vsd)
    vtrunk = vgg.load(str(tmp_path / "vgg.npz"))
    for w, b, ref in zip(vtrunk.weights, vtrunk.biases,
                         jv.convert_torchvision_vgg19(vsd)["convs"]):
        np.testing.assert_array_equal(
            w.detach().numpy(), np.transpose(ref["w"], (3, 2, 0, 1)))
        np.testing.assert_array_equal(b.detach().numpy(), ref["b"])
    with pytest.raises(ValueError, match="convs"):
        vgg.load_torchvision({k: v for k, v in vsd.items()
                              if not k.startswith("features.0.")})


def test_preprocessing_and_its_constants():
    np.testing.assert_array_equal(resnet.IMAGENET_MEAN, jr.IMAGENET_MEAN)
    np.testing.assert_array_equal(resnet.IMAGENET_STD, jr.IMAGENET_STD)
    assert (resnet.STAGES, resnet.WIDTHS, resnet.EXPANSION) == (
        jr.STAGES, jr.WIDTHS, jr.EXPANSION)
    # extract_image_features.py:55-60: resize + ImageNet mean/std
    white = np.full((1, 8, 8, 3), 255, np.uint8)
    out = resnet.preprocess(torch.from_numpy(white), size=4).numpy()
    np.testing.assert_allclose(
        out[0, 0, 0], (1.0 - jr.IMAGENET_MEAN) / jr.IMAGENET_STD, rtol=1e-5)
    u8 = np.random.default_rng(0).integers(0, 256, (2, 37, 53, 3)).astype(
        np.uint8)
    for size in (16, 37, 64):  # shrink, keep, grow
        want = np.asarray(jr.preprocess(jnp.asarray(u8), size=size))
        got = resnet.preprocess(torch.from_numpy(u8), size=size).numpy()
        assert got.shape == want.shape == (2, size, size, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_extractor_constants_and_decode_error_classification():
    with pytest.raises(ValueError, match="unknown backbone"):
        GridExtractor("alexnet", device="cpu")
    ex = GridExtractor("resnet152", warmup=False, device="cpu")
    assert (ex.channels, ex.regions, ex.size) == (2048, 196, 448)
    assert ex.random_weights is True
    assert ex.regions == jax_extractor.GridExtractor.regions
    # undecodable bytes are a client error, raised before the trunk runs
    with pytest.raises(ValueError, match="could not decode image"):
        ex.from_bytes(b"not an image")
    ex = GridExtractor("vgg19", warmup=False, device="cpu")
    assert (ex.channels, ex.regions, ex.size) == (512, 196, 224)
    if not torch.cuda.is_available():
        # the default device is the card, never a silent CPU fallback
        with pytest.raises(RuntimeError, match="CUDA"):
            GridExtractor("vgg19", warmup=False)


def _png(seed: int, size=(300, 200)) -> bytes:
    arr = np.random.default_rng(seed).integers(
        0, 256, (size[1], size[0], 3)).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def test_extractor_grid_matches_jax(tmp_path):
    """From image bytes: the port's VGG extractor (the BILINEAR resize, the
    host normalisation, the trunk) in f32 against JAX's trunk at f32 on the
    same resized pixels (REL_ERR), and at the serving dtype bf16 against
    JAX's own extractor (BF16_REL_ERR). A trunk with the wrong
    normalisation is rejected."""
    vsd = vgg_state_dict(seed=8)
    np.savez(tmp_path / "vgg.npz", **vsd)
    params = jv.convert_torchvision_vgg19(vsd)
    raw = _png(9)
    img = Image.open(io.BytesIO(raw)).convert("RGB").resize(
        (224, 224), Image.BILINEAR)
    pixels = (np.asarray(img, np.float32)[None] / 255.0
              - jr.IMAGENET_MEAN) / jr.IMAGENET_STD
    want = np.asarray(jv.grid_features(params, jnp.asarray(pixels),
                                       dtype=jnp.float32))[0]
    ex = GridExtractor("vgg19", str(tmp_path / "vgg.npz"), device="cpu",
                       dtype=torch.float32)
    got = ex.from_bytes(raw)
    assert got.shape == (196, 512) and got.dtype == np.float32
    assert _rel_err(got, want) < REL_ERR
    unnormalised = np.asarray(jv.grid_features(
        params, jnp.asarray(np.asarray(img, np.float32)[None] / 255.0),
        dtype=jnp.float32))[0]
    assert _rel_err(unnormalised, want) > 100 * REL_ERR

    bf16 = GridExtractor("vgg19", str(tmp_path / "vgg.npz"), device="cpu")
    ref = jax_extractor.GridExtractor("vgg19", str(tmp_path / "vgg.npz"),
                                      warmup=False)
    assert _rel_err(bf16.from_bytes(raw), ref.from_bytes(raw)) < BF16_REL_ERR
    # from_array takes the already resized pixels: the same grid
    np.testing.assert_array_equal(bf16.from_array(np.asarray(img)),
                                  bf16.from_bytes(raw))


def test_random_trunks_draw_from_the_generator():
    a = resnet.random_params(torch.Generator().manual_seed(5), (1, 1, 1, 1))
    b = resnet.random_params(torch.Generator().manual_seed(5), (1, 1, 1, 1))
    c = resnet.random_params(torch.Generator().manual_seed(6), (1, 1, 1, 1))
    wa, wb, wc = (m.stem.weight for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    # He-normal: std sqrt(2 / fan_in) of the stem's 7 * 7 * 3 inputs
    assert abs(float(wa.std()) - (2.0 / 147) ** 0.5) < 0.01
    assert torch.equal(a.stem.scale, torch.ones(64))
    # each block's last batch norm damps the residual branch, so a random
    # trunk at full depth stays within an f16 store's range (with every
    # batch norm the identity the grid reaches ~1e10)
    assert torch.all(a.layer1[0].conv3.scale == resnet.RESIDUAL_SCALE)
    deep = resnet.random_params(torch.Generator().manual_seed(5)).eval()
    u8 = np.random.default_rng(1).integers(0, 256, (1, 64, 64, 3)).astype(
        np.uint8)
    with torch.no_grad():
        grid = resnet.extract(deep, torch.from_numpy(u8), torch.float32, 64)
    assert torch.isfinite(grid).all()
    assert 0 < float(grid.abs().max()) < 1e3
    v = vgg.random_params(torch.Generator().manual_seed(5))
    assert len(v.weights) == 16 and torch.isfinite(v.weights[15]).all()
