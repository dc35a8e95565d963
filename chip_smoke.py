"""Smoke run of the PyTorch port on one NVIDIA card (H100, sm_90a).

    python3 chip_smoke.py

Phases, one line each (a failing phase raises and the exit code is not 0):

1. the device: torch's name for it, and nvidia-smi's name and power limit;
2. build the hand-written kernels from ``vqa_attention_networks_tpu_torch/
   csrc`` into ``build/kernels/`` and print the seconds it took;
3. K1 (stage-1 fusion + co-attention) against its plain PyTorch version on
   the card at production shapes, N = 8, 256 and 1024: max and mean |diff|,
   failing past the tolerance of ``within``; the kernel's z and h1 scratch
   against the plain version's; and a control: the inputs peak the
   attention over the 196 regions, and the check must reject the uniform
   mean of img on most elements, since that is what a kernel with a dead
   fusion or hidden stage would give;
4. full-width bf16 mhb_coAtt (``Config()`` defaults, random weights from a
   seed; the co-attention weights drawn at a scale that peaks the
   attention) served by ``InferenceEngine.predict_stream`` at batch 256
   over 8 batches (2048 requests) of features gathered from a synthetic
   feature store: the K1 launch count of that run, and top-1 flips against
   the same forward with the plain K1, at most 0.1% (``flips``); a control
   that the gate counts the answers of a uniform attention as flips; and,
   for information only, flips against ``fast_path="composed"``;
5. times: K1 and its plain version at N = 256 and 1024 (CUDA events after
   warm-up), and the end-to-end qa-pairs/s of step 4;

then a JSON line of the kernels, nvidia-smi's line, and as the last line
``{"ok": true, "device": {...}}``. With no card it exits non-zero before
phase 2.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from vqa_attention_networks_tpu.config import Config
from vqa_attention_networks_tpu.data.feature_store import (
    make_synthetic_feature_store,
)
from vqa_attention_networks_tpu_torch.models.mhb_coatt import (
    MHBCoAtt,
    init_params,
)
from vqa_attention_networks_tpu_torch.ops import _build
from vqa_attention_networks_tpu_torch.ops import wq_fusion as wqf
from vqa_attention_networks_tpu_torch.serve import InferenceEngine
from vqa_attention_networks_tpu_torch.weights import load_jax_params

# K1's output against its plain version, per glimpse row of D outputs:
# |diff| <= ATOL + RTOL_ROW * max |row|. The two share their rounding points
# and differ only in the order of their f32 sums, so ~0.7% of h1 lands one
# bf16 ulp apart. Through c2w such a flip moves the logits, and with them
# the (peaked) attention, which moves every output of the row by up to
# ~1.2% of the row's largest magnitude: an output near 0 from cancellation
# moves as much as a large one. RTOL_ROW is four bf16 ulps (2^-5).
ATOL, RTOL_ROW = 2e-3, 2.0 ** -5
# the kernel's scratch: z is held before its signed sqrt (z * |z| is
# img @ wq + bq, f32; near 0 the sqrt would turn an f32 summation-order
# difference e into sqrt(e)); h1 (bf16) to one bf16 ulp plus H1_ATOL: the
# two norms of z differ by an f32 ulp (another summation order), so a zb
# at a bf16 rounding boundary rounds apart, and each such flip moves h1 by
# |c1w| * ulp(zb), about 1.2e-4 at most at these inputs
POOLED_ATOL, POOLED_RTOL = 1e-4, 1e-4
H1_ATOL, H1_RTOL = 5e-4, 2.0 ** -7
MAX_FLIP_RATE = 1e-3
BATCH, N_BATCHES, N_IMAGES = 256, 8, 256
K1_SOURCE = "vqa_attention_networks_tpu_torch/csrc/stage1_coattention.cu"
K1_REPLACES = "vqa_attention_networks_tpu/ops/pallas_wq_fusion.py:205"


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def card() -> tuple:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script needs an "
              "NVIDIA card", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(0), smi


def k1_inputs(n: int, seed: int, cfg: Config, device) -> tuple:
    """Random production-shape K1 inputs: bf16 img, f32 q and weights."""
    rng = np.random.default_rng(seed)
    d, f = cfg.img_feature_channel, cfg.fusion_dim
    o, c = cfg.mfb_out, 512

    def t(shape, scale):
        x = rng.standard_normal(shape, dtype=np.float32) * scale
        return torch.from_numpy(x).to(device)

    img = t((n, cfg.img_feature_dim, d), 0.5).to(torch.bfloat16)
    q = t((n, f), 0.5)
    # after the grid-flat L2 norm zb is ~2.5e-3 per element: c1w ~ N(0, 1)
    # with no bias and c2w ~ 3 N(0, 1) make the logits span several units
    # over the 196 regions, so the attention is peaked
    sw = wqf.prepare_stage1_weights(
        t((d, f), 0.02), t((f,), 0.05), t((o, c), 1.0), t((c,), 0.0),
        t((c, 2), 3.0), t((2,), 0.05), cfg.mfb_factor,
    )
    return img, q, sw


def within(got: torch.Tensor, want: torch.Tensor, d: int) -> torch.Tensor:
    """Elementwise: is ``got`` within the tolerance of ``want`` [N, G*D]?"""
    got = got.float().reshape(got.shape[0], -1, d)
    want = want.float().reshape(got.shape)
    scale = want.abs().amax(-1, keepdim=True)
    return (got - want).abs() <= ATOL + RTOL_ROW * scale


def uniform_rejected(img: torch.Tensor, out: torch.Tensor) -> float:
    """Control: the share of a uniform-attention output (the mean of img
    over L) that the check rejects against ``out``. It fails under 0.5: with
    a near-uniform attention the check cannot see the stages before it."""
    n, _, d = img.shape
    g = out.numel() // (n * d)
    uniform = img.float().mean(1, keepdim=True).expand(n, g, d)
    share = 1.0 - float(within(uniform, out, d).float().mean())
    if share < 0.5:
        raise AssertionError(
            f"the check rejects only {share:.3f} of a uniform-attention "
            "output: it would not see a fault upstream of the softmax")
    return share


def flips(logits: torch.Tensor, answers: torch.Tensor) -> int:
    """Answers that ``logits`` rank more than one bf16 ulp of the top logit
    below the top. The model's logits are bf16; two answers within one ulp
    tie at that resolution, and another f32 summation order upstream may
    break the tie either way."""
    top = logits.max(-1).values
    ulp = torch.exp2(torch.floor(torch.log2(top.abs().clamp_min(1e-30))) - 7)
    return int((logits.gather(-1, answers[:, None])[:, 0] < top - ulp).sum())


def scratch_diff(got, want, atol, rtol) -> tuple:
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    ok = bool(torch.all(diff <= atol + rtol * want.abs()))
    return ok, float(diff.max()), float((diff == 0).float().mean())


def time_ms(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def main() -> None:
    # phase 1: the device
    name, smi = card()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions: f32
    torch.backends.cudnn.allow_tf32 = False
    say("device", torch_name=name, nvidia_smi=smi,
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    # phase 2: build
    path, seconds, log = _build.build("stage1_coattention")
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    say("build", library=str(path.relative_to(_build.BUILD_DIR.parents[1])),
        seconds=round(seconds, 2), arch="sm_90a", ptxas=ptxas)

    # phase 3: K1 against its plain version at production shapes
    cfg = Config()
    max_err = 0.0
    for n in (8, 256, 1024):
        img, q, sw = k1_inputs(n, seed=n, cfg=cfg, device=dev)
        got, z, h1 = wqf.stage1_coattention_cuda(img, q, sw,
                                                 intermediates=True)
        want, want_z, want_h1 = wqf.stage1_coattention_reference(
            img, q, sw, intermediates=True)
        again = wqf.stage1_coattention(img, q, sw)
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        diff = (got - want).abs()
        ok = bool(within(got, want, img.shape[2]).all())
        z_ok, z_max, z_equal = scratch_diff(
            z * z.abs(), want_z * want_z.abs(), POOLED_ATOL, POOLED_RTOL)
        h1_ok, h1_max, h1_equal = scratch_diff(h1, want_h1, H1_ATOL, H1_RTOL)
        max_err = max(max_err, float(diff.max()))
        say("k1_check", n=n, max_abs_diff=float(diff.max()),
            mean_abs_diff=float(diff.mean()), within_tolerance=ok,
            pooled_max_abs_diff=z_max, z_bit_equal_share=z_equal,
            h1_max_abs_diff=h1_max, h1_bit_equal_share=h1_equal,
            uniform_rejected_share=uniform_rejected(img, want),
            rerun_bit_equal=bool(torch.equal(got, again.float())),
            finite=bool(torch.isfinite(got).all()))
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(f"K1 disagrees with its plain version at N={n}")
        if not (z_ok and h1_ok):
            raise AssertionError(f"K1's z or h1 scratch disagrees with the "
                                 f"plain version at N={n}")
        if not torch.equal(got, again.float()):
            raise AssertionError("K1 is not deterministic across reruns")
        del img, q, sw, got, want, again, z, h1, want_z, want_h1

    # phase 4: full-width mhb_coAtt served through predict_stream
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen)
    # xavier co-attention weights with zero biases leave the attention near
    # uniform (as in step 3); draw them at the scale that peaks it
    params["co_att_conv1"]["w"] = torch.randn(cfg.mfb_out, 512, generator=gen)
    params["co_att_conv2"]["w"] = 3.0 * torch.randn(512, 2, generator=gen)
    engine = InferenceEngine(cfg, params, batch_size=BATCH, topk=5)
    rng = np.random.default_rng(0)
    n_req = BATCH * N_BATCHES
    # presampled traffic: each image backs several questions, as in VQA
    image_ids = rng.integers(0, N_IMAGES, n_req)
    lengths = rng.integers(4, cfg.max_question_length + 1, n_req)
    ques = rng.integers(1, cfg.q_vocab_size,
                        (n_req, cfg.max_question_length)).astype(np.int32)
    ques[np.arange(cfg.max_question_length)[None, :] >= lengths[:, None]] = 0
    with tempfile.TemporaryDirectory() as tmp:
        store = make_synthetic_feature_store(tmp, list(range(N_IMAGES)))

        def batches():
            for s in range(0, n_req, BATCH):
                feats = store.gather(image_ids[s:s + BATCH], np.float16)
                yield feats, ques[s:s + BATCH], None

        list(engine.predict_stream(batches()))  # warm-up pass
        torch.cuda.synchronize()
        wqf.launch_count = 0
        t0 = time.perf_counter()
        preds = [p for batch in engine.predict_stream(batches())
                 for p in batch]
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        launches = wqf.launch_count
        if launches < N_BATCHES:
            raise AssertionError(f"K1 launched {launches} times in the run")

        answers = np.array([p.answer_id for p in preds])
        probs = np.stack([p.top_probs for p in preds])
        if len(preds) != n_req or not np.isfinite(probs).all() or (
                probs.sum(-1) > 1.0 + 1e-3).any():
            raise AssertionError("served predictions are malformed")

        # the served answers against the same forward with K1's plain
        # version; for information, against the composed chain; and a
        # control: with co_att_conv2 zeroed the attention is uniform, which
        # is what a K1 with a dead fusion or hidden stage gives, and the
        # gate must count its answers as flips
        model: MHBCoAtt = engine.model
        bf16_cfg = cfg.replace(compute_dtype="bfloat16")
        composed = load_jax_params(
            MHBCoAtt(bf16_cfg.replace(fast_path="composed")).to(dev), params)
        blind = load_jax_params(MHBCoAtt(bf16_cfg).to(dev), dict(
            params, co_att_conv2={"w": torch.zeros(512, 2),
                                  "b": torch.zeros(2)}))
        n_flips = n_composed = n_blind = n_argmax = 0
        for s, (feats, qs, _) in zip(range(0, n_req, BATCH), batches()):
            img = torch.from_numpy(feats).to(dev)
            qt = torch.from_numpy(qs).to(dev)
            served = torch.from_numpy(answers[s:s + BATCH]).to(dev)
            with torch.inference_mode():
                plain = model(img, qt, reference_stage1=True)
                n_flips += flips(plain, served)
                n_argmax += int((plain.argmax(-1) != served).sum())
                n_composed += flips(composed(img, qt), served)
                n_blind += flips(
                    plain, blind(img, qt, reference_stage1=True).argmax(-1))
        del composed, blind
    say("serve", requests=n_req, batch=BATCH, k1_launches=launches,
        flips_vs_plain_k1=n_flips, flip_rate=n_flips / n_req,
        control_uniform_attention_flip_rate=n_blind / n_req,
        argmax_differs_info_only=n_argmax,
        flip_rate_vs_composed_info_only=n_composed / n_req,
        distinct_answers=int(len(np.unique(answers))))
    if n_blind / n_req < 10 * MAX_FLIP_RATE:
        raise AssertionError("the flip gate does not see a uniform attention")
    if n_flips / n_req > MAX_FLIP_RATE:
        raise AssertionError(f"{n_flips} top-1 flips against the plain K1")

    # phase 5: times, on this card at its power limit
    times = {}
    for n in (256, 1024):
        img, q, sw = k1_inputs(n, seed=n, cfg=cfg, device=dev)

        def kernel():
            wqf.stage1_coattention(img, q, sw)

        def plain():
            wqf.stage1_coattention_reference(img, q, sw)

        kernel(), plain()  # warm-up
        plain_a = time_ms(plain, 3)
        kernel_a = time_ms(kernel, 10)
        kernel_b = time_ms(kernel, 10)
        plain_b = time_ms(plain, 3)
        times[n] = ((kernel_a + kernel_b) / 2, (plain_a + plain_b) / 2)
        say("k1_time", n=n, kernel_ms=times[n][0], plain_ms=times[n][1],
            kernel_runs_ms=[kernel_a, kernel_b], plain_runs_ms=[plain_a, plain_b],
            card=smi)
        del img, q, sw
    say("e2e", qa_pairs_per_s=n_req / e2e_s, seconds=e2e_s,
        batch=BATCH, requests=n_req, card=smi)

    print(json.dumps({"kernels": [{
        "name": "stage1_coattention", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": times[256][0],
        "plain_ms": times[256][1],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
