"""Operations and bytes of mhb_coAtt at a configuration's sizes ``s`` (its
``fields``), from shapes alone.

- ``serve_flops``: one question's serving forward: the LSTM (input and
  recurrent products, T steps), the question glimpse, ``ques_proj1``, the
  stage-1 fusion and co-attention as the weight-contracted algorithm
  (the per-question contracted weights wq [D, O] in float32, then the grid
  product with wq, the co-attention's two products and its pool), the two
  output fusions and the classifier. Element-wise work is not counted.
- ``train_flops``: one row of a pre-pool training step: everything above
  but the stage-1 fusion three times (forward and a backward with input
  gradients), and the pre-pool fusion as the training algorithm must run
  it (the dropout sits on the [L, k*O] product, so no contraction): its
  forward product, d_W's and d_q's (no d_img: the features take no
  gradient), and the co-attention's convolution three times.
- ``k1``: K1's function (the weight-contracted stage-1 fusion with the
  co-attention) for ``n`` questions: operations by type and bytes.
- ``k2``: K2's four launches of a step of ``n`` rows (forward, the g_prod
  build, d_W's product, d_q), each operations by type and bytes.
"""

from typing import Dict


def _dims(s: Dict):
    k, o = s["mfb_factor"], s["mfb_out"]
    return (s["max_question_length"], s["img_feature_dim"],
            s["img_feature_channel"], s["hidden_dim"], s["emb_dim"], k, o,
            k * o, s["a_vocab_size"])


def _question_side(s: Dict) -> float:
    t, _, _, h, e, _, _, f, a = _dims(s)
    lstm = 2 * t * (e + h) * 4 * h
    glimpse = 2 * t * h * 512 + 2 * t * 512 * 2 + 2 * t * 2 * h
    return lstm + glimpse + 2 * (2 * h) * f  # ques_proj1


def _output_side(s: Dict) -> float:
    _, _, d, h, _, _, o, f, a = _dims(s)
    fusions = 2 * (2 * (2 * h) * f + 2 * (2 * d) * f)
    return fusions + 2 * (2 * o) * a


def k1(s: Dict, n: int) -> Dict[str, float]:
    t, l, d, h, e, k, o, f, a = _dims(s)
    c, g = 512, 2
    return {"bf16": 2.0 * n * l * (d * o + o * c + c * g + g * d),
            "f32": 2.0 * n * k * d * o,
            "bytes": (2.0 * n * l * d + 2 * n * f + 2 * d * f + 4 * f
                      + 2 * o * c + 4 * c + 2 * c * g + 4 * g
                      + 2 * n * g * d)}


def serve_flops(s: Dict) -> float:
    op = k1(s, 1)
    return _question_side(s) + op["bf16"] + op["f32"] + _output_side(s)


def k2(s: Dict, n: int) -> Dict[str, Dict[str, float]]:
    t, l, d, h, e, k, o, f, a = _dims(s)
    prod = 2.0 * n * l * d * f
    img, w, b = 2.0 * n * l * d, 2.0 * d * f, 4.0 * f
    q, out = 4.0 * n * f, 4.0 * n * l * o
    g_prod = 2.0 * n * l * f
    partials = 4.0 * -(-n * l // 64) * f
    return {
        "forward": {"bf16": prod, "bytes": img + w + b + q + out},
        "g_prod": {"f32": 4.0 * n * l * f,
                   "bytes": out + out + q + g_prod + partials},
        "d_w": {"bf16": prod,
                "bytes": img + g_prod + partials + 4.0 * d * f + 4.0 * f},
        "d_q": {"bf16": prod, "bytes": out + out + img + w + b + q},
    }


def train_flops(s: Dict) -> float:
    t, l, d, h, e, k, o, f, a = _dims(s)
    coatt = 2 * l * o * 512 + 2 * l * 512 * 2 + 2 * l * 2 * d
    rest = 3 * (_question_side(s) + coatt + _output_side(s))
    return rest + 3 * 2.0 * l * d * f
