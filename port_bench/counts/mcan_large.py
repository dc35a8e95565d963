"""Operations and bytes of MCAN at a configuration's sizes ``s`` (its
``fields``), from shapes alone: T = ``max_question_length`` words (the
engine's questions are that wide), L = ``img_feature_dim`` grid cells, D
their channels, d = ``hidden_dim``, 4 d the FFN, 2 d the flat output, m
= ``embed_size`` AttFlat's MLP, A answers, ``att_num`` layers a stack.

- ``serve_flops``: one question's serving forward, every matrix product
  at 2 operations a multiply-add: the LSTM (input and recurrent products,
  T steps), the image projection, the encoder (Q, K, V, merge, the FFN,
  attention's two products over T x T), the decoder (self-attention over
  L x L, attention guided by the T question states, the FFN), AttFlat's
  MLPs, pools and merges, and the classifier. Element-wise work is not
  counted.
- ``gemm``: the operations of the products that run as GEMM kernels for
  ``n`` questions: everything of ``serve_flops`` but AttFlat's pools (an
  element-wise product and a sum).
- ``norm``: the fused residual + LayerNorm kernel's launches of one
  forward of ``n`` questions (2 an encoder layer over n T rows, 3 a decoder
  layer over n L rows, the head's over n rows of 2 d): bytes (x and r read
  and the output written once, bf16; the f32 gain and bias once a launch)
  and f32 operations (8 an element); ``norm_launches`` their number.
"""

from typing import Dict


def _dims(s: Dict):
    return (s["max_question_length"], s["img_feature_dim"],
            s["img_feature_channel"], s["hidden_dim"], s["emb_dim"],
            s["embed_size"], s["a_vocab_size"], s["att_num"])


def _parts(s: Dict) -> Dict[str, float]:
    """One question's products by part."""
    t, l, dim, d, e, m, a, layers = _dims(s)
    lstm = 2 * t * (e + d) * 4 * d
    encoder = layers * (4 * 2 * t * d * d + 2 * 2 * t * t * d
                        + 2 * 2 * t * d * 4 * d)
    decoder = layers * (4 * 2 * l * d * d + 2 * 2 * l * l * d
                        + 2 * 2 * l * d * d + 2 * 2 * t * d * d
                        + 2 * 2 * l * t * d + 2 * 2 * l * d * 4 * d)
    flat_mlps = sum(2 * r * (d * m + m) for r in (t, l))
    return {"lstm": lstm, "image": 2 * l * dim * d, "encoder": encoder,
            "decoder": decoder, "flat_mlps": flat_mlps,
            "flat_pools": 2 * (t + l) * d, "flat_merges": 2 * 2 * d * 2 * d,
            "classifier": 2 * 2 * d * a}


def serve_flops(s: Dict) -> float:
    return float(sum(_parts(s).values()))


def gemm(s: Dict, n: int) -> Dict[str, float]:
    parts = _parts(s)
    return {"bf16": float(n * (sum(parts.values()) - parts["flat_pools"]))}


def norm_launches(s: Dict) -> int:
    return 5 * s["att_num"] + 1


def norm(s: Dict, n: int) -> Dict[str, float]:
    t, l, _, d, _, _, _, layers = _dims(s)
    runs = ([(n * t, d)] * (2 * layers) + [(n * l, d)] * (3 * layers)
            + [(n, 2 * d)])
    return {"bytes": float(sum(6 * rows * w + 8 * w for rows, w in runs)),
            "f32": float(sum(8 * rows * w for rows, w in runs))}
