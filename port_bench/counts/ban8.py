"""Operations and bytes of BAN at a configuration's sizes ``s`` (its
``fields``), from shapes alone: T = ``max_question_length`` words (the
engine's questions are that wide), L = ``img_feature_dim`` grid cells, D
their channels, H = ``hidden_dim``, k = 3 BiAttention's rank, G =
``att_num`` glimpses, E = ``emb_dim`` a word table, A answers.

- ``serve_flops``: one question's serving forward, every matrix product
  at 2 operations a multiply-add: the GRU (input and recurrent products,
  T steps), BiAttention's projections (the grid's D -> kH, the words' H ->
  kH), the map S (G T L kH), each glimpse's projections (the grid's D ->
  H, the words' H -> H), its pool (P^T Bv, T L H, and the product with
  Bq, T H) and ``q_prj`` (H -> H, once: it is broadcast over T), and the
  classifier (H -> 2H -> A). Element-wise work is not counted.
- ``gemm``: the operations of the products that run as GEMM kernels for
  ``n`` questions: everything of ``serve_flops`` but S (N3) and the pool's
  element-wise product with Bq.
- ``attention``: N3's function for ``n`` questions: bytes (av [n, L, kH]
  and aq [n, T, kH] read, P [n, G, L, T] written, bf16; h [G, kH] f32 and
  the mask once) and its products (S, bf16).
"""

from typing import Dict

RANK = 3


def _dims(s: Dict):
    return (s["max_question_length"], s["img_feature_dim"],
            s["img_feature_channel"], s["hidden_dim"], s["emb_dim"],
            s["att_num"], s["a_vocab_size"])


def _parts(s: Dict) -> Dict[str, float]:
    """One question's products by part."""
    t, l, dim, h, e, g, a = _dims(s)
    kh = RANK * h
    return {"gru": 2 * t * (2 * e + h) * 3 * h,
            "att_projections": 2 * l * dim * kh + 2 * t * h * kh,
            "att_map": 2 * g * t * l * kh,
            "glimpse_projections": g * (2 * l * dim * h + 2 * t * h * h),
            "glimpse_pools": g * 2 * t * l * h,
            "glimpse_products": g * 2 * t * h,
            "q_prj": g * 2 * h * h,
            "classifier": 2 * h * 2 * h + 2 * 2 * h * a}


def serve_flops(s: Dict) -> float:
    return float(sum(_parts(s).values()))


def gemm(s: Dict, n: int) -> Dict[str, float]:
    parts = _parts(s)
    return {"bf16": float(n * (sum(parts.values()) - parts["att_map"]
                               - parts["glimpse_products"]))}


def attention(s: Dict, n: int) -> Dict[str, float]:
    t, l, _, h, _, g, _ = _dims(s)
    kh = RANK * h
    moved = 2 * n * (l + t) * kh + 2 * n * g * l * t + 4 * g * kh + n * l
    return {"bytes": float(moved), "bf16": float(2 * n * g * t * l * kh)}
