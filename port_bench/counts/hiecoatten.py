"""Operations of hieCoAtten at a configuration's sizes ``s``, from shapes.

- ``serve_flops``: one question's serving forward: the grid embedding
  [L, D] x [D, E], the four E x E projections (two of the grid, two of the
  words), the affinity C = Cq Cv^T, the two attended products (C^T Wq and
  C Wv), the two attention scores and pools, and the classifier.
  Element-wise work is not counted.
"""

from typing import Dict


def serve_flops(s: Dict) -> float:
    t, l = s["max_question_length"], s["img_feature_dim"]
    d, e, a = s["img_feature_channel"], s["embed_size"], s["a_vocab_size"]
    embed = 2 * l * d * e
    projections = 2 * (2 * l * e * e) + 2 * (2 * t * e * e)
    coattention = 3 * (2 * t * l * e)
    attention = 2 * (2 * l * e) + 2 * (2 * t * e)
    return embed + projections + coattention + attention + 2 * 2 * e * a
