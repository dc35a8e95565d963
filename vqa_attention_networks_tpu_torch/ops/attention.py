"""The 2-glimpse attention block (port of ``glimpse_attention`` in
``vqa_attention_networks_tpu/ops/pallas_attention.py``), running the math of
its composed twin ``_glimpse_reference``:

    a   = relu(x @ W1 + b1) @ W2 + b2      [N, P, G]
    w_g = softmax(a[:, :, g], over P)
    out = concat_g(sum_p w_g[p] * v[p])   [N, G*D]

The JAX dispatcher runs its Pallas block (K7) only under the opt-in
``VQA_PALLAS_GLIMPSE``; that kernel waits for a later slice.
"""

from __future__ import annotations

import torch

from vqa_attention_networks_tpu_torch.models.layers import matmul_f32
from vqa_attention_networks_tpu_torch.ops.fusion import two_glimpse_pool


def glimpse_attention(
    x: torch.Tensor,  # [N, P, C] features the MLP scores
    w1: torch.Tensor, b1: torch.Tensor,  # [A, C], [A] (PyTorch layout)
    w2: torch.Tensor, b2: torch.Tensor,  # [G, A], [G]
    v: torch.Tensor,  # [N, P, D] values to pool
    *,
    uniform_quirk: bool,
) -> torch.Tensor:
    """-> [N, G*D] in x's dtype. The MLP accumulates in f32 and rounds the
    hidden layer to x's dtype; the logits stay f32."""
    acc = torch.promote_types(x.dtype, torch.float32)
    w1t = w1.to(x.dtype).t()
    w2t = w2.to(x.dtype).t()
    if x.dtype == acc:
        h = torch.relu(torch.matmul(x, w1t) + b1.to(acc))
        logits = torch.matmul(h, w2t) + b2.to(acc)
    else:
        h = torch.relu(matmul_f32(x, w1t) + b1.to(acc)).to(x.dtype)
        logits = matmul_f32(h, w2t) + b2.to(acc)
    out = two_glimpse_pool(logits, v, uniform_quirk=uniform_quirk)
    return out.to(x.dtype)
