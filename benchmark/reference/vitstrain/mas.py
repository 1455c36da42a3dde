"""Monotonic alignment search (MAS) in plain PyTorch: a frozen copy of the
program's plain version (``phoonnx_tpu_torch/ops/mas.py``), which the
program's kernel D computes bit for bit: a forward max-plus DP over spec
frames (stay vs advance, the advance forced where x == y, ``-1e9`` as
minus infinity), then a backtrack from ``x_len - 1`` that stays on a tie.
"""

import torch

Tensor = torch.Tensor

NEG_INF = -1e9


def lengths_and_value(neg_cent: Tensor, attn_mask: Tensor):
    """(value f32, y_lens int32, x_lens int32) as ``mas.py:74-79`` counts
    them: int32 sums of the mask's first column and first row, at least 1
    (a half-precision sum would quantize above 256), and the scores zeroed
    outside the mask."""
    y_lens = torch.clamp(
        torch.sum(attn_mask[:, :, 0].to(torch.int32), dim=1), min=1)
    x_lens = torch.clamp(
        torch.sum(attn_mask[:, 0, :].to(torch.int32), dim=1), min=1)
    value = torch.where(attn_mask > 0, neg_cent,
                        torch.zeros((), dtype=neg_cent.dtype,
                                    device=neg_cent.device)).float()
    return (value.contiguous(), y_lens.to(torch.int32).contiguous(),
            x_lens.to(torch.int32).contiguous())


def maximum_path(neg_cent: Tensor, attn_mask: Tensor) -> Tensor:
    """Best monotonic path; neg_cent / attn_mask [B, T_y, T_x] -> 0/1 path
    [B, T_y, T_x] in neg_cent's dtype, times the mask (``mas.py:112``)."""
    value, y_lens, x_lens = lengths_and_value(neg_cent, attn_mask)
    path = maximum_path_plain(value, y_lens, x_lens)
    return path.to(neg_cent.dtype) * attn_mask


def maximum_path_plain(value: Tensor, y_lens: Tensor,
                       x_lens: Tensor) -> Tensor:
    """The function kernel D computes, in plain PyTorch ops: a Python loop
    over T_y, vectorised over batch and T_x. value [B, T_y, T_x] f32,
    lengths [B] int32 -> path [B, T_y, T_x] f32."""
    b, t_y, t_x = value.shape
    dev = value.device
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    x_idx = torch.arange(t_x, device=dev)[None, :]
    q_prev = torch.full((b, t_x), NEG_INF, dtype=torch.float32, device=dev)
    q_all = torch.empty((t_y, b, t_x), dtype=torch.float32, device=dev)
    for y in range(t_y):
        stay = torch.where(x_idx == y, neg, q_prev)
        # x == 0 has no diagonal predecessor; its path starts at y == 0
        first = torch.full((b, 1), 0.0 if y == 0 else NEG_INF,
                           dtype=torch.float32, device=dev)
        advance = torch.cat([first, q_prev[:, :-1]], dim=1)
        q_prev = value[:, y, :] + torch.maximum(stay, advance)
        q_all[y] = q_prev

    y_lens = y_lens.long()
    x_cur = torch.clamp(x_lens.long(), 1, t_x) - 1
    path = torch.zeros((b, t_y, t_x), dtype=torch.float32, device=dev)
    for y in range(t_y - 1, -1, -1):
        inside = y < y_lens
        path[:, y, :] = ((x_idx == x_cur[:, None])
                         & inside[:, None]).to(torch.float32)
        q_prev = q_all[max(y - 1, 0)]
        q_stay = torch.gather(q_prev, 1, x_cur[:, None])[:, 0]
        q_diag = torch.gather(q_prev, 1,
                              torch.clamp(x_cur - 1, min=0)[:, None])[:, 0]
        advance = (x_cur != 0) & ((x_cur == y) | (q_stay < q_diag))
        x_cur = torch.where(inside & (y > 0) & advance, x_cur - 1, x_cur)
    return path


