"""Plain PyTorch reference of VITS synthesis, the yardstick for the served
audio.

Written from the published model (VITS, arXiv:2106.06103, and the piper
training code it ships with: ``models.py`` SynthesizerTrn.infer,
``attentions.py``, ``modules.py``, ``transforms.py``), in the original
channel-first layout [B, C, T], reading the weights by their piper
state-dict names from a flat ``{name: tensor}`` dict. It imports torch
alone: nothing of the program under test, and no kernel.

Every float computes in float32. The caller decides whether cuBLAS and
cuDNN may use TF32 (:func:`precision`): the reference runs with it off, the
control of the comparison with it on.
"""

import contextlib
import math
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# fixed by the VITS code, not by a voice's config
REL_WINDOW = 4
SDP_KERNEL = 3
SDP_DDS_LAYERS = 3
SPLINE_BINS = 10
SPLINE_TAIL = 5.0
FLOW_COUPLINGS = 4
FLOW_WN_LAYERS = 4
MIN_BIN = 1e-3
MIN_DERIVATIVE = 1e-3
LRELU = 0.1


@contextlib.contextmanager
def precision(allow_tf32: bool):
    """cuBLAS and cuDNN products in float32 (``False``) or TF32 (``True``)
    inside the block; the flags are restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    torch.backends.cudnn.allow_tf32 = allow_tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Weights:
    """The flat weights, with weight norm resolved on read."""

    def __init__(self, flat: Dict[str, Tensor]):
        self.flat = flat

    def __getitem__(self, name: str) -> Tensor:
        return self.flat[name]

    def conv(self, prefix: str) -> Tensor:
        """``prefix.weight``, or ``g * v / ||v||`` (norm over every axis
        but the first) of a weight-normalised conv."""
        if prefix + ".weight" in self.flat:
            return self.flat[prefix + ".weight"]
        v = self.flat[prefix + ".weight_v"]
        g = self.flat[prefix + ".weight_g"]
        norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.dim())),
                                    keepdim=True))
        return g * v / norm

    def bias(self, prefix: str):
        return self.flat.get(prefix + ".bias")


def conv1d(w: Weights, prefix: str, x: Tensor, dilation: int = 1,
           groups: int = 1) -> Tensor:
    """Conv1d with 'same' padding for an odd kernel."""
    weight = w.conv(prefix)
    k = weight.shape[-1]
    pad = (k * dilation - dilation) // 2
    return F.conv1d(x, weight, w.bias(prefix), padding=pad,
                    dilation=dilation, groups=groups)


def layer_norm(w: Weights, prefix: str, x: Tensor) -> Tensor:
    """LayerNorm over channels of [B, C, T] (attentions.py LayerNorm)."""
    x = x.transpose(1, -1)
    x = F.layer_norm(x, (x.shape[-1],), w[prefix + ".gamma"],
                     w[prefix + ".beta"], eps=1e-5)
    return x.transpose(1, -1)


# -- text encoder -----------------------------------------------------------


def _rel_embeddings(emb: Tensor, length: int) -> Tensor:
    pad = max(length - (REL_WINDOW + 1), 0)
    start = max((REL_WINDOW + 1) - length, 0)
    if pad > 0:
        emb = F.pad(emb, (0, 0, pad, pad))
    return emb[:, start:start + 2 * length - 1]


def _rel_to_abs(x: Tensor) -> Tensor:
    b, h, length, _ = x.shape
    x = F.pad(x, (0, 1))
    x = x.reshape(b, h, length * 2 * length)
    x = F.pad(x, (0, length - 1))
    return x.reshape(b, h, length + 1, 2 * length - 1)[:, :, :length,
                                                       length - 1:]


def _abs_to_rel(x: Tensor) -> Tensor:
    b, h, length, _ = x.shape
    x = F.pad(x, (0, length - 1))
    x = x.reshape(b, h, length * length + length * (length - 1))
    x = F.pad(x, (length, 0))
    return x.reshape(b, h, length, 2 * length)[:, :, :, 1:]


def attention(w: Weights, prefix: str, x: Tensor, mask: Tensor,
              n_heads: int) -> Tensor:
    """Windowed relative-position self-attention (attentions.py
    MultiHeadAttention, heads_share=True)."""
    q = conv1d(w, prefix + ".conv_q", x)
    k = conv1d(w, prefix + ".conv_k", x)
    v = conv1d(w, prefix + ".conv_v", x)
    b, d, t = q.shape
    kc = d // n_heads
    q = q.view(b, n_heads, kc, t).transpose(2, 3)
    k = k.view(b, n_heads, kc, t).transpose(2, 3)
    v = v.view(b, n_heads, kc, t).transpose(2, 3)
    q = q / math.sqrt(kc)
    scores = torch.matmul(q, k.transpose(-2, -1))
    rel_k = _rel_embeddings(w[prefix + ".emb_rel_k"], t)
    scores = scores + _rel_to_abs(torch.matmul(q, rel_k.unsqueeze(0)
                                               .transpose(-2, -1)))
    scores = scores.masked_fill(mask == 0, -1e4)
    p = torch.softmax(scores, dim=-1)
    out = torch.matmul(p, v)
    rel_v = _rel_embeddings(w[prefix + ".emb_rel_v"], t)
    out = out + torch.matmul(_abs_to_rel(p), rel_v.unsqueeze(0))
    out = out.transpose(2, 3).reshape(b, d, t)
    return conv1d(w, prefix + ".conv_o", out)


def _ffn_conv(w: Weights, prefix: str, x: Tensor) -> Tensor:
    k = w[prefix + ".weight"].shape[-1]
    x = F.pad(x, ((k - 1) // 2, k // 2))
    return F.conv1d(x, w[prefix + ".weight"], w.bias(prefix))


def text_encoder(w: Weights, cfg: dict, ids: Tensor):
    """ids [1, T] -> (hidden x, m_p, logs_p), each [1, C, T]."""
    h = cfg["hidden_channels"]
    x = F.embedding(ids, w["enc_p.emb.weight"]) * math.sqrt(h)
    x = x.transpose(1, 2)
    x_mask = torch.ones_like(x[:, :1])
    mask = x_mask.unsqueeze(2) * x_mask.unsqueeze(-1)
    for i in range(cfg["n_layers"]):
        p = f"enc_p.encoder.{{}}.{i}"
        y = attention(w, p.format("attn_layers"), x, mask, cfg["n_heads"])
        x = layer_norm(w, p.format("norm_layers_1"), x + y)
        f = p.format("ffn_layers")
        y = torch.relu(_ffn_conv(w, f + ".conv_1", x))
        y = _ffn_conv(w, f + ".conv_2", y)
        x = layer_norm(w, p.format("norm_layers_2"), x + y)
    stats = conv1d(w, "enc_p.proj", x)
    m, logs = torch.split(stats, cfg["inter_channels"], dim=1)
    return x, m, logs


# -- stochastic duration predictor, reverse --------------------------------


def dds_conv(w: Weights, prefix: str, x: Tensor, g: Tensor = None) -> Tensor:
    """Dilated depth-separable conv stack (modules.py DDSConv)."""
    if g is not None:
        x = x + g
    channels = x.shape[1]
    for i in range(SDP_DDS_LAYERS):
        y = conv1d(w, f"{prefix}.convs_sep.{i}", x,
                   dilation=SDP_KERNEL ** i, groups=channels)
        y = F.gelu(layer_norm(w, f"{prefix}.norms_1.{i}", y))
        y = conv1d(w, f"{prefix}.convs_1x1.{i}", y)
        y = F.gelu(layer_norm(w, f"{prefix}.norms_2.{i}", y))
        x = x + y
    return x


def _bins(unnorm: Tensor, lo: float, hi: float):
    n = unnorm.shape[-1]
    sizes = torch.softmax(unnorm, dim=-1)
    sizes = MIN_BIN + (1 - MIN_BIN * n) * sizes
    cum = F.pad(torch.cumsum(sizes, dim=-1), (1, 0), value=0.0)
    cum = (hi - lo) * cum + lo
    cum = torch.cat([torch.full_like(cum[..., :1], lo), cum[..., 1:-1],
                     torch.full_like(cum[..., :1], hi)], dim=-1)
    return cum, cum[..., 1:] - cum[..., :-1]


def spline_inverse(x: Tensor, uw: Tensor, uh: Tensor, ud: Tensor) -> Tensor:
    """Inverse of the rational-quadratic spline with linear tails
    (transforms.py, tails='linear', tail_bound 5)."""
    b = SPLINE_TAIL
    const = math.log(math.exp(1 - MIN_DERIVATIVE) - 1)
    ud = F.pad(ud, (1, 1), value=const)
    cumw, widths = _bins(uw, -b, b)
    cumh, heights = _bins(uh, -b, b)
    deriv = MIN_DERIVATIVE + F.softplus(ud)
    locs = torch.cat([cumh[..., :-1], cumh[..., -1:] + 1e-6], dim=-1)
    idx = (torch.sum(x[..., None] >= locs, dim=-1) - 1).clamp(0, uw.shape[-1]
                                                              - 1)[..., None]

    def at(t):
        return t.gather(-1, idx)[..., 0]

    in_cw, in_w, in_ch, in_h = at(cumw), at(widths), at(cumh), at(heights)
    delta = heights / widths
    in_delta, in_d, in_d1 = at(delta), at(deriv), at(deriv[..., 1:])
    term = x - in_ch
    a = term * (in_d + in_d1 - 2 * in_delta) + in_h * (in_delta - in_d)
    bb = in_h * in_d - term * (in_d + in_d1 - 2 * in_delta)
    c = -in_delta * term
    disc = bb * bb - 4 * a * c
    root = (2 * c) / (-bb - torch.sqrt(disc))
    out = root * in_w + in_cw
    inside = (x >= -b) & (x <= b)
    return torch.where(inside, out, x)


def conv_flow_reverse(w: Weights, prefix: str, z: Tensor, cond: Tensor):
    """ConvFlow (modules.py) in reverse on z [B, 2, T]."""
    z0, z1 = z[:, :1], z[:, 1:]
    h = conv1d(w, prefix + ".pre", z0)
    h = dds_conv(w, prefix + ".convs", h, g=cond)
    n = SPLINE_BINS
    scale = 1.0 / math.sqrt(h.shape[1])
    h = conv1d(w, prefix + ".proj", h)  # [B, 3n-1, T]
    h = h.transpose(1, 2)[:, None]  # [B, 1, T, 3n-1]
    z1 = spline_inverse(z1, h[..., :n] * scale, h[..., n:2 * n] * scale,
                        h[..., 2 * n:])
    return torch.cat([z0, z1], dim=1)


def log_durations(w: Weights, x: Tensor, noise: Tensor) -> Tensor:
    """SDP reverse (models.py StochasticDurationPredictor, reverse=True)
    on the encoder's hidden x [1, H, T] from noise [1, 2, T] already
    scaled by noise_w: logw [1, 1, T]."""
    h = conv1d(w, "dp.pre", x.detach())
    h = dds_conv(w, "dp.convs", h)
    h = conv1d(w, "dp.proj", h)
    z = noise
    # reversed(flows) without the first ConvFlow ("a useless vflow"):
    # Flip, CF 7, Flip, CF 5, Flip, CF 3, Flip, ElementwiseAffine 0
    for idx in (7, 5, 3):
        z = torch.flip(z, [1])
        z = conv_flow_reverse(w, f"dp.flows.{idx}", z, h)
    z = torch.flip(z, [1])
    m = w["dp.flows.0.m"].reshape(1, 2, 1)
    logs = w["dp.flows.0.logs"].reshape(1, 2, 1)
    z = (z - m) * torch.exp(-logs)
    return z[:, :1]


# -- residual coupling flow, reverse ---------------------------------------


def wavenet(w: Weights, prefix: str, x: Tensor, n_layers: int) -> Tensor:
    """WN (modules.py) without conditioning, dilation 1."""
    hidden = x.shape[1]
    out = torch.zeros_like(x)
    for i in range(n_layers):
        acts = conv1d(w, f"{prefix}.in_layers.{i}", x)
        acts = torch.tanh(acts[:, :hidden]) * torch.sigmoid(acts[:, hidden:])
        rs = conv1d(w, f"{prefix}.res_skip_layers.{i}", acts)
        if i < n_layers - 1:
            x = x + rs[:, :hidden]
            out = out + rs[:, hidden:]
        else:
            out = out + rs
    return out


def flow_reverse(w: Weights, z: Tensor) -> Tensor:
    """ResidualCouplingBlock (mean only) in reverse on z [1, C, T]."""
    half = z.shape[1] // 2
    for i in reversed(range(FLOW_COUPLINGS)):
        z = torch.flip(z, [1])
        p = f"flow.flows.{2 * i}"
        z0, z1 = z[:, :half], z[:, half:]
        h = conv1d(w, p + ".pre", z0)
        h = wavenet(w, p + ".enc", h, FLOW_WN_LAYERS)
        z = torch.cat([z0, z1 - conv1d(w, p + ".post", h)], dim=1)
    return z


# -- HiFi-GAN decoder --------------------------------------------------------


def decoder(w: Weights, cfg: dict, z: Tensor) -> Tensor:
    """Generator (models.py): z [1, C, T] -> audio [1, T * prod(rates)]."""
    x = conv1d(w, "dec.conv_pre", z)
    kernels = cfg["resblock_kernel_sizes"]
    dilations = cfg["resblock_dilation_sizes"]
    for i, (rate, k) in enumerate(zip(cfg["upsample_rates"],
                                      cfg["upsample_kernel_sizes"])):
        x = F.leaky_relu(x, LRELU)
        p = f"dec.ups.{i}"
        x = F.conv_transpose1d(x, w.conv(p), w.bias(p), stride=rate,
                               padding=(k - rate) // 2)
        acc = None
        for j, dils in enumerate(dilations):
            r = f"dec.resblocks.{i * len(kernels) + j}"
            y = x
            for n, d in enumerate(dils):
                if cfg["resblock"] == "1":
                    t = conv1d(w, f"{r}.convs1.{n}", F.leaky_relu(y, LRELU),
                               dilation=d)
                    t = conv1d(w, f"{r}.convs2.{n}", F.leaky_relu(t, LRELU))
                else:
                    t = conv1d(w, f"{r}.convs.{n}", F.leaky_relu(y, LRELU),
                               dilation=d)
                y = y + t
            acc = y if acc is None else acc + y
        x = acc / len(kernels)
    x = conv1d(w, "dec.conv_post", F.leaky_relu(x, 0.01))
    return torch.tanh(x)[:, 0]


# -- synthesis ---------------------------------------------------------------


def log_w(w: Weights, cfg: dict, ids: Sequence[int], device) -> Tensor:
    """The duration predictor's log-durations [T] of one utterance at
    noise_w 0."""
    x, _, _ = text_encoder(w, cfg, torch.tensor([list(ids)], device=device))
    return log_durations(w, x, torch.zeros_like(x[:, :2]))[0, 0]


def durations(logw: Tensor, length_scale: float) -> Tensor:
    """Frames per id: ceil(exp(logw) * length_scale), in float32 as a
    float32 voice counts them."""
    return torch.ceil(torch.exp(logw) * length_scale)


def synthesize(w: Weights, cfg: dict, ids: Sequence[int],
               length_scale: float, frames: Tensor = None) -> Tensor:
    """One utterance at noise_scale 0 and noise_w 0: audio [N] float32.
    ``frames`` [T] overrides the durations (a near tie resolved the other
    way, :mod:`compare`)."""
    dev = w["enc_p.emb.weight"].device
    x, m_p, _ = text_encoder(w, cfg, torch.tensor([list(ids)], device=dev))
    if frames is None:
        logw = log_durations(w, x, torch.zeros_like(x[:, :2]))[0, 0]
        frames = durations(logw, length_scale)
    reps = frames.long().clamp(min=0)
    z_p = torch.repeat_interleave(m_p[0], reps, dim=1)[None]
    if z_p.shape[-1] == 0:
        z_p = m_p[:, :, :1] * 0
    z = flow_reverse(w, z_p)
    return decoder(w, cfg, z)[0]
