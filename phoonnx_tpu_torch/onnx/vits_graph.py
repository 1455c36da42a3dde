"""Executable ONNX graph export of the VITS inference path.

Builds the complete synthesis graph — text encoder (windowed rel-pos
attention), stochastic duration predictor reverse (RQ splines), duration →
monotonic path, inverse coupling flows, HiFi-GAN — as opset-15 ONNX nodes
with the reference exporter's I/O contract (export_onnx.py:250-327):

    inputs:  input [B,T] i64, input_lengths [B] i64, scales [3] f32
             (+ sid [B] i64 for multi-speaker)
    output:  output [B, 1, T_audio] f32

so voices exported by phoonnx_tpu run under onnxruntime / the piper
ecosystem, and equally under phoonnx_tpu's own executor (used by the
round-trip tests). Weight-norm pairs are folded at build time; dynamic
batch/length handled via shape arithmetic.
"""

import math
from typing import Dict, Optional

import numpy as np

from phoonnx_tpu_torch.onnx.builder import GraphBuilder


def _hann(win_size: int) -> np.ndarray:
    """Periodic Hann — single source of truth in ops/stft (this module
    already pulls jax transitively through the PQMF import for
    multi-band exports, so the lazy import costs nothing new)."""
    from phoonnx_tpu_torch.ops.stft import hann_window

    return hann_window(win_size)

F32 = 1
I64 = 7

_LN_EPS = 1e-5


def fold_weight_norm(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fold every (weight_v, weight_g) pair into a plain weight."""
    out = {}
    for name, value in flat.items():
        if name.endswith(".weight_g"):
            continue
        if name.endswith(".weight_v"):
            base = name[: -len(".weight_v")]
            v = np.asarray(value, np.float64)
            g = np.asarray(flat[base + ".weight_g"], np.float64)
            axes = tuple(range(1, v.ndim))
            norm = np.sqrt((v ** 2).sum(axis=axes, keepdims=True))
            out[base + ".weight"] = (g * v / norm).astype(np.float32)
        else:
            out[name] = np.asarray(value)
    return out


class VitsGraph:
    def __init__(self, flat: Dict[str, np.ndarray], hp):
        self.p = fold_weight_norm(flat)
        self.hp = hp
        self.b = GraphBuilder()
        self.multispeaker = hp.n_speakers > 1

    # -- parameter access ------------------------------------------------

    def w(self, name: str) -> str:
        if name not in self.b.initializers:
            self.b.init(name, self.p[name].astype(np.float32))
        return name

    def has(self, name: str) -> bool:
        return name in self.p

    def conv(self, x, prefix, stride=1, padding=0, dilation=1, group=1):
        bias = (self.w(f"{prefix}.bias")
                if self.has(f"{prefix}.bias") else None)
        return self.b.conv1d(
            x, self.w(f"{prefix}.weight"), bias,
            stride=stride, padding=padding, dilation=dilation, group=group,
        )

    # -- generic blocks --------------------------------------------------

    def layer_norm(self, x_nct, prefix):
        """LayerNorm over channels of [B, C, T] (gamma/beta [C])."""
        b = self.b
        x = b.transpose(x_nct, (0, 2, 1))  # [B, T, C]
        mean = b.n("ReduceMean", [x], axes=[-1], keepdims=1)
        centered = b.sub(x, mean)
        var = b.n("ReduceMean", [b.mul(centered, centered)],
                  axes=[-1], keepdims=1)
        inv = b.div(b.f32(1.0), b.sqrt(b.add(var, b.f32(_LN_EPS))))
        out = b.mul(centered, inv)
        out = b.mul(out, self.w(f"{prefix}.gamma"))
        out = b.add(out, self.w(f"{prefix}.beta"))
        return b.transpose(out, (0, 2, 1))

    def gelu(self, x):
        b = self.b
        return b.mul(
            b.mul(x, b.f32(0.5)),
            b.add(b.f32(1.0),
                  b.n("Erf", [b.mul(x, b.f32(1.0 / math.sqrt(2.0)))])),
        )

    def dds_conv(self, x, x_mask, prefix, kernel_size, n_layers, g=None):
        """Dilated depth-separable stack [B, C, T] (modules.py:81-129)."""
        b = self.b
        channels = self.p[f"{prefix}.convs_sep.0.weight"].shape[0]
        if g is not None:
            x = b.add(x, g)
        for i in range(n_layers):
            dilation = kernel_size ** i
            padding = (kernel_size * dilation - dilation) // 2
            y = self.conv(b.mul(x, x_mask), f"{prefix}.convs_sep.{i}",
                          padding=padding, dilation=dilation, group=channels)
            y = self.layer_norm(y, f"{prefix}.norms_1.{i}")
            y = self.gelu(y)
            y = self.conv(y, f"{prefix}.convs_1x1.{i}")
            y = self.layer_norm(y, f"{prefix}.norms_2.{i}")
            y = self.gelu(y)
            x = b.add(x, y)
        return b.mul(x, x_mask)

    def wn(self, x, x_mask, prefix, kernel_size, dilation_rate, n_layers,
           hidden, g=None):
        """Gated WaveNet stack [B, C, T] (modules.py:132-209)."""
        b = self.b
        output = None
        g_all = None
        if g is not None and self.has(f"{prefix}.cond_layer.weight"):
            g_all = self.conv(g, f"{prefix}.cond_layer")
        for i in range(n_layers):
            dilation = dilation_rate ** i
            padding = (kernel_size * dilation - dilation) // 2
            x_in = self.conv(x, f"{prefix}.in_layers.{i}",
                             padding=padding, dilation=dilation)
            if g_all is not None:
                g_l = self.b.slice_(
                    g_all, [i * 2 * hidden], [(i + 1) * 2 * hidden], [1]
                )
                x_in = b.add(x_in, g_l)
            t_act = b.tanh(b.slice_(x_in, [0], [hidden], [1]))
            s_act = b.sigmoid(b.slice_(x_in, [hidden], [2 * hidden], [1]))
            acts = b.mul(t_act, s_act)
            res_skip = self.conv(acts, f"{prefix}.res_skip_layers.{i}")
            if i < n_layers - 1:
                res = b.slice_(res_skip, [0], [hidden], [1])
                skip = b.slice_(res_skip, [hidden], [2 * hidden], [1])
                x = b.mul(b.add(x, res), x_mask)
            else:
                skip = res_skip
            output = skip if output is None else b.add(output, skip)
        return b.mul(output, x_mask)

    # -- text encoder ----------------------------------------------------

    def rel_embeddings(self, emb_name, t_len, window_size):
        """Slice/pad the relative table to 2*T-1 entries (dynamic T)."""
        b = self.b
        zero = b.i64([0])
        pad_len = b.n("Max", [b.sub(t_len, b.i64([window_size + 1])), zero])
        start = b.n("Max", [b.sub(b.i64([window_size + 1]), t_len), zero])
        pads = b.concat([zero, pad_len, zero, zero, pad_len, zero], axis=0)
        padded = b.pad(self.w(emb_name), pads)
        end = b.add(start, b.sub(b.mul(t_len, b.i64([2])), b.i64([1])))
        return b.dyn_slice(padded, start, end, [1])

    def rel_to_abs(self, x, t_len, heads):
        """[B,h,T,2T-1] -> [B,h,T,T] via the pad/reshape shuffle."""
        b = self.b
        zeros3 = b.i64([0] * 7)
        one = b.i64([1])
        # pad last dim by 1
        pads = b.concat([zeros3, one], axis=0)
        x = b.pad(x, pads)
        x = b.reshape(x, b.concat(
            [b.i64([0]), b.i64([heads]), b.i64([-1])], axis=0))
        # pad flattened by T-1
        t_minus1 = b.sub(t_len, one)
        pads2 = b.concat([b.i64([0] * 5), t_minus1], axis=0)
        x = b.pad(x, pads2)
        shape = b.concat(
            [b.i64([0]), b.i64([heads]), b.add(t_len, one),
             b.sub(b.mul(t_len, b.i64([2])), one)],
            axis=0,
        )
        x = b.reshape(x, shape)
        # [:, :, :T, T-1:]
        starts = b.concat([b.i64([0]), t_minus1], axis=0)
        ends = b.concat([t_len, b.i64([2 ** 31 - 1])], axis=0)
        return b.n("Slice", [x, starts, ends, b.i64([2, 3])])

    def abs_to_rel(self, x, t_len, heads):
        """[B,h,T,T] -> [B,h,T,2T-1]."""
        b = self.b
        one = b.i64([1])
        t_minus1 = b.sub(t_len, one)
        pads = b.concat([b.i64([0] * 7), t_minus1], axis=0)
        x = b.pad(x, pads)
        x = b.reshape(x, b.concat(
            [b.i64([0]), b.i64([heads]), b.i64([-1])], axis=0))
        pads2 = b.concat([b.i64([0, 0]), t_len, b.i64([0, 0, 0])], axis=0)
        x = b.pad(x, pads2)
        shape = b.concat(
            [b.i64([0]), b.i64([heads]), t_len, b.mul(t_len, b.i64([2]))],
            axis=0,
        )
        x = b.reshape(x, shape)
        return b.slice_(x, [1], [2 ** 31 - 1], [3])

    def attention(self, x, attn_mask, t_len, prefix):
        b = self.b
        hp = self.hp
        heads = hp.n_heads
        d_k = hp.hidden_channels // heads
        # derive from the checkpoint, not the VITS default: emb_rel_k is
        # [1, 2*window+1, d_k] (a fork trained with a different window
        # would otherwise export silently-wrong attention)
        window = (self.p[f"{prefix}.emb_rel_k"].shape[1] - 1) // 2

        q = self.conv(x, f"{prefix}.conv_q")
        k = self.conv(x, f"{prefix}.conv_k")
        v = self.conv(x, f"{prefix}.conv_v")

        def heads_split(t):  # [B, C, T] -> [B, h, T, d_k]
            t = b.reshape(t, [0, heads, d_k, -1])
            return b.transpose(t, (0, 1, 3, 2))

        q = heads_split(q)
        k = heads_split(k)
        v = heads_split(v)
        q_scaled = b.mul(q, b.f32(1.0 / math.sqrt(d_k)))

        scores = b.matmul(q_scaled, b.transpose(k, (0, 1, 3, 2)))

        rel_k = self.rel_embeddings(
            f"{prefix}.emb_rel_k", t_len, window)  # [1, 2T-1, d_k]
        rel_logits = b.matmul(q_scaled, b.transpose(rel_k, (0, 2, 1)))
        scores = b.add(scores, self.rel_to_abs(rel_logits, t_len, heads))

        scores = b.where(
            b.equal(attn_mask, b.f32(0.0)), b.f32(-1e4), scores
        )
        p_attn = b.softmax(scores, axis=-1)
        output = b.matmul(p_attn, v)

        rel_weights = self.abs_to_rel(p_attn, t_len, heads)
        rel_v = self.rel_embeddings(f"{prefix}.emb_rel_v", t_len, window)
        output = b.add(output, b.matmul(rel_weights, rel_v))

        # [B, h, T, d_k] -> [B, C, T]
        output = b.transpose(output, (0, 1, 3, 2))
        output = b.reshape(output, [0, heads * d_k, -1])
        return self.conv(output, f"{prefix}.conv_o")

    def ffn(self, x, x_mask, prefix, kernel_size):
        b = self.b
        pad_l = (kernel_size - 1) // 2
        pad_r = kernel_size // 2
        h = b.pad(b.mul(x, x_mask), [0, 0, pad_l, 0, 0, pad_r])
        h = self.conv(h, f"{prefix}.conv_1")
        h = b.relu(h)
        h = b.pad(b.mul(h, x_mask), [0, 0, pad_l, 0, 0, pad_r])
        h = self.conv(h, f"{prefix}.conv_2")
        return b.mul(h, x_mask)

    def text_encoder(self, input_ids, x_mask, t_len):
        b = self.b
        hp = self.hp
        x = b.n("Gather", [self.w("enc_p.emb.weight"), input_ids], axis=0)
        x = b.mul(x, b.f32(math.sqrt(hp.hidden_channels)))  # [B, T, H]
        x = b.transpose(x, (0, 2, 1))  # [B, H, T]

        # x_mask [B,1,T]: unsq -> [B,1,1,T] * [B,1,T,1] = [B,1,T,T]
        attn_mask = b.mul(
            b.unsqueeze(x_mask, [2]),  # [B,1,1,T]
            b.unsqueeze(x_mask, [3]),  # [B,1,T,1]
        )

        x = b.mul(x, x_mask)
        base = "enc_p.encoder"
        for i in range(hp.n_layers):
            y = self.attention(x, attn_mask, t_len,
                               f"{base}.attn_layers.{i}")
            x = self.layer_norm(b.add(x, y), f"{base}.norm_layers_1.{i}")
            y = self.ffn(x, x_mask, f"{base}.ffn_layers.{i}", hp.kernel_size)
            x = self.layer_norm(b.add(x, y), f"{base}.norm_layers_2.{i}")
        x = b.mul(x, x_mask)

        stats = b.mul(self.conv(x, "enc_p.proj"), x_mask)
        m_p = b.slice_(stats, [0], [hp.inter_channels], [1])
        logs_p = b.slice_(stats, [hp.inter_channels],
                          [2 * hp.inter_channels], [1])
        return x, m_p, logs_p

    # -- stochastic duration predictor (reverse) -------------------------

    def spline_inverse(self, x1, h, num_bins, tail_bound, filter_channels):
        """Inverse RQ spline; x1 [B,1,T], h [B,1,T,3K-1] raw projections."""
        b = self.b
        scale = b.f32(1.0 / math.sqrt(filter_channels))
        uw = b.mul(b.slice_(h, [0], [num_bins], [3]), scale)
        uh = b.mul(b.slice_(h, [num_bins], [2 * num_bins], [3]), scale)
        ud = b.slice_(h, [2 * num_bins], [3 * num_bins - 1], [3])

        constant = math.log(math.exp(1 - 1e-3) - 1)
        ud = b.pad(ud, [0, 0, 0, 1, 0, 0, 0, 1], value=constant)

        def bins(unnorm, low, high):
            sizes = b.softmax(unnorm, axis=-1)
            sizes = b.add(b.mul(sizes, b.f32(1.0 - 1e-3 * num_bins)),
                          b.f32(1e-3))
            cum = b.cumsum(sizes, axis=-1)
            cum = b.pad(cum, [0, 0, 0, 1, 0, 0, 0, 0])
            cum = b.add(b.mul(cum, b.f32(high - low)), b.f32(low))
            # pin endpoints exactly
            first = b.add(b.mul(b.slice_(cum, [0], [1], [3]), b.f32(0.0)),
                          b.f32(low))
            last = b.add(b.mul(b.slice_(cum, [num_bins], [num_bins + 1], [3]),
                               b.f32(0.0)), b.f32(high))
            middle = b.slice_(cum, [1], [num_bins], [3])
            cum = b.concat([first, middle, last], axis=3)
            widths = b.sub(b.slice_(cum, [1], [num_bins + 1], [3]),
                           b.slice_(cum, [0], [num_bins], [3]))
            return cum, widths

        cumw, widths = bins(uw, -tail_bound, tail_bound)
        cumh, heights = bins(uh, -tail_bound, tail_bound)
        derivs = b.add(b.softplus(ud), b.f32(1e-3))

        inside = b.n("And", [
            b.greater_or_equal(x1, b.f32(-tail_bound)),
            b.n("LessOrEqual", [x1, b.f32(tail_bound)]),
        ])
        clamped = b.n("Clip", [x1, b.f32(-tail_bound), b.f32(tail_bound)])
        inputs4 = b.unsqueeze(clamped, [3])  # [B,1,T,1]

        # searchsorted over cumheights (inverse mode) with eps on last edge
        eps_edge = b.add(b.slice_(cumh, [num_bins], [num_bins + 1], [3]),
                         b.f32(1e-6))
        locations = b.concat(
            [b.slice_(cumh, [0], [num_bins], [3]), eps_edge], axis=3
        )
        ge = b.cast(b.greater_or_equal(inputs4, locations), F32)
        idx = b.sub(b.reduce_sum(ge, [-1], keepdims=1), b.f32(1.0))
        idx = b.n("Clip", [idx, b.f32(0.0), b.f32(num_bins - 1)])
        idx = b.cast(idx, I64)  # [B,1,T,1]

        def pick(table):
            return b.squeeze(b.gather_elements(table, idx, axis=3), [3])

        in_cumw = pick(cumw)
        in_w = pick(widths)
        in_cumh = pick(cumh)
        in_h = pick(heights)
        in_delta = pick(b.div(heights, widths))
        in_d = pick(b.slice_(derivs, [0], [num_bins], [3]))
        in_d1 = pick(b.slice_(derivs, [1], [num_bins + 1], [3]))

        term = b.sub(clamped, in_cumh)
        dsum = b.sub(b.add(in_d, in_d1), b.mul(in_delta, b.f32(2.0)))
        a = b.add(b.mul(term, dsum),
                  b.mul(in_h, b.sub(in_delta, in_d)))
        bb = b.sub(b.mul(in_h, in_d), b.mul(term, dsum))
        c = b.neg(b.mul(in_delta, term))
        disc = b.n("Max", [
            b.sub(b.mul(bb, bb), b.mul(b.f32(4.0), b.mul(a, c))),
            b.f32(0.0),
        ])
        root = b.div(b.mul(c, b.f32(2.0)),
                     b.neg(b.add(bb, b.sqrt(disc))))
        outputs = b.add(b.mul(root, in_w), in_cumw)
        return b.where(inside, outputs, x1)

    def conv_flow_reverse(self, x, x_mask, g, prefix):
        b = self.b
        filter_channels = self.hp.hidden_channels  # SDP overrides to in_ch
        # proj emits half*(3*num_bins - 1) channels (half = 1 for the
        # SDP's [x0|x1] split): recover num_bins from the checkpoint
        # instead of assuming the default 10. tail_bound is a true
        # hyperparameter (not recoverable from weights); the reference
        # hard-codes 5.0 (modules.py:477).
        proj_out = self.p[f"{prefix}.proj.weight"].shape[0]
        num_bins, tail_bound = (proj_out + 1) // 3, 5.0
        x0 = b.slice_(x, [0], [1], [1])
        x1 = b.slice_(x, [1], [2], [1])
        h = self.conv(x0, f"{prefix}.pre")
        h = self.dds_conv(h, x_mask, f"{prefix}.convs", kernel_size=3,
                          n_layers=3, g=g)
        h = b.mul(self.conv(h, f"{prefix}.proj"), x_mask)
        # [B, 3K-1, T] -> [B, 1, T, 3K-1]
        h = b.unsqueeze(b.transpose(h, (0, 2, 1)), [1])
        x1 = self.spline_inverse(x1, h, num_bins, tail_bound,
                                 filter_channels)
        return b.mul(b.concat([x0, x1], axis=1), x_mask)

    def sdp_reverse(self, x, x_mask, g, noise_w):
        """Sample log-durations (duration.py:sdp_reverse semantics)."""
        b = self.b
        h = self.conv(x, "dp.pre")
        if g is not None and self.has("dp.cond.weight"):
            h = b.add(h, self.conv(g, "dp.cond"))
        h = self.dds_conv(h, x_mask, "dp.convs", kernel_size=3, n_layers=3)
        h = b.mul(self.conv(h, "dp.proj"), x_mask)

        # z ~ N(0, noise_w^2) with shape [B, 2, T]
        template = b.concat([x_mask, x_mask], axis=1)
        z = b.mul(b.random_like(template), noise_w)

        def flip(t):
            return b.slice_(t, [2 ** 31 - 1], [-(2 ** 31 - 1)], [1],
                            steps=[-1])

        for t_idx in (7, 5, 3):  # CF4, CF3, CF2 (CF1 skipped)
            z = flip(z)
            z = self.conv_flow_reverse(z, x_mask, h, f"dp.flows.{t_idx}")
        z = flip(z)
        # ElementwiseAffine reverse
        m = self.w("dp.flows.0.m")
        logs = self.w("dp.flows.0.logs")
        z = b.mul(b.mul(b.sub(z, m), b.exp(b.neg(logs))), x_mask)
        return b.slice_(z, [0], [1], [1])  # logw [B,1,T]

    # -- flows + vocoder -------------------------------------------------

    def coupling_reverse(self, x, y_mask, g):
        b = self.b
        hp = self.hp
        half = hp.inter_channels // 2
        for i in reversed(range(4)):
            x = b.slice_(x, [2 ** 31 - 1], [-(2 ** 31 - 1)], [1],
                         steps=[-1])  # channel flip
            prefix = f"flow.flows.{2 * i}"
            x0 = b.slice_(x, [0], [half], [1])
            x1 = b.slice_(x, [half], [2 * half], [1])
            h = b.mul(self.conv(x0, f"{prefix}.pre"), y_mask)
            h = self.wn(h, y_mask, f"{prefix}.enc", kernel_size=5,
                        dilation_rate=1, n_layers=4,
                        hidden=hp.hidden_channels, g=g)
            m = b.mul(self.conv(h, f"{prefix}.post"), y_mask)
            x1 = b.mul(b.sub(x1, m), y_mask)
            x = b.concat([x0, x1], axis=1)
        return x

    def generator(self, x, g):
        b = self.b
        hp = self.hp
        x = self.conv(x, "dec.conv_pre", padding=3)
        if g is not None and self.has("dec.cond.weight"):
            x = b.add(x, self.conv(g, "dec.cond"))
        num_kernels = len(hp.resblock_kernel_sizes)
        for i, (rate, kernel) in enumerate(
            zip(hp.upsample_rates, hp.upsample_kernel_sizes)
        ):
            x = b.leaky_relu(x, 0.1)
            bias = (self.w(f"dec.ups.{i}.bias")
                    if self.has(f"dec.ups.{i}.bias") else None)
            x = b.conv_transpose1d(
                x, self.w(f"dec.ups.{i}.weight"), bias,
                stride=rate, padding=(kernel - rate) // 2,
            )
            acc = None
            for j in range(num_kernels):
                block = f"dec.resblocks.{i * num_kernels + j}"
                out = self.resblock(x, block,
                                    hp.resblock_kernel_sizes[j],
                                    hp.resblock_dilation_sizes[j])
                acc = out if acc is None else b.add(acc, out)
            x = b.div(acc, b.f32(float(num_kernels)))
        x = b.leaky_relu(x, 0.01)
        if hp.decoder_type != "hifigan":
            return self.istft_heads(x)
        x = self.conv(x, "dec.conv_post", padding=3)
        return b.tanh(x)

    # -- iSTFT decoder family (istft_decoder.py:72-132) -------------------

    def istft_heads(self, x):
        """Spectral heads + per-band iSTFT (+ PQMF synthesis bank)."""
        b = self.b
        hp = self.hp
        n_fft, hop = hp.istft_n_fft, hp.istft_hop
        n_bands = hp.istft_bands
        n_freqs = n_fft // 2 + 1

        mag = b.exp(b.n("Clip", [self.conv(x, "dec.conv_mag", padding=3),
                                 b.f32(-12.0), b.f32(6.0)]))
        phase = b.mul(
            b.f32(math.pi),
            b.n("Sin", [self.conv(x, "dec.conv_phase", padding=3)]),
        )
        # one trailing silent frame so output is exactly T*hop samples
        mag = b.pad(mag, [0, 0, 0, 0, 0, 1])
        phase = b.pad(phase, [0, 0, 0, 0, 0, 1])

        if n_bands == 1:
            return self.istft(mag, phase, n_fft, hop)

        subbands = []
        for k in range(n_bands):
            mag_k = b.slice_(mag, [k * n_freqs], [(k + 1) * n_freqs], [1])
            phase_k = b.slice_(phase, [k * n_freqs], [(k + 1) * n_freqs],
                               [1])
            subbands.append(self.istft(mag_k, phase_k, n_fft, hop))
        sub = b.concat(subbands, axis=1)  # [B, bands, T*hop]

        # PQMF synthesis: expand-by-N + band filters + sum as ONE
        # transposed conv (ops/pqmf.py:81-106). lax correlation with
        # padding (lo, hi) == ConvTranspose with the time-flipped kernel
        # and pads (K-1-lo, K-1-hi).
        from phoonnx_tpu_torch.ops.pqmf import pqmf_filters

        _, synthesis = pqmf_filters(n_bands)
        length = synthesis.shape[1]
        w = synthesis[:, ::-1][:, None, :]  # [I=bands, O=1, K] flipped
        w_name = b.const(np.ascontiguousarray(w, np.float32), hint="pqmf")
        pad_lo = length // 2
        pad_hi = length + n_bands - 2 - pad_lo
        audio = b.n(
            "ConvTranspose", [sub, w_name], strides=[n_bands],
            pads=[length - 1 - pad_lo, length - 1 - pad_hi],
        )
        return b.mul(audio, b.f32(float(n_bands)))

    def istft(self, mag, phase, n_fft: int, hop: int):
        """(mag, phase) [B, F, T] -> waveform [B, 1, (T-1)*hop].

        Inverse rFFT as two fixed-matrix MatMuls, overlap-add as a
        ConvTranspose with a diagonal window kernel, exact window-envelope
        normalisation — the ONNX mirror of ops/istft.py:29-72.
        """
        b = self.b
        n_freqs = n_fft // 2 + 1
        # irfft bases: frames[t,n] = sum_f w_f/N (re cos - im sin)
        f = np.arange(n_freqs)[:, None]
        n = np.arange(n_fft)[None, :]
        weight = np.where((f == 0) | (f == n_fft // 2), 1.0, 2.0) / n_fft
        ang = 2.0 * np.pi * f * n / n_fft
        cos_mat = (weight * np.cos(ang)).astype(np.float32)
        sin_mat = (-weight * np.sin(ang)).astype(np.float32)

        mag_t = b.transpose(mag, (0, 2, 1))  # [B, T, F]
        phase_t = b.transpose(phase, (0, 2, 1))
        real = b.mul(mag_t, b.n("Cos", [phase_t]))
        imag = b.mul(mag_t, b.n("Sin", [phase_t]))
        frames = b.add(
            b.matmul(real, b.const(cos_mat, hint="idft_cos")),
            b.matmul(imag, b.const(sin_mat, hint="idft_sin")),
        )  # [B, T, n_fft]
        frames = b.transpose(frames, (0, 2, 1))  # [B, n_fft, T]

        window = np.asarray(_hann(n_fft), np.float32)
        ola = np.zeros((n_fft, 1, n_fft), np.float32)
        ola[np.arange(n_fft), 0, np.arange(n_fft)] = window
        audio = b.n(
            "ConvTranspose", [frames, b.const(ola, hint="ola")],
            strides=[hop], pads=[0, 0],
        )  # [B, 1, (T-1)*hop + n_fft]

        ones = b.add(
            b.mul(b.slice_(frames, [0], [1], [1]), b.f32(0.0)), b.f32(1.0)
        )  # [B, 1, T]
        env = b.n(
            "ConvTranspose",
            [ones, b.const((window ** 2)[None, None, :], hint="olaenv")],
            strides=[hop], pads=[0, 0],
        )
        audio = b.div(audio, b.n("Max", [env, b.f32(1e-9)]))

        # center crop: [pad : pad + (T-1)*hop], T dynamic
        pad = n_fft // 2
        t_frames = b.dim(frames, 2)  # [1] i64
        end = b.add(
            b.mul(b.sub(t_frames, b.i64([1])), b.i64([hop])), b.i64([pad])
        )
        return b.dyn_slice(audio, b.i64([pad]), end, [2])

    def resblock(self, x, prefix, kernel, dilations):
        b = self.b
        if self.hp.resblock == "1":
            for k, d in enumerate(dilations):
                xt = b.leaky_relu(x, 0.1)
                xt = self.conv(xt, f"{prefix}.convs1.{k}",
                               padding=(kernel * d - d) // 2, dilation=d)
                xt = b.leaky_relu(xt, 0.1)
                xt = self.conv(xt, f"{prefix}.convs2.{k}",
                               padding=(kernel - 1) // 2)
                x = b.add(xt, x)
        else:
            for k, d in enumerate(dilations):
                xt = b.leaky_relu(x, 0.1)
                xt = self.conv(xt, f"{prefix}.convs.{k}",
                               padding=(kernel * d - d) // 2, dilation=d)
                x = b.add(xt, x)
        return x

    # -- full graph ------------------------------------------------------

    def build(self, deterministic: bool = False):
        """Emit the full infer graph; returns (nodes, initializers, ...).

        deterministic=True replaces the in-graph RandomNormalLike noise
        with zeros (for cross-runtime verification).
        """
        b = self.b
        hp = self.hp
        if deterministic:
            # builders are single-use; no restore needed after build()

            def zero_like(x, scale=1.0):
                return b.mul(x, b.f32(0.0))

            b.random_like = zero_like

        input_ids = "input"
        lengths = "input_lengths"
        scales = "scales"

        noise_scale = b.slice_(scales, [0], [1], [0])
        length_scale = b.slice_(scales, [1], [2], [0])
        noise_w = b.slice_(scales, [2], [3], [0])

        t_len = b.dim(input_ids, 1)  # [1] int64
        # x_mask [B,1,T]
        arange_t = b.range_(
            b.squeeze(b.i64([0]), [0]), b.squeeze(t_len, [0]),
            b.squeeze(b.i64([1]), [0]),
        )
        x_mask = b.cast(
            b.less(b.unsqueeze(arange_t, [0]), b.unsqueeze(lengths, [1])),
            F32,
        )
        x_mask = b.unsqueeze(x_mask, [1])

        x, m_p, logs_p = self.text_encoder(input_ids, x_mask, t_len)

        g = None
        if self.multispeaker:
            g = b.n("Gather", [self.w("emb_g.weight"), "sid"], axis=0)
            g = b.unsqueeze(g, [2])  # [B, G, 1]

        logw = self.sdp_reverse(x, x_mask, g, noise_w)
        w = b.mul(b.mul(b.exp(logw), x_mask), length_scale)
        w_ceil = b.n("Ceil", [w])  # [B,1,T]
        y_lengths_f = b.n("Max", [
            b.reduce_sum(w_ceil, [1, 2], keepdims=0), b.f32(1.0),
        ])  # [B]
        y_lengths = b.cast(y_lengths_f, I64)
        t_y = b.reduce_max(y_lengths, keepdims=1)  # [1]

        arange_y = b.range_(
            b.squeeze(b.i64([0]), [0]), b.squeeze(t_y, [0]),
            b.squeeze(b.i64([1]), [0]),
        )  # [T_y]
        y_mask = b.cast(
            b.less(b.unsqueeze(arange_y, [0]), b.unsqueeze(y_lengths, [1])),
            F32,
        )
        y_mask = b.unsqueeze(y_mask, [1])  # [B,1,T_y]

        # generate_path: path[b,y,x] = (y < cum[x]) - (y < cum[x]-w[x])
        cum = b.cumsum(w_ceil, axis=2)  # [B,1,T]
        y_idx = b.cast(
            b.unsqueeze(arange_y, [0, 1, 3]), F32
        )  # [1,1,T_y,1]
        reached = b.cast(
            b.less(y_idx, b.unsqueeze(cum, [2])), F32
        )  # [B,1,T_y,T]
        started = b.cast(
            b.less(y_idx, b.unsqueeze(b.sub(cum, w_ceil), [2])), F32
        )
        attn_mask4 = b.mul(b.unsqueeze(x_mask, [2]),
                           b.unsqueeze(y_mask, [3]))
        attn = b.mul(b.sub(reached, started), attn_mask4)  # [B,1,T_y,T]
        attn3 = b.squeeze(attn, [1])  # [B,T_y,T]

        m_p_e = b.transpose(
            b.matmul(attn3, b.transpose(m_p, (0, 2, 1))), (0, 2, 1)
        )  # [B,C,T_y]
        logs_p_e = b.transpose(
            b.matmul(attn3, b.transpose(logs_p, (0, 2, 1))), (0, 2, 1)
        )

        noise = b.random_like(m_p_e)
        z_p = b.add(
            m_p_e,
            b.mul(b.mul(noise, b.exp(logs_p_e)), noise_scale),
        )
        z = self.coupling_reverse(z_p, y_mask, g)
        audio = self.generator(b.mul(z, y_mask), g)  # [B,1,T_audio]
        b.n("Identity", [audio], hint="out")
        # rename last node output to the contract name
        op, ins, outs, attrs = b.nodes[-1]
        b.nodes[-1] = (op, ins, ["output"], attrs)

        inputs = [("input", np.int64, ("N", "T")),
                  ("input_lengths", np.int64, ("N",)),
                  ("scales", np.float32, (3,))]
        if self.multispeaker:
            inputs.append(("sid", np.int64, ("N",)))
        outputs = [("output", np.float32, ("N", 1, "T_audio"))]
        return b.nodes, b.initializers, inputs, outputs


def _quantize_graph_weights(nodes, initializers, flat):
    """Rewrite large model weights as int8 QDQ triples.

    Weight-only quantization in the QDQ style onnxruntime's tooling
    emits: each eligible weight initializer ``X`` becomes
    ``X_quantized/X_scale/X_zero_point`` plus a ``DequantizeLinear``
    node that reproduces tensor ``X`` for its unchanged consumers, so
    the graph stays a plain opset-15 program (runs under onnxruntime
    and the in-repo executor), shrinks ~4x on disk, and re-imports to
    the compiled JAX engine via onnx/dequant.dequantize_flat. Graph
    constants (e.g. the iSTFT Fourier bases) are NOT quantized — only
    tensors that are model weights (present in ``flat``).
    """
    from phoonnx_tpu_torch.onnx.dequant import quantize_flat

    weights = {k: v for k, v in initializers.items() if k in flat}
    qweights, n_quantized = quantize_flat(weights)
    if not n_quantized:
        return nodes, initializers, 0
    new_inits = {k: v for k, v in initializers.items() if k not in weights}
    dq_nodes = []
    for name in weights:
        if name + "_quantized" in qweights:
            dq_nodes.append((
                "DequantizeLinear",
                [name + "_quantized", name + "_scale",
                 name + "_zero_point"],
                [name], {},
            ))
        else:
            new_inits[name] = weights[name]
    for key, value in qweights.items():
        if key not in weights:
            new_inits[key] = value
    # executors run nodes in list order: dequantize before first use
    return dq_nodes + list(nodes), new_inits, n_quantized


def export_vits_onnx(flat: Dict[str, np.ndarray], hp, path: str,
                     metadata: Optional[Dict[str, str]] = None,
                     deterministic: bool = False,
                     quantize: bool = False) -> None:
    """Write an executable VITS inference graph to ``path``."""
    from phoonnx_tpu_torch.onnx.writer import write_onnx

    graph = VitsGraph(flat, hp)
    nodes, initializers, inputs, outputs = graph.build(
        deterministic=deterministic
    )
    if quantize:
        # graph.p is the weight-norm-folded flat dict: exactly the model
        # weights, under the names the graph consumes them by
        nodes, initializers, n_quantized = _quantize_graph_weights(
            nodes, initializers, graph.p
        )
        if metadata is not None and n_quantized:
            metadata = dict(metadata, quantization="int8-weights-qdq")
    write_onnx(path, initializers, metadata=metadata, inputs=inputs,
               outputs=outputs, nodes=nodes, opset=15)
