"""Roofline of one frame: FLOPs and bytes counted from the shapes, against
one H100's peaks, beside the frame's measured latency.

    python -m deepdenoiser_tpu_torch.tools.roofline [--model flagship] \\
        [--height 1080 --width 1920] [--tile 0 --tile-batch 0] [--border -1] \\
        [--chain 8] [--measured-ms MS] [--device cpu]

The port of tools/roofline.py. The JAX tool reads XLA's cost analysis of
the compiled frame program and divides by a TPU v5e's peaks. PyTorch runs
eagerly and has no compiled program to ask, so here `count_frame` walks
the layers the port's frame runs, from the same specs the models are built
from (models/factory._backbone_spec: UNetSpec, TiramisuSpec, the
multi-scale pyramid, the KPN head, the tile grid of inference/tiled.py),
and gives one Row per layer: its FLOPs and the bytes it must move, each
input byte read once and each output byte written once. No tensor is
allocated and no profiler runs. A conv's FLOPs are 2*N*Ho*Wo*Co*Ci*k*k.
The decoder's resize-conv is counted as the model defines it, the x2
resize and the kxk conv at full resolution (XLA's count of the JAX
sub-pixel conv, zero taps included); the port runs a 3x3 one as a 2x2
sub-pixel conv on the coarse grid (models/layers.py), with 4/9 of those
FLOPs and without the resized tensor's bytes. Elementwise rows count one
FLOP per element and operation (a
transcendental counts one). Network rows are at the compute dtype; the
KPN head (RMS-norm, softmax, the filter apply K1), the encode, decode and
the joins around the network are fp32, as the port runs them.

Peaks (NVIDIA's data sheet, H100 SXM, dense, at a 700 W power limit):
989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32 outside them, and
3.35 TB/s of HBM3. `mfu` divides the frame's FLOPs per second by the bf16
peak, as the JAX tool's key does; sol_compute_ms gives each row its own
dtype's peak. Latency is the median over 5 samples of the per-frame ms of
--chain frames of bench.py's Fourier frame, timed by CUDA events
(tools/_timing.py), with the model's release weights where the repo has
them (tools/eval_zoo.load_model_params), else seeded random ones. With
--device cpu no frame is timed: every key that needs a device time is
null and only the counts are printed. Like the JAX tool it drives the
joint pipeline and refuses models that are not 24 channels out.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List, Optional

from deepdenoiser_tpu_torch import passes
from deepdenoiser_tpu_torch.config import InferenceConfig
from deepdenoiser_tpu_torch.models import factory
from deepdenoiser_tpu_torch.models.factory import ModelConfig
from deepdenoiser_tpu_torch.models.tiramisu import TiramisuSpec
from deepdenoiser_tpu_torch.models.unet import UNetSpec

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM, dense
PEAK_HBM_BPS = 3.35e12
_BYTES = {"bfloat16": 2, "float32": 4}
F32 = "float32"
# FLOPs per element of an activation (leaky-ReLU: a multiply and a max)
_ACT_FLOPS = {"relu": 1, "leaky_relu": 2, "elu": 3, "gelu": 8, "silu": 4, "none": 0}


@dataclasses.dataclass(frozen=True)
class Row:
    """One layer of the frame: FLOPs and the bytes it must move.

    stage: encode | pad | model | crop | decode (traffic_breakdown's stages
    are encode, pad+model+crop, decode). kind: conv, bias, act, pool,
    upsample, concat, copy, cast, elementwise, rmsnorm, softmax, kpn_apply,
    pad, crop, encode, decode, recompose. calls: the launches or calls the
    row stands for (its numbers are their sum)."""

    name: str
    stage: str
    kind: str
    dtype: str
    flops: int
    bytes_read: int
    bytes_written: int
    calls: int = 1

    @property
    def bytes(self) -> int:
        return self.bytes_read + self.bytes_written


class _Rows:
    """Row builder for one stage; sizes are element counts."""

    def __init__(self, stage: str):
        self.stage, self.rows = stage, []

    def add(self, name, kind, dtype, flops, read, written):
        self.rows.append(Row(name, self.stage, kind, dtype, int(flops), int(read), int(written)))

    def elementwise(self, name, kind, dtype, elems, flops_per_elem=1, inputs=1,
                    in_dtype=None, extra_read=0):
        """`inputs` tensors of `elems` elements in, one out."""
        b_in = _BYTES[in_dtype or dtype]
        self.add(name, kind, dtype, flops_per_elem * elems, inputs * elems * b_in + extra_read,
                 elems * _BYTES[dtype])

    def copy(self, name, kind, dtype, elems_in, elems_out=None):
        b = _BYTES[dtype]
        self.add(name, kind, dtype, 0, elems_in * b, (elems_in if elems_out is None
                                                      else elems_out) * b)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class _Net:
    """Counts the network (DenoiserModel.forward) over an (n, h, w, c_in)
    fp32 input, layer by layer, in the port's order."""

    def __init__(self, cfg: ModelConfig, rows: _Rows):
        self.cfg, self.r = cfg, rows
        self.dt = cfg.compute_dtype
        self.act = _ACT_FLOPS[cfg.act]

    # -- the blocks of models/layers.py -----------------------------------
    def conv_block(self, name, n, h, w, ci, co, k, stride=1, act=True):
        """ConvBlock: (SAME pad for stride 2) conv + bias + activation.
        Returns the output's (h, w)."""
        r, dt, b = self.r, self.dt, _BYTES[self.dt]
        if stride != 1:
            ph = max((_ceil_div(h, stride) - 1) * stride + k - h, 0)
            pw = max((_ceil_div(w, stride) - 1) * stride + k - w, 0)
            r.copy(f"{name} pad", "pad", dt, n * h * w * ci, n * (h + ph) * (w + pw) * ci)
        ho, wo = _ceil_div(h, stride), _ceil_div(w, stride)
        out = n * ho * wo * co
        r.add(f"{name} conv{k}x{k}" + (f"/{stride}" if stride != 1 else ""), "conv", dt,
              2 * out * ci * k * k, (n * h * w * ci + co * ci * k * k) * b, out * b)
        r.elementwise(f"{name} bias", "bias", dt, out, extra_read=co * b)
        if act and self.act:
            r.elementwise(f"{name} {self.cfg.act}", "act", dt, out, self.act)
        return ho, wo

    def concat(self, name, n, h, w, chans):
        """torch.cat of the parts along channels (one part: no row)."""
        if len(chans) > 1:
            self.r.copy(f"{name} concat", "concat", self.dt, n * h * w * sum(chans))

    def upsample(self, name, n, h, w, c):
        self.r.copy(f"{name} nearest x2", "upsample", self.dt, n * h * w * c, n * 4 * h * w * c)

    def head(self, name, n, h, w, ci, co, stem):
        """The linear 1x1 head, depth_to_space after an s2d stem, the cast
        to fp32."""
        r, dt = self.r, self.dt
        self.conv_block(name, n, h, w, ci, co * stem * stem, 1, act=False)
        if stem == 2:
            r.copy("depth_to_space", "copy", dt, n * h * w * co * 4)
        if dt != F32:
            r.elementwise("cast out", "cast", F32, n * (h * stem) * (w * stem) * co, 0,
                          in_dtype=dt)

    def stem_in(self, n, h, w, c, stem):
        r, dt = self.r, self.dt
        if dt != F32:
            r.elementwise("cast in", "cast", dt, n * h * w * c, 0, in_dtype=F32)
        if stem == 2:
            r.copy("space_to_depth", "copy", dt, n * h * w * c)
            return h // 2, w // 2, 4 * c
        return h, w, c

    # -- backbones --------------------------------------------------------
    def unet(self, spec: UNetSpec, n, h, w, cin, cout, prefix=""):
        s = spec.stem_stride
        h, w, c = self.stem_in(n, h, w, cin, s)
        k = spec.kernel
        widths = [spec.width(level) for level in range(spec.depth + 1)]

        def stack(i, h, w, parts, width):
            """ConvStack_i; its first conv reads the concat of `parts`."""
            self.concat(f"{prefix}ConvStack_{i}", n, h, w, parts)
            for j in range(spec.convs_per_level):
                self.conv_block(f"{prefix}ConvStack_{i}.ConvBlock_{j}", n, h, w,
                                sum(parts) if j == 0 else width, width, k)

        stack(0, h, w, [c], widths[0])
        dims = [(h, w)]
        for level in range(1, spec.depth + 1):
            h, w = self.conv_block(f"{prefix}DownSample_{level - 1}", n, h, w, widths[level - 1],
                                   widths[level], k, stride=2)
            stack(level, h, w, [widths[level]], widths[level])
            dims.append((h, w))
        prev = widths[spec.depth]
        for i, level in enumerate(range(spec.depth - 1, -1, -1)):
            self.upsample(f"{prefix}UpSample_{i}", n, h, w, prev)
            h, w = dims[level]
            self.conv_block(f"{prefix}UpSample_{i}", n, h, w, prev, widths[level], k)
            stack(spec.depth + 1 + i, h, w, [widths[level]] * 2, widths[level])
            prev = widths[level]
        self.head(f"{prefix}Conv_0", n, h, w, prev, cout, s)

    def tiramisu(self, spec: TiramisuSpec, n, h, w, cin, cout, prefix=""):
        s = spec.stem_stride
        h, w, c = self.stem_in(n, h, w, cin, s)
        k, g, nl = spec.kernel, spec.growth_rate, spec.layers_per_block

        def dense(name, h, w, c, n_layers):
            """DenseBlock + the concat of its input with its features."""
            for i in range(n_layers):
                self.concat(f"{name}.ConvBlock_{i}", n, h, w, [c] + [g] * i)
                self.conv_block(f"{name}.ConvBlock_{i}", n, h, w, c + i * g, g, k)
            self.concat(name, n, h, w, [g] * n_layers)  # the block's output
            self.concat(f"{name} join", n, h, w, [c, g * n_layers])
            return c + g * n_layers

        self.conv_block(f"{prefix}ConvBlock_0", n, h, w, c, spec.stem_width, k)
        c = dense(f"{prefix}DenseBlock_0", h, w, spec.stem_width, spec._layers_top)
        skips = []
        for level in range(1, spec.depth + 1):
            skips.append((c, h, w))
            self.conv_block(f"{prefix}ConvBlock_{level}", n, h, w, c, c // 2, 1)
            self.r.add(f"{prefix}avg_pool2d {level}", "pool", self.dt, n * h * w * (c // 2),
                       n * h * w * (c // 2) * _BYTES[self.dt],
                       n * (h // 2) * (w // 2) * (c // 2) * _BYTES[self.dt])
            h, w, c = h // 2, w // 2, c // 2
            c = dense(f"{prefix}DenseBlock_{level}", h, w, c, nl)
        n_blocks = 1 + spec.depth
        for level, (skip, sh, sw) in enumerate(reversed(skips)):
            up = max(g * nl, skip // 2)
            self.upsample(f"{prefix}UpSample_{level}", n, h, w, c)
            h, w = sh, sw
            self.conv_block(f"{prefix}UpSample_{level}", n, h, w, c, up, k)
            c = up + skip
            self.concat(f"{prefix}join {level}", n, h, w, [up, skip])
            if spec.up_compress > 0 and c > spec.up_compress:
                self.conv_block(f"{prefix}compress {level}", n, h, w, c, spec.up_compress, 1)
                c = spec.up_compress
            c = dense(f"{prefix}DenseBlock_{n_blocks + level}", h, w, c,
                      spec._layers_top if level == spec.depth - 1 else nl)
        self.head(f"{prefix}Conv_0", n, h, w, c, cout, s)

    def backbone(self, n, h, w, cout, prefix=""):
        cfg = self.cfg
        spec = factory._backbone_spec(cfg)
        if cfg.backbone == "unet":
            self.unet(spec, n, h, w, cfg.in_channels, cout, prefix)
        else:
            self.tiramisu(spec, n, h, w, cfg.in_channels, cout, prefix)

    # -- DenoiserModel.forward --------------------------------------------
    def model(self, n, h, w):
        cfg, r = self.cfg, self.r
        out_ch = cfg.kpn_slots * cfg.kpn_size ** 2 if cfg.kernel_prediction else cfg.out_channels
        if cfg.n_scales > 1:
            c_in = cfg.in_channels
            for s in range(1, cfg.n_scales):  # the input pyramid (fp32)
                hs, ws = h >> (s - 1), w >> (s - 1)
                r.add(f"pyramid pool {s}", "pool", F32, n * hs * ws * c_in,
                      n * hs * ws * c_in * 4, n * (hs // 2) * (ws // 2) * c_in * 4)
            for s in range(cfg.n_scales):
                self.backbone(n, h >> s, w >> s, out_ch, prefix=f"scale {s} ")
            for s in range(cfg.n_scales - 2, -1, -1):  # fine + up(coarse - down(fine))
                e = n * (h >> s) * (w >> s) * out_ch
                r.add(f"compose scale {s}", "elementwise", F32, e + e // 4 + e,
                      (e + e // 4) * 4, e * 4)
        else:
            self.backbone(n, h, w, out_ch)
        px = n * h * w
        n_sig = len(factory.signal_indices(cfg)) if (
            cfg.predict_residual or cfg.out_channels == 24) else 0
        if cfg.kernel_prediction:
            k2 = cfg.kpn_size ** 2
            if cfg.out_channels == 24:  # joint: the signal gathered from 4 runs of 6 channels
                r.copy("signal gather", "concat", F32, px * n_sig)
            for s in range(cfg.kpn_slots):
                if cfg.kpn_logit_norm:
                    # square, sum, divide, scale a tap; mean, +eps, sqrt a pixel
                    r.add(f"KPN slot {s} rms-norm", "rmsnorm", F32, 4 * px * k2 + 3 * px,
                          px * k2 * 4, px * k2 * 4)
                # max, subtract, exp, sum, divide a tap
                r.elementwise(f"KPN slot {s} softmax", "softmax", F32, px * k2, 5)
                r.add(f"KPN slot {s} kpn_apply", "kpn_apply", F32, 2 * k2 * 3 * px,
                      px * (3 + k2) * 4, px * 3 * 4)
            if cfg.kpn_slots > 1:
                r.copy("KPN slot concat", "concat", F32, px * 3 * cfg.kpn_slots)
        elif cfg.predict_residual:
            r.copy("signal gather", "concat", F32, px * n_sig)
            r.elementwise("residual add", "elementwise", F32, px * cfg.out_channels, 1, inputs=2)


def count_network(cfg: ModelConfig, n: int, h: int, w: int) -> List[Row]:
    """Rows of DenoiserModel.forward over an (n, h, w, in_channels) fp32
    input, in the model's compute dtype."""
    rows = _Rows("model")
    _Net(cfg, rows).model(n, h, w)
    return rows.rows


def count_kpn_apply(n: int, h: int, w: int, kernel_size: int = 5, channels: int = 3) -> Row:
    """One launch of K1 on (n, h, w, channels) with (n, h, w, k²) fp32
    weights: the signal and the weights read once, the output written once."""
    k2 = kernel_size ** 2
    px = n * h * w
    return Row("kpn_apply", "model", "kpn_apply", F32, 2 * k2 * channels * px,
               px * (channels + k2) * 4, px * channels * 4)


def _aux_channels(aux) -> int:
    return sum(passes.channels(a) for a in aux)


def count_group_encode(groups: int, h: int, w: int, aux=passes.AUX_PASSES) -> Row:
    """The whole-pixel group encode (K2-K6): every group's direct, indirect
    and color passes and the shared aux passes read once, the
    (groups, h, w, 9 + aux) fp32 batch written once."""
    px, ca = h * w, _aux_channels(aux)
    # 7 operations a radiance channel pair (albedo + eps, two divides, two
    # maxes, two log1p), 2 an aux element (normalised once for all groups)
    flops = px * (7 * 3 * groups + 2 * ca)
    return Row("group encode", "encode", "encode", F32, flops, px * (groups * 9 + ca) * 4,
               px * groups * (9 + ca) * 4)


def _mode(cfg: ModelConfig) -> str:
    return {24: "joint", 6: "group", 3: "rgb"}[cfg.out_channels]


def count_frame(cfg: ModelConfig, icfg: InferenceConfig, height: int, width: int,
                groups=passes.LIGHT_GROUPS, aux=passes.AUX_PASSES) -> List[Row]:
    """Rows of one frame through the port's frame denoiser (joint, group or
    rgb by the model's output width) with `icfg`'s grid: the encode, the
    reflect pad, the network over the plane or its tiles, the crop or
    stitch, the decode and the recomposition."""
    from deepdenoiser_tpu_torch.inference import pipeline  # the grid plan

    if icfg.spatial_shard:
        raise ValueError("count_frame counts one device's frame; spatial_shard is not counted")
    mode = _mode(cfg)
    grid = pipeline.plan_for(cfg, icfg, height, width)
    cfg = dataclasses.replace(cfg, compute_dtype=icfg.compute_dtype)  # as the frame builds it
    px = height * width
    enc, pad, dec = _Rows("encode"), _Rows("pad"), _Rows("decode")
    g = len(groups) if mode == "group" else 1
    ca = _aux_channels(aux)
    c_in = cfg.in_channels
    if mode == "joint":
        # log1p(exposure * direct / (albedo + eps)) per radiance channel,
        # the aux normalisations; the stack written once
        n_rad = 6 * len(groups)
        enc.add("joint encode", "encode", F32, px * (5 * n_rad + 2 * ca),
                px * (9 * len(groups) + ca) * 4, px * c_in * 4)
    elif mode == "group":
        enc.rows.append(count_group_encode(len(groups), height, width, aux))
    else:
        enc.add("rgb encode", "encode", F32, px * (3 * 2 + 2 * (c_in - 6)),
                px * c_in * 4, px * c_in * 4)
    out_ch = {"joint": 6 * len(groups), "group": 6, "rgb": 3}[mode]

    # the padded plane, and the tiles the network runs on
    ph, pw = grid.padded_hw
    plane = g * (ph + 2 * grid.halo) * (pw + 2 * grid.halo)
    pad.copy("reflect pad", "pad", F32, g * px * c_in, plane * c_in)
    n_tiles = g * grid.n_tiles
    tb = icfg.tile_batch
    calls = 1
    if grid.n_tiles > 1:
        if tb and tb < n_tiles:
            calls = _ceil_div(n_tiles, tb)
            n_tiles = calls * tb  # the last chunk is wrapped or zero-padded to tile_batch
        pad.copy("tile gather", "copy", F32, n_tiles * grid.net_h * grid.net_w * c_in)
    net = count_network(cfg, n_tiles, grid.net_h, grid.net_w)
    if calls > 1:
        net = [dataclasses.replace(r, calls=r.calls * calls) for r in net]
    crop = _Rows("crop")
    crop.copy("crop" if grid.n_tiles == 1 else "stitch", "crop", F32, g * px * out_ch)

    if mode == "rgb":
        dec.elementwise("rgb decode", "decode", F32, px * 3, 2)
    else:
        # expm1(max(y, 0)) / exposure * (albedo + eps) per output channel;
        # the albedo read once a group
        dec.add("decode", "decode", F32, px * 6 * len(groups) * 5,
                px * (6 + 3) * len(groups) * 4, px * 6 * len(groups) * 4)
        n_extra = len(passes.COMPOSITE_EXTRA)
        dec.add("recompose", "recompose", F32, px * 3 * (3 * len(groups) + n_extra),
                px * (9 * len(groups) + 3 * n_extra) * 4, px * 3 * 4)
    return enc.rows + pad.rows + net + crop.rows + dec.rows


def totals(rows: List[Row]) -> dict:
    """FLOPs, bytes and the two compute and memory bounds of `rows`."""
    flops = sum(r.flops for r in rows)
    nbytes = sum(r.bytes for r in rows)
    return {
        "flops": flops, "bytes": nbytes,
        "sol_compute_s": sum(r.flops / PEAK_FLOPS[r.dtype] for r in rows),
        "sol_hbm_s": nbytes / PEAK_HBM_BPS,
    }


def report(model: str, height: int, width: int, rows: List[Row],
           latency_s: Optional[float], card: dict) -> dict:
    """The JAX tool's keys, and the card's name and power limit. Every key
    that needs a device time is None when `latency_s` is None."""
    t = totals(rows)
    flops, nbytes, sec = t["flops"], t["bytes"], latency_s
    peak = PEAK_FLOPS["bfloat16"]
    ai = flops / max(nbytes, 1)
    ridge = peak / PEAK_HBM_BPS
    sol_c, sol_h = 1e3 * t["sol_compute_s"], 1e3 * t["sol_hbm_s"]
    timed = {"latency_ms": None, "achieved_tflops": None, "mfu": None,
             "achieved_hbm_gbps": None, "hbm_utilization": None}
    if sec is not None:
        timed = {"latency_ms": round(1e3 * sec, 2),
                 "achieved_tflops": round(flops / sec / 1e12, 2),
                 "mfu": round(flops / sec / peak, 4),
                 "achieved_hbm_gbps": round(nbytes / sec / 1e9, 1),
                 "hbm_utilization": round(nbytes / sec / PEAK_HBM_BPS, 4)}
    return {
        "model": model,
        "resolution": f"{width}x{height}",
        "latency_ms": timed["latency_ms"],
        "gflops_per_frame": round(flops / 1e9, 1),
        "hbm_gb_per_frame": round(nbytes / 1e9, 3),
        "arithmetic_intensity": round(ai, 1),
        "ridge_point": round(ridge, 1),
        "achieved_tflops": timed["achieved_tflops"],
        "mfu": timed["mfu"],
        "achieved_hbm_gbps": timed["achieved_hbm_gbps"],
        "hbm_utilization": timed["hbm_utilization"],
        "bound": "compute" if ai > ridge else "bandwidth",
        "speed_of_light_ms": round(max(sol_c, sol_h), 2),
        "sol_compute_ms": round(sol_c, 2),
        "sol_hbm_ms": round(sol_h, 2),
        **card,
    }


def measure_latency_s(name: str, icfg: InferenceConfig, h: int, w: int, chain: int,
                      device) -> tuple:
    """(median seconds a frame, weights) of the joint frame denoiser on
    bench.py's Fourier frame, by CUDA events over `chain` frames."""
    import numpy as np

    from deepdenoiser_tpu_torch.data import synthetic
    from deepdenoiser_tpu_torch.inference import pipeline
    from deepdenoiser_tpu_torch.tools import _timing, eval_zoo

    from deepdenoiser_tpu_torch.tools.pretrain_flagship import MODELS

    try:
        mcfg, params, _ = eval_zoo.load_model_params(name)
        weights = "release"
    except FileNotFoundError:
        mcfg = MODELS[name]
        params, weights = eval_zoo.init_params(mcfg), "random-init"
    denoise, grid = pipeline.make_joint_frame_denoiser(mcfg, icfg, h, w, params, device=device)
    print(f"{name}: grid {grid.net_h}x{grid.net_w}, {grid.n_tiles} tiles, weights {weights}",
          file=sys.stderr, flush=True)
    frame = eval_zoo.to_device(
        synthetic.add_mc_noise(synthetic.generate_clean_passes(h, w, seed=0), spp=4, seed=1),
        device)
    samples = _timing.per_frame_ms(lambda: denoise(frame), chain, eval_zoo.LATENCY_SAMPLES,
                                   device)
    return float(np.median(samples)) / 1e3, weights


def main(argv: List[str] | None = None) -> int:
    from deepdenoiser_tpu_torch import device as device_lib
    from deepdenoiser_tpu_torch.tools import _timing
    from deepdenoiser_tpu_torch.tools.pretrain_flagship import MODELS

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--tile", type=int, default=0)
    p.add_argument("--tile-batch", type=int, default=0)
    p.add_argument("--chain", type=int, default=8, help="frames per timed sample")
    p.add_argument("--measured-ms", type=float, default=0.0,
                   help="a latency measured elsewhere on the card (bench, bench_model); "
                        "replaces the timed chain")
    p.add_argument("--model", default="flagship", choices=sorted(MODELS))
    p.add_argument("--border", type=int, default=-1)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card; 'cpu' prints the counts only)")
    args = p.parse_args(argv)
    dev = device_lib.resolve(args.device)

    mcfg = MODELS[args.model]
    if mcfg.out_channels != 24:
        raise SystemExit(f"--model {args.model}: roofline drives the joint pipeline; pick a "
                         "joint-mode (24-channel) model")
    h, w = args.height, args.width
    icfg = InferenceConfig(tile=args.tile, tile_batch=args.tile_batch, border=args.border,
                           compute_dtype="bfloat16")
    rows = count_frame(mcfg, icfg, h, w)
    sec, weights = None, None
    if dev.type == "cuda":
        if args.measured_ms > 0:
            sec = args.measured_ms / 1e3
        else:
            sec, weights = measure_latency_s(args.model, icfg, h, w, args.chain, dev)
    out = report(args.model, h, w, rows, sec, _timing.card_info(dev))
    out["weights"] = weights
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
