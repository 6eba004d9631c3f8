"""FLOPs and bytes counted from shapes, and one H100's peaks: the yardstick
of every `mfu` and `_roofline` metric.

Frozen copy of deepdenoiser_tpu_torch/tools/roofline.py at commit 903e8b8
(`Row`, `count_network`, `count_kpn_apply`, `count_group_encode`,
`count_frame`, `totals`, the peaks), made to stand alone: the model is the
"model" group of a configuration file (a plain dict), and the frame's
grid is planned here from the halo that the configuration's reference
module certifies. Nothing here imports the program, so a change to the
program cannot move the yardstick.

The architecture comes from the caller: `arch`, the configuration's
reference module (reference/<bench.reference>.py), gives the plane's
multiple (`arch.multiple(model)`) and counts the backbone under the head
(`arch.count_backbone(net, n, h, w, c_in, c_out, prefix)`, driving
`_Net`'s conv_block, concat, upsample and head, or its unet and
tiramisu). Where a caller has a bare model dict and no configuration,
registry.architecture finds the module by the model's own fields. A
backbone that no module counts raises ValueError. What wraps the backbone
stays here: the multi-scale pyramid and compose, the KPN head, the
encode, pad, stitch and decode.

A conv's FLOPs are 2*N*Ho*Wo*Co*Ci*k*k; elementwise rows count one FLOP
per element and operation; every input byte is read once and every output
byte written once. Network rows are at the compute dtype; the KPN head,
the encode, decode and the joins around the network are fp32.
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, Sequence

from h100_bench import registry

# NVIDIA's data sheet, H100 SXM, dense, at a 700 W power limit
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_HBM_BPS = 3.35e12
_BYTES = {"bfloat16": 2, "float32": 4}
F32 = "float32"
_ACT_FLOPS = {"relu": 1, "leaky_relu": 2, "elu": 3, "gelu": 8, "silu": 4, "none": 0}

LIGHT_GROUPS = ("diffuse", "glossy", "subsurface", "transmission")
AUX_CHANNELS = {"normal": 3, "depth": 1, "alpha": 1}
AUX_PASSES = ("normal", "depth", "alpha")
COMPOSITE_EXTRA = ("emission", "environment")


@dataclasses.dataclass(frozen=True)
class Row:
    """One layer of the frame: FLOPs and the bytes it must move."""

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
    def __init__(self, stage: str):
        self.stage, self.rows = stage, []

    def add(self, name, kind, dtype, flops, read, written):
        self.rows.append(Row(name, self.stage, kind, dtype, int(flops), int(read), int(written)))

    def elementwise(self, name, kind, dtype, elems, flops_per_elem=1, inputs=1,
                    in_dtype=None, extra_read=0):
        b_in = _BYTES[in_dtype or dtype]
        self.add(name, kind, dtype, flops_per_elem * elems, inputs * elems * b_in + extra_read,
                 elems * _BYTES[dtype])

    def copy(self, name, kind, dtype, elems_in, elems_out=None):
        b = _BYTES[dtype]
        self.add(name, kind, dtype, 0, elems_in * b, (elems_in if elems_out is None
                                                      else elems_out) * b)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return _ceil_div(x, m) * m


def unet_widths(model: Mapping) -> List[int]:
    """Channel width of each UNet level (width growth 2, capped at 512)."""
    return [min(int(model["base_width"] * 2.0 ** level), 512) for level in range(model["depth"] + 1)]


class _Net:
    """Counts the network over an (n, h, w, c_in) fp32 input, layer by
    layer, in the port's order; `arch` counts the backbone."""

    def __init__(self, model: Mapping, rows: _Rows, arch):
        self.m, self.r, self.arch = model, rows, arch
        self.dt = model["compute_dtype"]
        self.act = _ACT_FLOPS[model["act"]]

    def conv_block(self, name, n, h, w, ci, co, k, stride=1, act=True):
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
            r.elementwise(f"{name} {self.m['act']}", "act", dt, out, self.act)
        return ho, wo

    def concat(self, name, n, h, w, chans):
        if len(chans) > 1:
            self.r.copy(f"{name} concat", "concat", self.dt, n * h * w * sum(chans))

    def upsample(self, name, n, h, w, c):
        self.r.copy(f"{name} nearest x2", "upsample", self.dt, n * h * w * c, n * 4 * h * w * c)

    def head(self, name, n, h, w, ci, co, stem):
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

    def unet(self, n, h, w, cin, cout, prefix=""):
        m = self.m
        s, k, depth, cpl = m["stem_stride"], 3, m["depth"], m["convs_per_level"]
        h, w, c = self.stem_in(n, h, w, cin, s)
        widths = unet_widths(m)

        def stack(i, h, w, parts, width):
            self.concat(f"{prefix}ConvStack_{i}", n, h, w, parts)
            for j in range(cpl):
                self.conv_block(f"{prefix}ConvStack_{i}.ConvBlock_{j}", n, h, w,
                                sum(parts) if j == 0 else width, width, k)

        stack(0, h, w, [c], widths[0])
        dims = [(h, w)]
        for level in range(1, depth + 1):
            h, w = self.conv_block(f"{prefix}DownSample_{level - 1}", n, h, w, widths[level - 1],
                                   widths[level], k, stride=2)
            stack(level, h, w, [widths[level]], widths[level])
            dims.append((h, w))
        prev = widths[depth]
        for i, level in enumerate(range(depth - 1, -1, -1)):
            self.upsample(f"{prefix}UpSample_{i}", n, h, w, prev)
            h, w = dims[level]
            self.conv_block(f"{prefix}UpSample_{i}", n, h, w, prev, widths[level], k)
            stack(depth + 1 + i, h, w, [widths[level]] * 2, widths[level])
            prev = widths[level]
        self.head(f"{prefix}Conv_0", n, h, w, prev, cout, s)

    def tiramisu(self, n, h, w, cin, cout, prefix=""):
        m = self.m
        s, k, g, nl = m["stem_stride"], 3, m["growth_rate"], m["layers_per_block"]
        top, depth, stem_width = m["layers_top"] or nl, m["depth"], 48
        h, w, c = self.stem_in(n, h, w, cin, s)

        def dense(name, h, w, c, n_layers):
            for i in range(n_layers):
                self.concat(f"{name}.ConvBlock_{i}", n, h, w, [c] + [g] * i)
                self.conv_block(f"{name}.ConvBlock_{i}", n, h, w, c + i * g, g, k)
            self.concat(name, n, h, w, [g] * n_layers)
            self.concat(f"{name} join", n, h, w, [c, g * n_layers])
            return c + g * n_layers

        self.conv_block(f"{prefix}ConvBlock_0", n, h, w, c, stem_width, k)
        c = dense(f"{prefix}DenseBlock_0", h, w, stem_width, top)
        skips = []
        for level in range(1, depth + 1):
            skips.append((c, h, w))
            self.conv_block(f"{prefix}ConvBlock_{level}", n, h, w, c, c // 2, 1)
            self.r.add(f"{prefix}avg_pool2d {level}", "pool", self.dt, n * h * w * (c // 2),
                       n * h * w * (c // 2) * _BYTES[self.dt],
                       n * (h // 2) * (w // 2) * (c // 2) * _BYTES[self.dt])
            h, w, c = h // 2, w // 2, c // 2
            c = dense(f"{prefix}DenseBlock_{level}", h, w, c, nl)
        n_blocks = 1 + depth
        for level, (skip, sh, sw) in enumerate(reversed(skips)):
            up = max(g * nl, skip // 2)
            self.upsample(f"{prefix}UpSample_{level}", n, h, w, c)
            h, w = sh, sw
            self.conv_block(f"{prefix}UpSample_{level}", n, h, w, c, up, k)
            c = up + skip
            self.concat(f"{prefix}join {level}", n, h, w, [up, skip])
            if m["up_compress"] > 0 and c > m["up_compress"]:
                self.conv_block(f"{prefix}compress {level}", n, h, w, c, m["up_compress"], 1)
                c = m["up_compress"]
            c = dense(f"{prefix}DenseBlock_{n_blocks + level}", h, w, c,
                      top if level == depth - 1 else nl)
        self.head(f"{prefix}Conv_0", n, h, w, c, cout, s)

    def backbone(self, n, h, w, cout, prefix=""):
        count = getattr(self.arch, "count_backbone", None)
        if not callable(count):
            raise ValueError(f"{self.arch.__name__} does not count backbone "
                             f"{self.m['backbone']!r}: it has no count_backbone")
        count(self, n, h, w, self.m["in_channels"], cout, prefix)

    def model(self, n, h, w):
        m, r = self.m, self.r
        kpn = m["kernel_prediction"]
        out_ch = m["kpn_slots"] * m["kpn_size"] ** 2 if kpn else m["out_channels"]
        if m["n_scales"] > 1:
            c_in = m["in_channels"]
            for s in range(1, m["n_scales"]):
                hs, ws = h >> (s - 1), w >> (s - 1)
                r.add(f"pyramid pool {s}", "pool", F32, n * hs * ws * c_in,
                      n * hs * ws * c_in * 4, n * (hs // 2) * (ws // 2) * c_in * 4)
            for s in range(m["n_scales"]):
                self.backbone(n, h >> s, w >> s, out_ch, prefix=f"scale {s} ")
            for s in range(m["n_scales"] - 2, -1, -1):
                e = n * (h >> s) * (w >> s) * out_ch
                r.add(f"compose scale {s}", "elementwise", F32, e + e // 4 + e,
                      (e + e // 4) * 4, e * 4)
        else:
            self.backbone(n, h, w, out_ch)
        px = n * h * w
        n_sig = m["out_channels"] if (m["predict_residual"] or m["out_channels"] == 24) else 0
        if kpn:
            k2 = m["kpn_size"] ** 2
            if m["out_channels"] == 24:
                r.copy("signal gather", "concat", F32, px * n_sig)
            for s in range(m["kpn_slots"]):
                if m["kpn_logit_norm"]:
                    r.add(f"KPN slot {s} rms-norm", "rmsnorm", F32, 4 * px * k2 + 3 * px,
                          px * k2 * 4, px * k2 * 4)
                r.elementwise(f"KPN slot {s} softmax", "softmax", F32, px * k2, 5)
                r.add(f"KPN slot {s} kpn_apply", "kpn_apply", F32, 2 * k2 * 3 * px,
                      px * (3 + k2) * 4, px * 3 * 4)
            if m["kpn_slots"] > 1:
                r.copy("KPN slot concat", "concat", F32, px * 3 * m["kpn_slots"])
        elif m["predict_residual"]:
            r.copy("signal gather", "concat", F32, px * n_sig)
            r.elementwise("residual add", "elementwise", F32, px * m["out_channels"], 1, inputs=2)


def count_network(model: Mapping, n: int, h: int, w: int, arch=None) -> List[Row]:
    """Rows of the model's forward over an (n, h, w, in_channels) fp32 input."""
    rows = _Rows("model")
    _Net(model, rows, arch or registry.architecture(model)).model(n, h, w)
    return rows.rows


def count_kpn_apply(n: int, h: int, w: int, kernel_size: int = 5, channels: int = 3) -> Row:
    """One filter apply (K1) on (n, h, w, channels) with (n, h, w, k²) fp32
    weights: the signal and the weights read once, the output written once."""
    k2 = kernel_size ** 2
    px = n * h * w
    return Row("kpn_apply", "model", "kpn_apply", F32, 2 * k2 * channels * px,
               px * (channels + k2) * 4, px * channels * 4)


def count_kpn_apply_bwd_weights(n: int, h: int, w: int, kernel_size: int = 5,
                                channels: int = 3) -> Row:
    """The weight gradient of one filter apply: the signal and the output's
    gradient read once, d_w (n, h, w, k²) written once; a multiply and an
    add a channel and tap."""
    k2 = kernel_size ** 2
    px = n * h * w
    return Row("kpn_apply_bwd_weights", "model", "kpn_apply", F32, 2 * k2 * channels * px,
               px * 2 * channels * 4, px * k2 * 4)


def count_group_encode(groups: int, h: int, w: int, aux: Sequence[str] = AUX_PASSES) -> Row:
    """The whole-pixel group encode: every group's direct, indirect and color
    passes and the shared aux passes read once, the (groups, h, w, 9 + aux)
    fp32 batch written once."""
    px, ca = h * w, sum(AUX_CHANNELS[a] for a in aux)
    flops = px * (7 * 3 * groups + 2 * ca)
    return Row("group encode", "encode", "encode", F32, flops, px * (groups * 9 + ca) * 4,
               px * groups * (9 + ca) * 4)


@dataclasses.dataclass(frozen=True)
class Grid:
    """The frame's plan, as inference/tiled.plan_grid makes it."""

    height: int
    width: int
    tile_h: int
    tile_w: int
    halo: int
    rows: int
    cols: int

    @property
    def n_tiles(self) -> int:
        return self.rows * self.cols

    @property
    def net_h(self) -> int:
        return self.tile_h + 2 * self.halo

    @property
    def net_w(self) -> int:
        return self.tile_w + 2 * self.halo

    @property
    def padded_hw(self):
        return self.rows * self.tile_h, self.cols * self.tile_w


def plan(model: Mapping, infer: Mapping, height: int, width: int, certified_halo: int,
         arch=None) -> Grid:
    """The grid of a frame: whole-frame mode pads by min(halo, border);
    tiled mode keeps the certified halo; both rounded to the multiple that
    the architecture's plane divides."""
    m = (arch or registry.architecture(model)).multiple(model)
    halo = infer["halo"] if infer["halo"] > 0 else certified_halo
    if infer["tile"] == 0 and not infer["spatial_shard"] and infer["border"] >= 0:
        halo = min(halo, infer["border"])
    halo = _round_up(halo, m)
    if infer["tile"] == 0:
        return Grid(height, width, _round_up(height, m), _round_up(width, m), halo, 1, 1)
    tile = _round_up(max(infer["tile"], m), m)
    return Grid(height, width, tile, tile, halo, _ceil_div(height, tile), _ceil_div(width, tile))


def mode(model: Mapping) -> str:
    return {24: "joint", 6: "group", 3: "rgb"}[model["out_channels"]]


def count_frame(model: Mapping, infer: Mapping, height: int, width: int, certified_halo: int,
                groups: Sequence[str] = LIGHT_GROUPS, aux: Sequence[str] = AUX_PASSES,
                arch=None) -> List[Row]:
    """Rows of one frame through the frame denoiser: the encode, the reflect
    pad, the network over the plane or its tiles, the crop or stitch, the
    decode and the recomposition."""
    md = mode(model)
    arch = arch or registry.architecture(model)
    grid = plan(model, infer, height, width, certified_halo, arch)
    model = {**model, "compute_dtype": infer["compute_dtype"]}
    px = height * width
    enc, pad, dec = _Rows("encode"), _Rows("pad"), _Rows("decode")
    g = len(groups) if md == "group" else 1
    ca = sum(AUX_CHANNELS[a] for a in aux)
    c_in = model["in_channels"]
    if md == "joint":
        n_rad = 6 * len(groups)
        enc.add("joint encode", "encode", F32, px * (5 * n_rad + 2 * ca),
                px * (9 * len(groups) + ca) * 4, px * c_in * 4)
    elif md == "group":
        enc.rows.append(count_group_encode(len(groups), height, width, aux))
    else:
        enc.add("rgb encode", "encode", F32, px * (3 * 2 + 2 * (c_in - 6)),
                px * c_in * 4, px * c_in * 4)
    out_ch = {"joint": 6 * len(groups), "group": 6, "rgb": 3}[md]
    ph, pw = grid.padded_hw
    plane = g * (ph + 2 * grid.halo) * (pw + 2 * grid.halo)
    pad.copy("reflect pad", "pad", F32, g * px * c_in, plane * c_in)
    n_tiles = g * grid.n_tiles
    tb = infer["tile_batch"]
    calls = 1
    if grid.n_tiles > 1:
        if tb and tb < n_tiles:
            calls = _ceil_div(n_tiles, tb)
            n_tiles = calls * tb
        pad.copy("tile gather", "copy", F32, n_tiles * grid.net_h * grid.net_w * c_in)
    net = count_network(model, n_tiles, grid.net_h, grid.net_w, arch)
    if calls > 1:
        net = [dataclasses.replace(r, calls=r.calls * calls) for r in net]
    crop = _Rows("crop")
    crop.copy("crop" if grid.n_tiles == 1 else "stitch", "crop", F32, g * px * out_ch)
    if md == "rgb":
        dec.elementwise("rgb decode", "decode", F32, px * 3, 2)
    else:
        dec.add("decode", "decode", F32, px * 6 * len(groups) * 5,
                px * (6 + 3) * len(groups) * 4, px * 6 * len(groups) * 4)
        n_extra = len(COMPOSITE_EXTRA)
        dec.add("recompose", "recompose", F32, px * 3 * (3 * len(groups) + n_extra),
                px * (9 * len(groups) + 3 * n_extra) * 4, px * 3 * 4)
    return enc.rows + pad.rows + net + crop.rows + dec.rows


def totals(rows: List[Row]) -> dict:
    """FLOPs, bytes and the compute and memory bounds of `rows`, seconds."""
    flops = sum(r.flops for r in rows)
    nbytes = sum(r.bytes for r in rows)
    return {
        "flops": flops, "bytes": nbytes,
        "sol_compute_s": sum(r.flops / PEAK_FLOPS[r.dtype] for r in rows),
        "sol_hbm_s": nbytes / PEAK_HBM_BPS,
    }


def bound_s(rows: List[Row]) -> float:
    """The least time the chip could take for `rows`: the larger of the
    compute bound (each row at its dtype's peak) and the HBM bound."""
    t = totals(rows)
    return max(t["sol_compute_s"], t["sol_hbm_s"])
