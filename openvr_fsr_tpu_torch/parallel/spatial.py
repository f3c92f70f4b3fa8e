"""Spatial (row-strip) sharding: single-frame latency scaling.

The port of the JAX package's parallel/spatial.py. sharding.ShardedPipeline
scales throughput by putting whole frames on different devices; this module
splits the output row bands of one stereo batch's fused FSR (or CAS
upscale) kernel across devices. The tables and foveation classes are the
full image's and each band build keeps the tiles of its rows
(kernels/fsr.py::build_fsr_fused(band_range=...), kernels/cas.py::
build_cas_upscale(band_range=...)), so every strip runs the same kernels
and the concatenated strips are bit-identical to the single launch.

No collectives: a band's tiles read a few input rows beyond it, so each
device takes an overlapping input strip when the frame is placed (halo by
overlap); only the placing and the gather cross devices.
"""

import numpy as np
import torch

from ..core import constants as C
from ..core.projection import default_centers
from ..kernels._maps import input_padding
from ..kernels.cas import build_cas_upscale, cas_band_layout
from ..kernels.fsr import build_fsr_fused, fsr_band_layout

__all__ = ["SpatialFsrPipeline", "split_bands"]


def split_bands(gy, n):
    """Contiguous band ranges covering [0, gy) as evenly as possible."""
    n = max(1, min(int(n), gy))
    bounds = np.linspace(0, gy, n + 1).round().astype(int)
    return [(int(bounds[i]), int(bounds[i + 1])) for i in range(n)]


class SpatialFsrPipeline:
    """Latency-sharded fused FSR (EASU + RCAS) or CAS upscale over explicit
    devices.

    config: core.config.Config with render_scale != 1: the fused EASU +
    RCAS path (rs < 1 upscale or rs > 1 supersample) or the CAS scaling
    path (use_cas, rs < 1); other modes scale by batch splitting
    (sharding.ShardedPipeline). devices: a list of torch devices, one strip
    each (default: every CUDA device; [torch.device("cpu")] * n runs the
    plain versions). Frames are (B, H, W) uint32/int32 packed RGBA8 or
    (B, H, W, 4) uint8, one eye per frame, with `eyes` as in
    Pipeline.process.
    """

    def __init__(self, config, eye_centers=None, devices=None,
                 band_rows=128):
        assert config.enabled and not config.use_nis
        assert config.render_scale != 1.0 and (
            not config.use_cas or config.render_scale < 1.0), \
            "spatial sharding targets the scaling kernels (fused " \
            "EASU+RCAS rs != 1, or CAS upscale rs < 1)"
        self.config = config
        self.eye_centers = eye_centers or default_centers()
        if devices is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if n == 0:
                raise RuntimeError("torch finds no CUDA GPU: pass devices, "
                                   "e.g. [torch.device('cpu')] * n")
            devices = [torch.device("cuda", i) for i in range(n)]
        self.devices = [torch.device(d) for d in devices]
        self.band_rows = int(band_rows)
        self._cache = {}

    def _centres_array(self, out_w, out_h, eyes):
        return C.centres_payload(out_w, out_h, self.config.radius,
                                 self.eye_centers, eyes)

    def _build(self, b, h, w, eyes):
        """([(strip kernel, in_row_base, in_rows, out_rows, device)] in band
        order, the ring pitch (HP, WP), (OH, OW))."""
        cfg = self.config
        ow, oh = cfg.output_size(w, h)
        layout = cas_band_layout if cfg.use_cas else fsr_band_layout
        builder = build_cas_upscale if cfg.use_cas else build_fsr_fused
        _, gy = layout(ow, oh, self.band_rows)
        ranges = split_bands(gy, len(self.devices))
        centres = self._centres_array(ow, oh, eyes)
        shards = []
        for (g0, g1), dev in zip(ranges, self.devices):
            fn = builder(
                b, h, w, ow, oh, sharpness=cfg.sharpness, centres=centres,
                color_bits=8, debug=cfg.debug_mode,
                band_rows=self.band_rows, band_range=(g0, g1))
            shards.append((fn, fn.in_row_base, fn.in_rows, fn.out_rows, dev))
        return shards, input_padding(h, w), (oh, ow)

    @property
    def kernels(self):
        """The strip kernels built so far, in band order per shape (each
        counts its CUDA launches in `.launches`)."""
        return [s[0] for shards, _, _ in self._cache.values() for s in shards]

    def place(self, frames, eyes=None):
        """The scatter half of the steady state: pad the frame once on the
        host to the ring pitch (kernels/_maps.py::input_padding) and put
        each shard's overlapping input strip on its device, in the strip
        kernel's pre-padded width, which it reads in place. Returns a
        placed-frames handle for process_placed. This is the only step that
        touches the host; a streaming caller places frame t + 1 while
        process_placed runs frame t."""
        if isinstance(frames, torch.Tensor):
            frames = (frames.view(torch.int32) if frames.dtype in (
                torch.uint32, torch.int32) else frames).cpu().numpy()
        frames = np.asarray(frames)
        if frames.dtype == np.uint8:         # NHWC -> packed plane
            frames = np.ascontiguousarray(frames).view(np.uint32)[..., 0]
        if frames.dtype not in (np.uint32, np.int32) or frames.ndim != 3:
            raise TypeError(f"frames {frames.dtype} {frames.shape}: (B, H, "
                            "W) packed RGBA8 or (B, H, W, 4) uint8")
        frames = frames.view(np.int32)
        b, h, w = frames.shape
        if eyes is None:
            eyes = tuple(i % 2 for i in range(b))
        eyes = tuple(int(e) for e in eyes)
        assert len(eyes) == b, (len(eyes), b)
        key = (b, h, w, eyes)
        if key not in self._cache:
            self._cache[key] = self._build(b, h, w, eyes)
        shards, (hp, wp), _ = self._cache[key]
        pad = np.pad(frames, ((0, 0), (0, hp - h), (0, wp - w)))
        strips = [torch.from_numpy(np.ascontiguousarray(
            pad[:, base:base + rows])).to(dev)
            for _, base, rows, _, dev in shards]
        return key, strips

    def process_placed(self, placed):
        """The compute half of the steady state: every shard's strip kernel
        on its own device; returns the per-device output strips in band
        order, (B, out_rows, OW) int32 packed RGBA8, still on their devices.
        No host staging and no synchronisation once the kernels are built
        and their tables are on their devices (the first call moves them)."""
        key, strips = placed
        shards = self._cache[key][0]
        return [shard[0](strip) for shard, strip in zip(shards, strips)]

    def gather(self, key, outs):
        """The explicit gather: the output strips pulled to the host and
        concatenated to the (B, OH, OW) uint32 packed frame (numpy)."""
        shards = self._cache[key][0]
        return np.concatenate(
            [o[:, :shard[3]].cpu().numpy() for o, shard in zip(outs, shards)],
            axis=1).view(np.uint32)

    def process(self, frames, eyes=None):
        """One shot: place, process_placed, gather. Returns (B, OH, OW)
        uint32 packed RGBA8 (numpy, the serving format); eyes default to
        alternating (0, 1, 0, ...) like Pipeline.process."""
        placed = self.place(frames, eyes)
        return self.gather(placed[0], self.process_placed(placed))
