"""Batch splitting over CUDA devices: throughput scaling.

The port of the JAX package's parallel/sharding.py. The reference is a
single-GPU, in-process shim; batched streams (stereo pairs, video) scale by
data parallelism: the batch (eye/frame) dimension is cut into contiguous
slices, one per device, and each device runs the whole per-frame kernel on
its slice. Frames are independent, so there are no collectives and no halo
exchange; outputs stay on their devices.

A mesh is a list of torch devices (the JAX package's 1-D Mesh): make_mesh
gives the CUDA devices; a list of torch.device("cpu") runs the plain
versions, which is how the CPU tests split a batch.
"""

import numpy as np
import torch

from ..api.pipeline import _FRAMES, _PACKED

__all__ = ["make_mesh", "shard_batch", "ShardedPipeline"]


def make_mesh(n_devices=None):
    """The first n_devices CUDA devices (default: all), as a list of
    torch devices. Raises without a CUDA GPU: a CPU caller passes its own
    list, e.g. [torch.device("cpu")] * n."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("torch finds no CUDA GPU: pass a mesh, e.g. "
                           "[torch.device('cpu')] * n")
    devs = [torch.device("cuda", i) for i in range(n)]
    return devs if n_devices is None else devs[:int(n_devices)]


def shard_batch(arr, mesh):
    """arr (a numpy array or a tensor, batch first) cut into len(mesh)
    contiguous batch slices, slice i on mesh[i]. The batch must divide by
    the mesh size."""
    x = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(arr))
    n, b = len(mesh), x.shape[0]
    if n == 0 or b % n:
        raise ValueError(f"batch {b} not divisible by mesh size {n}")
    k = b // n
    return [x[i * k:(i + 1) * k].to(torch.device(dev)).contiguous()
            for i, dev in enumerate(mesh)]


class ShardedPipeline:
    """Batch-data-parallel wrapper around api.Pipeline.

    frames (B, H, W, 4) uint8 (uint16 at color_bits 10), or (B, H, W)
    uint32/int32 in the zero-copy packed mode, with B a multiple of the
    mesh size: each device processes B/n frames with the same per-frame
    kernel; process returns the per-device outputs, each still on its
    device, as a list in batch order.
    """

    def __init__(self, pipeline, mesh=None):
        self.pipeline = pipeline
        self.mesh = [torch.device(d) for d in mesh] if mesh is not None \
            else make_mesh()

    def process(self, frames, eyes=None, bounds=None, crop=False):
        """Every device runs the pipeline's kernel for the local batch on its
        slice; no collectives. The kernel is built once per configuration,
        cached in the pipeline's cache under Pipeline.process's key fields
        (so mutating the config, color_bits, hdr_mode or
        cas_max_color_delta builds again, and Pipeline.reset() drops it),
        its tables moved to each device once.

        bounds/crop mirror Pipeline.process: the first entry's
        VRTextureBounds_t decides the eye layout, and crop=True returns only
        the bounded output region of each slice."""
        pipe = self.pipeline
        first_bounds = pipe._apply_bounds_layout(bounds)
        x = frames if isinstance(frames, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(frames))
        packed = x.dtype in _PACKED
        if packed and pipe.color_bits != 8:
            raise ValueError("packed-u32 frames require color_bits=8")
        expected = _FRAMES[pipe.color_bits][0]
        if not packed and x.dtype != expected:
            raise TypeError(f"frames of dtype {x.dtype}: a color_bits="
                            f"{pipe.color_bits} pipeline takes {expected} "
                            "frames" + (" or a packed uint32/int32 RGBA8 "
                                        "plane" if pipe.color_bits == 8
                                        else ""))
        b, h, w = x.shape[0], x.shape[1], x.shape[2]
        n = len(self.mesh)
        if b % n != 0:
            raise ValueError(f"batch {b} not divisible by mesh size {n}")
        local_b = b // n
        if eyes is None:
            eyes = tuple(i % 2 for i in range(b))
        else:
            eyes = tuple(int(e) for e in eyes)
        if not pipe.single_eye_per_frame:
            # double-wide frames hold both eyes; per-entry eye indices are
            # ignored by the centres, so normalise them
            eyes = (0,) * b
        # every slice must see the same per-entry eye pattern
        pattern = eyes[:local_b]
        if eyes != pattern * n:
            raise ValueError(
                "per-shard eye pattern must repeat across shards "
                f"(local batch {local_b}); got {eyes}")
        key = ("shard", local_b, h, w, str(x.dtype), pattern, pipe.config,
               pipe.color_bits, pipe.precision, pipe.single_eye_per_frame,
               pipe.hdr_mode, pipe.cas_max_color_delta, tuple(self.mesh))
        fn = pipe._cache.get(key)
        if fn is None:
            fn = pipe._cache[key] = pipe._build(local_b, h, w, pattern,
                                                packed)
        outs = [fn(s) for s in shard_batch(x, self.mesh)]
        if crop and first_bounds is not None:
            outs = [pipe.crop_output(o, first_bounds) for o in outs]
        return outs
