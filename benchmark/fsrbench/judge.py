"""The comparison that decides `correct`.

The reference is the frozen NumPy oracle (reference/), run once the window
has closed, the peak memory has been read and the program's state freed:
each eye of a sampled pair in a process of its own (ref_worker.py), both at
once, from the inputs the benchmark made, with the eye centres and every
setting worked out again from the configuration. The program's outputs
are judged texel by texel against it: `max_lsb` is the widest gap of any
channel of any texel of the sampled outputs, both eyes, both foveation
classes. Limits come from configs/<config>.json (`check_limits`); the
stream's `tag_errors` (pairs the kernel read out of place, out of order,
twice or never) is an exact comparison with the limit 0.

The configuration's `color_bits` chooses the texel words (texels.py): the
inputs and the program's outputs are decoded by that format, the reference
is fed and read in its dtype, and every gap is in each channel's own units.
At 8 bits (RGBA8) that is an LSB of 1/255 on all four channels; at 10
(R10G10B10A2) an LSB of 1/1023 on R, G and B and of 1/3 on the 2-bit alpha.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from .texels import texel_format
from .work import eye_centers, inside_masks

__all__ = ["reference_pair", "compare", "checks", "WORKER"]

WORKER = Path(__file__).with_name("ref_worker.py")
TIMEOUT_S = 200      # a run has 360 s in all; the reference takes 10-15


def oracle_kwargs(config, eye):
    return {"render_scale": config["render_scale"],
            "sharpness": config["sharpness"],
            "use_nis": config["family"] == "nis",
            "use_cas": config["family"] == "cas",
            "cas_max_color_delta": config.get("cas_max_color_delta", 1.0),
            "radius": config["radius"],
            "eye_centers": eye_centers(config),
            "color_bits": config["color_bits"],
            "single_eye": True, "eye": eye}


def reference_pair(pair, config):
    """The reference's (2, out_h, out_w, 4) output, in the channel dtype of
    the configuration's texel format, of one packed (2, h, w) int32 input
    pair, an eye per worker process."""
    fmt = texel_format(config["color_bits"])
    _, h, w = pair.shape
    texels = fmt.from_words(np.asarray(pair))
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    procs = []
    try:
        for eye in (0, 1):
            p = subprocess.Popen([sys.executable, str(WORKER)],
                                 stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, env=env)
            procs.append(p)
            head = dict(oracle_kwargs(config, eye), h=h, w=w)
            p.stdin.write(json.dumps(head).encode() + b"\n")
            p.stdin.write(texels[eye].tobytes())
            p.stdin.close()
            p.stdin = None
        outs = []
        ow, oh = config["eye_out_wh"]
        dtype = np.dtype(fmt.dtype)
        for p in procs:
            data, err = p.communicate(timeout=TIMEOUT_S)
            if p.returncode != 0 or len(data) != oh * ow * 4 * dtype.itemsize:
                raise RuntimeError(f"reference worker exited {p.returncode}: "
                                   f"{err.decode(errors='replace')[-2000:]}")
            outs.append(np.frombuffer(data, dtype).reshape(oh, ow, 4))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return np.stack(outs)


def compare(out, ref, masks, color_bits=8):
    """out: the program's packed (2, out_h, out_w) int32 output (numpy), in
    the texel format of `color_bits`; ref: the reference's
    (2, out_h, out_w, 4) channels. Returns the widest gap, the unequal
    texels, and the widest gap inside and outside, in channel units."""
    texels = texel_format(color_bits).from_words(
        np.asarray(out)).reshape(ref.shape)
    gap = np.abs(texels.astype(np.int32) - ref.astype(np.int32)).max(axis=-1)
    inside = np.stack(masks)
    return {"max_lsb": int(gap.max()),
            "unequal_texels": int((gap > 0).sum()),
            "max_lsb_inside": int(gap[inside].max(initial=0)),
            "max_lsb_outside": int(gap[~inside].max(initial=0))}


def checks(samples, pairs_host, config, tag_errors=None):
    """Judge the window's samples: [(input index, tag, output)] with the
    outputs on the host. pairs_host: the run's input pairs as numpy. The
    reference runs once per distinct input (a tag is written into each
    eye's first texel, as the producer wrote it). Returns (checks, info)."""
    masks = inside_masks(config)
    refs = {}
    worst = None
    for idx, tag, out in samples:
        key = (idx, tag)
        if key not in refs:
            pair = np.array(pairs_host[idx], copy=True)
            if tag is not None:
                pair[:, 0, 0] = tag
            refs[key] = reference_pair(pair, config)
        r = compare(out, refs[key], masks, config["color_bits"])
        if worst is None or r["max_lsb"] > worst["max_lsb"]:
            worst = r
    limits = config["check_limits"]
    out = {}
    if worst is not None:
        out["max_lsb"] = {"value": worst["max_lsb"],
                          "limit": limits["max_lsb"]}
    if tag_errors is not None:
        out["tag_errors"] = {"value": int(tag_errors), "limit": 0}
    info = dict(worst or {}, samples=len(samples), references=len(refs))
    return out, info
