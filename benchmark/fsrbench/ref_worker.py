"""One eye through the frozen reference, in a process of its own.

    python3 ref_worker.py < header line + frame bytes > output bytes

stdin: one JSON line (h, w, eye, and pipeline_oracle's keyword arguments)
followed by the eye's (h, w, 4) channels in the dtype of the header's
color_bits (texels.py: uint8 at 8, uint16 at 10); stdout: the
(out_h, out_w, 4) output in the same dtype. Imports numpy, texels.py and
the frozen reference only.
"""

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fsrbench.reference import pipeline_oracle  # noqa: E402
from fsrbench.texels import texel_format  # noqa: E402


def main():
    header = json.loads(sys.stdin.buffer.readline())
    h, w = header.pop("h"), header.pop("w")
    dtype = np.dtype(texel_format(header["color_bits"]).dtype)
    frame = np.frombuffer(sys.stdin.buffer.read(h * w * 4 * dtype.itemsize),
                          dtype).reshape(h, w, 4)
    out = pipeline_oracle(frame, **header)
    sys.stdout.buffer.write(np.ascontiguousarray(out).tobytes())
    sys.stdout.buffer.flush()


if __name__ == "__main__":
    main()
