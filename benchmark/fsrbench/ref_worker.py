"""One eye through the frozen reference, in a process of its own.

    python3 ref_worker.py < header line + frame bytes > output bytes

stdin: one JSON line (h, w, eye, and pipeline_oracle's keyword arguments)
followed by the eye's (h, w, 4) uint8 texels; stdout: the (out_h, out_w, 4)
uint8 output. Imports numpy and the frozen reference only.
"""

import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fsrbench.reference import pipeline_oracle  # noqa: E402


def main():
    header = json.loads(sys.stdin.buffer.readline())
    h, w = header.pop("h"), header.pop("w")
    frame = np.frombuffer(sys.stdin.buffer.read(h * w * 4),
                          np.uint8).reshape(h, w, 4)
    out = pipeline_oracle(frame, **header)
    sys.stdout.buffer.write(np.ascontiguousarray(out).tobytes())
    sys.stdout.buffer.flush()


if __name__ == "__main__":
    main()
