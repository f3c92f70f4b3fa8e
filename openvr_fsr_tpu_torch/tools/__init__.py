"""Command-line tools of the port, each run as `python3 -m
openvr_fsr_tpu_torch.tools.<name>` on a machine with an NVIDIA GPU:

  bench_paths  one bench JSON line per pipeline path, each with its own
               DMA floor (the port of the repository's tools/bench_paths.py)
"""
