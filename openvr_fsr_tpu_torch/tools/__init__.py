"""Command-line tools of the port, each run as `python3 -m
openvr_fsr_tpu_torch.tools.<name>` on a machine with an NVIDIA GPU:

  bench_paths       one bench JSON line per pipeline path, each with its
                    own DMA floor (the port of the repository's
                    tools/bench_paths.py)
  parity            the port on the card against the NumPy oracle at full
                    size, 19 cases (the port of tools/parity.py)
  throughput_bench  stereo pairs/s at a batch of packed eyes through
                    Pipeline.process (the port of tools/throughput_bench.py)
  vpu_audit         the rate probes and each kernel's bound and share
  ab                a kernel against an earlier source, or less one part
  spatial_onchip    3 row-band strips against the single launch, bit for
                    bit, for the fused FSR and CAS upscale paths (the port
                    of tools/spatial_onchip.py)
"""
