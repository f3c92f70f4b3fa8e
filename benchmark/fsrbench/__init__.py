"""The benchmark harness of openvr_fsr_tpu_torch (the PyTorch and CUDA port).

One run measures one cell of BENCHMARK.json: a deployment (configs/<name>.json)
under a traffic mix (traffic/<name>.json), read by the one general generator
in load.py, with the per-layer readers of metrics/<name>.py. Everything a
cell is made of is found by its name, so a new cell made of existing pieces
is a BENCHMARK.json entry and, at most, new files. The yardstick (traffic
generation, trace reduction, roofline arithmetic, the plain reference and the
comparison that decides `correct`) lives here, outside the program.
"""
