"""Row-band strips on one NVIDIA GPU against the single launch (the port of
the repository's tools/spatial_onchip.py).

Drives parallel.SpatialFsrPipeline with 3 strips on the one card
(devices=[cuda:0] * 3: the strips run one after another; the latency gain
needs more cards, the strips' bits do not; --cards N spreads them over N
cards, strip i on cuda:(i mod N)) for the fused FSR path
(sharpness 0.9) and the CAS upscale path (sharpness 0.6), at 2 x 1683x1869
-> 2 x 2244x2492 (rs 0.75, radius 0.5) on a zone plate and a noise frame,
eyes (0, 1), at the default band_rows, and requires the concatenated strips
to equal Pipeline.process on cuda:0 bit for bit, and each strip's DMA
floor (kernels/sol.py::build_dma_floor on the strip's geometry, the band
form where a band edge cuts a tile) to equal its plain version word for
word. Then it times, with CUDA events, each strip kernel, each strip's
floor, the single launch and its floor (on the frame padded to the ring
pitch, which the floor's TMA takes) (device time: each's calls replayed
from a CUDA graph on its card, all in turns, the best of ROUNDS replays
each), with each strip's vs_sol (its floor over its kernel) and the
strips' summed floors beside the single launch's, and on the host's clock
process_placed's strips and the single launch back to back (ITERS calls
ending when every card is synchronised) and the latency of one call (from
the call until every card is synchronised, the median of ITERS), and
prints one JSON line with the card's name and power limit. The times are a
record, not a gate.

    python3 -m openvr_fsr_tpu_torch.tools.spatial_onchip [--cards N]
        [--out FILE]

Exits 1 on an unequal texel or word, or when torch finds no CUDA GPU.
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

__all__ = ["main", "CASES", "STRIPS"]

H, W = 1869, 1683
STRIPS = 3
CASES = (("fsr_fused", dict(render_scale=0.75, sharpness=0.9, radius=0.5)),
         ("cas_upscale", dict(render_scale=0.75, sharpness=0.6, radius=0.5,
                              use_cas=True)))
ITERS = 100
ROUNDS = 5


def main(argv=None):
    """Run the check, print its JSON line and return the record."""
    from .. import bench
    from ..api.pipeline import Pipeline
    from ..core.config import Config
    from ..kernels.sol import build_dma_floor
    from ..parallel.spatial import SpatialFsrPipeline
    from ..utils import frames as FR
    from ..utils.timing import replay_ms, rotation_graph

    ap = argparse.ArgumentParser(
        prog="python3 -m openvr_fsr_tpu_torch.tools.spatial_onchip",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="cards to spread the strips over (default 1)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not 1 <= args.cards <= n:
        print(json.dumps({"metric": "spatial_onchip", "error": (
            "torch finds no CUDA GPU: the strips run on the card only"
            if n == 0 else f"{args.cards} cards asked for, torch finds "
            f"{n}")}), flush=True)
        sys.exit(1)
    dev = torch.device("cuda", 0)
    cards = [torch.device("cuda", i % args.cards) for i in range(STRIPS)]
    card = bench.card()
    frames = np.stack([FR.zone_plate_frame(H, W),
                       FR.noise_frame(H, W, seed=3)])

    def device_ms(calls):
        """Device ms per call of each (fn, x): ITERS calls captured in one
        CUDA graph on x's card, the graphs replayed in turns, the best of
        ROUNDS."""
        graphs = []
        for fn, x in calls:
            with torch.cuda.device(x.device):
                graphs.append((x.device, rotation_graph(fn, [x], ITERS)))
        rounds = []
        for _ in range(ROUNDS):
            row = []
            for d, g in graphs:
                with torch.cuda.device(d):
                    row.append(replay_ms(g, ITERS))
            rounds.append(row)
        return [min(r[i] for r in rounds) for i in range(len(graphs))]

    def sync():
        for d in set(cards) | {dev}:
            torch.cuda.synchronize(d)

    def latency_ms(call):
        """The median host ms of one call, from the call until every card
        is synchronised."""
        times = []
        for _ in range(ITERS):
            t0 = time.perf_counter()
            call()
            sync()
            times.append((time.perf_counter() - t0) * 1000.0)
        return float(np.median(times))

    def back_to_back_ms(call):
        """Host ms per call of ITERS calls back to back, ending when every
        card is synchronised; the best of 3."""
        best = float("inf")
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            for _ in range(ITERS):
                call()
            sync()
            best = min(best, (time.perf_counter() - t0) * 1000.0 / ITERS)
        return best

    rec = {"metric": "spatial_onchip", "device": card, "strips": STRIPS,
           "cards": args.cards, "results": {}}
    for name, kw in CASES:
        cfg = Config(enabled=True, **kw)
        pipe = Pipeline(cfg, device=dev)
        packed = torch.from_numpy(frames).to(dev).view(torch.int32)[..., 0] \
            .contiguous()
        ref = pipe.process(packed, eyes=(0, 1))
        ref_u32 = ref.cpu().numpy().view(np.uint32)
        sp = SpatialFsrPipeline(cfg, devices=cards)
        placed = sp.place(frames, eyes=(0, 1))
        got = sp.gather(placed[0], sp.process_placed(placed))
        unequal = int((got != ref_u32).sum()) if got.shape == ref_u32.shape \
            else -1
        shards = sp._cache[placed[0]][0]
        single = pipe.kernels[0]
        floors = [build_dma_floor(fn.dma_geometry) for fn, *_ in shards]
        single_floor = build_dma_floor(single.dma_geometry)
        hp, wp = single_floor.pad_to
        ring = torch.zeros((2, hp, wp), dtype=torch.int32, device=dev)
        ring[:, :H, :W] = packed
        floor_unequal = [int((f(x) != f.reference(x)).sum())
                         for f, x in zip(floors + [single_floor],
                                         placed[1] + [ring])]
        times = device_ms(
            [(fn, x) for (fn, *_), x in zip(shards, placed[1])]
            + [(f, x) for f, x in zip(floors, placed[1])]
            + [(single, packed), (single_floor, ring)])
        strip_ms, floor_ms = times[:STRIPS], times[STRIPS:2 * STRIPS]
        single_ms, single_floor_ms = times[2 * STRIPS:]
        placed_ms = back_to_back_ms(lambda: sp.process_placed(placed))
        single_b2b_ms = back_to_back_ms(lambda: single(packed))
        strips_latency = latency_ms(lambda: sp.process_placed(placed))
        single_latency = latency_ms(lambda: single(packed))
        res = {"bitwise_equal": unequal == 0, "unequal": unequal,
               "pixels": int(ref_u32.size),
               "bands": [list(fn.band_range) for fn, *_ in shards],
               "in_rows": [[base, rows] for _, base, rows, _, _ in shards],
               "out_rows": [rows for *_, rows, _ in shards],
               "strip_ms": strip_ms, "strips_sum_ms": float(sum(strip_ms)),
               "single_ms": single_ms,
               "strips_over_single": float(sum(strip_ms)) / single_ms,
               "floor_unequal": floor_unequal,
               "strip_floor_ms": floor_ms,
               "strip_vs_sol": [f / k for f, k in zip(floor_ms, strip_ms)],
               "strip_floors_sum_ms": float(sum(floor_ms)),
               "single_floor_ms": single_floor_ms,
               "single_vs_sol": single_floor_ms / single_ms,
               "process_placed_ms": placed_ms,
               "single_back_to_back_ms": single_b2b_ms,
               "strips_latency_ms": strips_latency,
               "single_latency_ms": single_latency}
        rec["results"][name] = res
        print(f"[spatial] {name}: {STRIPS} strips on {args.cards} of {card}, "
              f"unequal "
              f"{unequal} of {res['pixels']} texels; device ms per strip "
              f"{strip_ms}, summed {res['strips_sum_ms']}, single launch "
              f"{single_ms}; floors per strip {floor_ms} (vs_sol "
              f"{res['strip_vs_sol']}), summed "
              f"{res['strip_floors_sum_ms']}, the single launch's "
              f"{single_floor_ms} (vs_sol {res['single_vs_sol']}); unequal "
              f"floor words {floor_unequal}; back to back {placed_ms} "
              f"(strips) and "
              f"{single_b2b_ms} (single); one call's latency "
              f"{strips_latency} (strips on {args.cards} card(s)) and "
              f"{single_latency} (single)", file=sys.stderr, flush=True)
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if not all(r["bitwise_equal"] and not any(r["floor_unequal"])
               for r in rec["results"].values()):
        sys.exit(1)
    return rec


if __name__ == "__main__":
    main()
