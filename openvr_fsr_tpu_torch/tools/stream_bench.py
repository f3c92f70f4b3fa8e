"""Streaming benchmark on one NVIDIA GPU: the '2-eye x 90 fps stream'
configuration (BASELINE.json config 4) end to end through the serving
stack, the port of the repository's tools/stream_bench.py:

  producer thread --> native frame rings --> uploader thread --> card
  (paced at --fps,    (C++ staging pools,    (its own CUDA      consumer:
   or as fast as the   native_rt.FrameRing,   stream, two        packed-u32
   rings take)         one per eye)           pinned and two     fused kernel,
                                              device buffers)    windows of 8

Frames are packed u32 planes pre-padded to the kernel's ring pitch
(`run.pad_to`), the zero-copy serving format: (2, hp, wp) int32 stereo
pairs, 26.8 MB at the headline shape. FrameRing is the JAX package's ring
unchanged: each push and pop copies a whole slot with the ring's mutex
held, so on one ring of stereo slots (the JAX tool's layout) every copy
runs after the one before, and the host's copy rate bounds the stream (an
NVIDIA H100 host copies about 5 GB/s on one core: 4 x 26.8 MB per pair is
more than 11.1 ms). So each eye of a pair goes through a ring of its own
(slots of one padded eye, 13.4 MB): the producer's push of eye 1 and the
uploader's pop of eye 0 copy side by side. The JAX tool's one-ring layout
is measured beside it (`one_ring`, not gated), the cost of the ring's
locked copies. The uploader pops each eye straight into one of two pinned
host buffers (the ring's memcpy is the only host copy), copies the pair
with non_blocking=True into one of two device buffers on its own stream
and records an event the consumer waits on (`wait_event`) before it
launches. A pinned buffer is refilled only after its copy's event
completes; a device buffer is overwritten only after the event the
consumer records behind its kernel on it. Each pair carries a tag (its
push number) in each eye's first texel; the consumer copies the tags it
finds in device memory behind each kernel, and the run fails unless those
equal the popped tags, in push order, and one sampled output equals run()
of the same frame placed in device memory directly: a buffer overwritten
too early, or eyes of two pairs, show as a wrong tag or output.

Legs, as the JAX tool splits them:
  * device-only rate: run() back to back on three device-resident frames
    (utils/timing.py::wall_ms, best of 2 rounds of 30);
  * upload GB/s: one pair's pinned host-to-device copy timed with CUDA
    events, the best of 3;
  * end to end: sustained pairs/s through rings, upload and kernel, over
    windows of 8 calls each closed by a sync of the consumer's stream,
    the latency per pair averaged over its window (tools/stream_bench.py
    :186-206).
The gated run is UNPACED: the producer pushes, blocking, as fast as the
rings take, and `verdict` is "pass" when its pairs/s reach the target
(TARGET_FPS, 90 pairs/s) with no tolerance. A producer paced at the target cannot
exceed it, so the run paced at `--fps` (default 90; 0 skips it) is recorded
beside it and not gated: its pairs/s, drops (pairs pushed into a full
ring), p50 / p99 ms per pair against the frame budget 1000 / fps, and the
uploader's busy share. Otherwise the verdict is "transport_bound" when the
measured upload rate is below what the target needs, else
"device_bound" (the JAX tool's :232-241). `--device-resident` carries
16-byte tokens through one ring instead of pixels: the frames are staged
on the card once, isolating the device leg (the JAX tool's :92-101,
168-169).

    python3 -m openvr_fsr_tpu_torch.tools.stream_bench [--seconds 5]
        [--fps 90] [--device-resident] [--out FILE]

Prints progress lines and one JSON row (the JAX row's keys, and more),
written to FILE only when --out is given. With no CUDA GPU (and no
`--device cpu`, which runs the plain versions for tests) it prints an
error row and exits 1.
"""

import argparse
import contextlib
import json
import queue
import sys
import threading
import time

import numpy as np

METRIC = "stream_sustained_stereo_pairs_per_s_2244x2492"
TARGET_FPS = 90.0      # BASELINE.json config 4: 2 eyes x 90 fps
WINDOW = 8             # calls per window, closed by a sync
POLL_S = 0.0005        # the uploader's wait between empty-ring polls
SAMPLE_AT = 3          # the processed frame whose output is checked
DEVICE_WARMUP, DEVICE_ITERS, DEVICE_ROUNDS = 8, 30, 2   # device-only leg


def ring_sources(h, w, pad_to):
    """Three packed stereo pairs (2, hp, wp) int32 on the host: eye 0 a
    zone plate, eye 1 noise from seed i, padded to the ring pitch; each
    eye's first texel holds i (the JAX tool's tag for --device-resident)."""
    from ..utils import frames as FR
    hp, wp = pad_to
    out = []
    for i in range(3):
        u8 = np.stack([FR.zone_plate_frame(h, w), FR.noise_frame(h, w, seed=i)])
        packed = np.ascontiguousarray(u8).view(np.int32)[..., 0]
        frame = np.ascontiguousarray(
            np.pad(packed, ((0, 0), (0, hp - h), (0, wp - w))))
        frame[:, 0, 0] = i
        out.append(frame)
    return out


def tagged(srcs, tag):
    """The ring frame the producer pushes as number `tag`: source tag % 3
    with the tag in each eye's first texel."""
    frame = srcs[tag % len(srcs)].copy()
    frame[:, 0, 0] = tag
    return frame


def stream_run(run, srcs, dev_srcs, *, device, fps, seconds, slots=6,
               device_resident=False, rings=2):
    """One end-to-end run of `seconds`: producer, ring, uploader, consumer.
    rings 2: each eye of a pair through a FrameRing of its own (slots of
    one eye), so a push into one ring and a pop from the other copy side
    by side; rings 1: the JAX tool's one ring of stereo slots, where the
    ring's lock puts every push and pop one after the other.
    --device-resident carries 16-byte tokens through one ring. fps > 0
    paces the producer (a non-blocking push of eye 0: a full ring drops the
    pair; eye 1 then pushes blocking, the uploader draining its ring); fps 0
    pushes blocking, as fast as the rings take. After the timed window the
    producer stops between pairs and every popped pair is still processed
    (drained, untimed). Returns the leg's numbers; raises RuntimeError when
    a tag or the sampled output is wrong."""
    import torch

    from ..native_rt import FrameRing

    cuda = device.type == "cuda"
    if device_resident:
        pair_shape = (4,)                  # a token: the pair's tag
        ring_srcs = [np.full(pair_shape, i, np.int32) for i in range(3)]
        rings = 1
    else:
        pair_shape = srcs[0].shape
        ring_srcs = srcs
    # the part of a pair each ring carries
    parts = [slice(None)] if rings == 1 else [slice(e, e + 1)
                                              for e in range(2)]
    ring = [FrameRing(ring_srcs[0][part].nbytes, nslots=slots)
            for part in parts]
    host = [torch.empty(pair_shape, dtype=torch.int32, pin_memory=cuda)
            for _ in range(2)]
    host_np = [t.numpy() for t in host]
    dbuf = [torch.empty(pair_shape, dtype=torch.int32, device=device)
            for _ in range(2)] if not device_resident else None
    copied = [None, None]      # the copy out of host[k] (timing events)
    consumed = [None, None]    # behind the consumer's last kernel on dbuf[k]
    free = threading.Semaphore(2)
    items = queue.Queue()
    stop, producer_done = threading.Event(), threading.Event()
    up = {"idle_s": 0.0, "copies": [], "error": None}

    def producer():
        period = 1.0 / fps if fps else 0.0
        nxt = time.perf_counter()
        own = [x.copy() for x in ring_srcs]   # tagged in place: push copies
        i = 0
        while not stop.is_set():
            frame = own[i % 3]
            if device_resident:
                frame[0] = i
            else:
                frame[:, 0, 0] = i
            try:
                if ring[0].push(frame[parts[0]], blocking=not fps):
                    for r, part in zip(ring[1:], parts[1:]):
                        r.push(frame[part])
            except RuntimeError:           # ring 0 closed while blocked
                break
            i += 1
            if fps:
                nxt += period
                dt = nxt - time.perf_counter()
                if dt > 0:
                    time.sleep(dt)

    def poll(r, out):
        """Pop the next part from ring r into out, waiting; False once the
        producer is done and the ring is empty."""
        while r.pop(out.shape, np.int32, blocking=False, out=out) is None:
            if producer_done.is_set() and r.stats()["depth"] == 0:
                return False
            t0 = time.perf_counter()
            time.sleep(POLL_S)
            up["idle_s"] += time.perf_counter() - t0
        return True

    def uploader():
        up_stream = torch.cuda.Stream(device) if cuda else None
        try:
            with (torch.cuda.stream(up_stream) if cuda
                  else contextlib.nullcontext()):
                k = 0
                while True:
                    t0 = time.perf_counter()
                    free.acquire()         # the consumer is done with slot k
                    up["idle_s"] += time.perf_counter() - t0
                    if copied[k] is not None:
                        copied[k].synchronize()   # host[k]'s copy has ended
                    # the producer completes every pair it begins
                    if not all(poll(r, host_np[k][part])
                               for r, part in zip(ring, parts)):
                        break
                    tag = int(host_np[k].reshape(-1)[0])
                    ev = None
                    if device_resident:
                        frame = dev_srcs[tag % 3]
                    elif cuda:
                        if consumed[k] is not None:
                            up_stream.wait_event(consumed[k])
                        c0 = torch.cuda.Event(enable_timing=True)
                        ev = torch.cuda.Event(enable_timing=True)
                        c0.record(up_stream)
                        dbuf[k].copy_(host[k], non_blocking=True)
                        ev.record(up_stream)
                        copied[k] = ev
                        up["copies"].append((c0, ev))
                        frame = dbuf[k]
                    else:
                        dbuf[k].copy_(host[k])
                        frame = dbuf[k]
                    items.put((k, tag, frame, ev))
                    k ^= 1
        except Exception as e:             # reported by the consumer
            up["error"] = e
        finally:
            items.put(None)

    cur = torch.cuda.current_stream(device) if cuda else None

    def consume(item, host_tags, dev_tags):
        k, tag, frame, ev = item
        if ev is not None:
            cur.wait_event(ev)
        out = run(frame)
        dev_tags.append(frame[:, 0, 0].clone())   # behind the kernel
        if cuda and not device_resident:
            done = torch.cuda.Event()
            done.record(cur)
            consumed[k] = done
        free.release()
        host_tags.append(tag)
        return out

    def sync():
        if cuda:
            cur.synchronize()

    threads = [threading.Thread(target=producer, daemon=True),
               threading.Thread(target=uploader, daemon=True)]
    for t in threads:
        t.start()
    host_tags, dev_tags, lat = [], [], []
    sample = None
    finished = False
    n = 0
    t_start = time.perf_counter()
    t_end = t_start + seconds
    while time.perf_counter() < t_end and not finished:
        t0 = time.perf_counter()
        got = 0
        for _ in range(WINDOW):
            try:
                item = items.get(timeout=0.5)
            except queue.Empty:
                break
            if item is None:
                finished = True
                break
            out = consume(item, host_tags, dev_tags)
            if n + got == SAMPLE_AT:
                sample = (item[1], out)
            got += 1
        if not got:
            continue
        sync()
        lat.extend([(time.perf_counter() - t0) / got] * got)
        n += got
    dur = time.perf_counter() - t_start
    # stop the producer between pairs (closing ring 0 wakes a blocked
    # push), then process whatever the uploader still pops
    stop.set()
    ring[0].close()
    threads[0].join(timeout=10)
    producer_done.set()
    drained = 0
    while not finished:
        item = items.get(timeout=30)
        if item is None:
            break
        consume(item, host_tags, dev_tags)
        drained += 1
    sync()
    threads[1].join(timeout=10)
    for r in ring:
        r.close()
    if up["error"] is not None:
        raise RuntimeError(f"stream uploader failed: {up['error']!r}") \
            from up["error"]
    if any(t.is_alive() for t in threads):
        raise RuntimeError("stream: a producer or uploader thread did not end")
    st = [r.stats() for r in ring]
    got_tags = torch.stack(dev_tags).cpu().tolist() if dev_tags else []
    want_tags = [[t % 3 if device_resident else t] * 2 for t in host_tags]
    in_order = all(a < b for a, b in zip(host_tags, host_tags[1:]))
    if not fps:       # nothing drops: every push number, from 0
        in_order = in_order and host_tags == list(range(len(host_tags)))
    if not in_order or got_tags != want_tags:
        raise RuntimeError(
            f"stream: frames out of order or overwritten: popped tags "
            f"{host_tags[:12]}..., tags the kernels read {got_tags[:12]}...")
    if any(x["popped"] != n + drained for x in st):
        raise RuntimeError(f"stream: {n + drained} pairs processed, "
                           f"{[x['popped'] for x in st]} popped")
    sample_equal = None
    if sample is not None:
        tag, out = sample
        ref = dev_srcs[tag % 3] if device_resident else \
            torch.from_numpy(tagged(srcs, tag)).to(device)
        sample_equal = bool(torch.equal(out, run(ref)))
        if not sample_equal:
            raise RuntimeError(f"stream: the output of frame {tag} differs "
                               "from run() of that frame in device memory")
    copy_ms = [a.elapsed_time(b) for a, b in up["copies"]]
    lat_ms = np.asarray(lat) * 1e3
    pct = (lambda q: float(np.percentile(lat_ms, q))) if len(lat_ms) \
        else (lambda q: None)
    return {
        "pairs_per_s": n / dur,
        "seconds": dur,
        "rings": len(ring),
        "pairs_processed": n,
        "pairs_drained": drained,
        "ring_pushed": st[0]["pushed"],
        "ring_popped": st[0]["popped"],
        "ring_dropped": st[0]["dropped"],
        "p50_ms_per_pair": pct(50),
        "p99_ms_per_pair": pct(99),
        "max_ms_per_pair": float(lat_ms.max()) if len(lat_ms) else None,
        "uploader_busy_share": max(0.0, 1.0 - up["idle_s"] / dur),
        "upload_copy_ms_mean": (float(np.mean(copy_ms)) if copy_ms
                                else None),
        "tags_in_order": True,
        "sample_tag": sample[0] if sample else None,
        "sample_equal": sample_equal,
    }


def upload_gbs(host_frame, device, rounds=3):
    """One slot's host-to-device copy from pinned memory, timed with CUDA
    events on a stream of its own: GB/s, the best of `rounds`."""
    import torch
    pinned = torch.from_numpy(host_frame).pin_memory()
    dst = torch.empty(pinned.shape, dtype=pinned.dtype, device=device)
    side = torch.cuda.Stream(device)
    best = None
    with torch.cuda.stream(side):
        for _ in range(rounds):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(side)
            dst.copy_(pinned, non_blocking=True)
            end.record(side)
            end.synchronize()
            ms = start.elapsed_time(end)
            best = ms if best is None else min(best, ms)
    return pinned.numel() * 4 / 1e9 / (best / 1000.0)


def measure(w=1683, h=1869, *, fps=TARGET_FPS, seconds=5.0,
            render_scale=0.75, radius=0.5, slots=6,
            device_resident=False, device="cuda", log=print):
    """The stream's row: the unpaced run through a ring per eye (value, the
    gated rate), the run paced at `fps` beside it (fps 0 skips it), the
    unpaced run through the JAX tool's one ring of stereo slots
    (`one_ring`; not with device_resident), the device-only rate and the
    upload rate. Per-eye input w x h (W x H). Returns (row, the kernel
    build, counting its launches)."""
    import torch

    from .. import bench
    from ..api.pipeline import Pipeline
    from ..core.config import Config
    from ..utils.timing import hbm_calibration, wall_ms

    pipe = Pipeline(Config(enabled=True, render_scale=render_scale,
                           sharpness=0.9, radius=radius), device=device)
    dev = pipe.device
    cuda = dev.type == "cuda"
    run = pipe._build(2, h, w, (0, 1), packed=True)
    hp, wp = run.pad_to
    srcs = ring_sources(h, w, run.pad_to)
    dev_srcs = [torch.from_numpy(x).to(dev) for x in srcs]
    slot_bytes = 16 if device_resident else srcs[0][:1].nbytes
    run(dev_srcs[0])
    ow, oh = pipe.output_size(w, h)
    log(f"[stream] {w}x{h}/eye -> {ow}x{oh}, target {TARGET_FPS} pairs/s, "
        f"ring depth {slots}, slot {slot_bytes / 2**20:.1f} MB (packed "
        f"u32, padded to {hp}x{wp}"
        f"{'; tokens: device-resident' if device_resident else ', one eye'}"
        f"), on {dev}")

    # ---- leg 1: device-only rate (device-resident frames) -------------------
    wall_ms(run, dev_srcs, DEVICE_WARMUP)
    dev_ms = min(wall_ms(run, dev_srcs, DEVICE_ITERS)
                 for _ in range(DEVICE_ROUNDS))
    dev_pairs = 1000.0 / dev_ms
    log(f"[stream] device-only: {dev_pairs:.1f} pairs/s ({dev_ms:.4f} "
        "ms/pair back to back)")

    # ---- leg 2: upload bandwidth ---------------------------------------------
    need_gbs = srcs[0].nbytes / 1e9 * TARGET_FPS
    up_gbs = upload_gbs(srcs[0], dev) if cuda else None
    if up_gbs is not None:
        log(f"[stream] upload: {srcs[0].nbytes / 2**20:.1f} MB pinned copy "
            f"at {up_gbs:.3f} GB/s (need {need_gbs:.3f} GB/s for {TARGET_FPS} "
            "pairs/s)")

    # ---- the end-to-end runs ---------------------------------------------------
    legs = {}
    for name, pace, rings in (("unpaced", 0.0, 2), ("paced", fps, 2),
                              ("one_ring", 0.0, 1)):
        if (name == "paced" and not fps) or (name == "one_ring"
                                             and device_resident):
            continue
        leg = legs[name] = stream_run(
            run, srcs, dev_srcs, device=dev, fps=pace, seconds=seconds,
            slots=slots, device_resident=device_resident, rings=rings)
        log(f"[stream] {name}{f' at {pace} fps' if pace else ''}, "
            f"{leg['rings']} ring(s): "
            f"{leg['pairs_processed']} pairs in {leg['seconds']:.2f} s = "
            f"{leg['pairs_per_s']:.2f} pairs/s; per pair (window-averaged) "
            f"p50 {leg['p50_ms_per_pair']} p99 {leg['p99_ms_per_pair']} ms; "
            f"ring pushed {leg['ring_pushed']} popped {leg['ring_popped']} "
            f"dropped {leg['ring_dropped']}; uploader busy "
            f"{leg['uploader_busy_share']:.3f}; H2D copy "
            f"{leg['upload_copy_ms_mean']} ms mean; tags in order, sample "
            f"frame {leg['sample_tag']} equal {leg['sample_equal']}")
    main_leg = legs["unpaced"]
    value = main_leg["pairs_per_s"]
    if value >= TARGET_FPS:
        verdict = "pass"
    elif not device_resident and up_gbs is not None and up_gbs < need_gbs:
        verdict = "transport_bound"
    else:
        verdict = "device_bound"
    rbw, wbw = hbm_calibration(dev) if cuda else (None, None)
    paced = legs.get("paced")
    row = {
        "metric": METRIC,
        "session_hbm_read_gbs": rbw / 1e9 if rbw else None,
        "session_hbm_write_gbs": wbw / 1e9 if wbw else None,
        "value": value,
        "unit": "pairs/s",
        "target_fps": TARGET_FPS,
        "seconds": seconds,
        "pairs_processed": main_leg["pairs_processed"],
        "device_resident": bool(device_resident),
        "device_only_pairs_per_s": dev_pairs,
        "upload_gbs_this_session": up_gbs,
        "p50_ms_per_pair": main_leg["p50_ms_per_pair"],
        "p99_ms_per_pair": main_leg["p99_ms_per_pair"],
        "ring_dropped": main_leg["ring_dropped"],
        "verdict": verdict,
        "pass_rule": "value >= target_fps on the unpaced run (the producer "
                     "pushes as fast as the ring takes), no tolerance",
        "device": bench.card() if cuda else "cpu",
        "ring_slot_bytes": slot_bytes,
        "ring_slots": slots,
        "upload_need_gbs": need_gbs,
        "unpaced": main_leg,
        "paced": None if paced is None else dict(
            paced, fps=fps, frame_budget_ms=1000.0 / fps),
        "one_ring": legs.get("one_ring"),
    }
    log(f"[stream] verdict {verdict}: {value:.2f} pairs/s unpaced against "
        f"{TARGET_FPS}")
    return row, run.kernel


def main(argv=None):
    """Measure, print the JSON row, write it to --out if given, and return
    it."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", default="1683x1869", help="per-eye input WxH")
    ap.add_argument("--fps", type=float, default=TARGET_FPS,
                    help="the paced run's producer rate (0: no paced run)")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--render-scale", type=float, default=0.75)
    ap.add_argument("--radius", type=float, default=0.5)
    ap.add_argument("--slots", type=int, default=6, help="ring depth")
    ap.add_argument("--device-resident", action="store_true",
                    help="carry tokens, not pixels, through the ring: the "
                         "frames are staged on the card once")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--out", default=None, help="write the JSON row here")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.device != "cpu":
        from .. import bench
        bench.require_gpu([METRIC], unit="pairs/s")
    w, h = (int(v) for v in args.size.split("x"))
    row, _ = measure(w, h, fps=args.fps,
                  seconds=args.seconds, render_scale=args.render_scale,
                  radius=args.radius, slots=args.slots,
                  device_resident=args.device_resident, device=args.device)
    print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(row, f, indent=1)
        print(f"[stream] wrote {args.out}", flush=True)
    return row


if __name__ == "__main__":
    sys.exit(0 if main()["verdict"] == "pass" else 1)
