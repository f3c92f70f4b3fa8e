"""The one general load generator: a traffic file's parameters drive it.

  source "device", arrivals "closed": the pairs already on the card; each
    call is made as soon as the previous one returns, for the window's
    length, and the window ends in torch.cuda.synchronize(). Every call
    completed in the window counts.
  source "device", arrivals "paced": pair j is due at t0 + j / rate_hz for
    every j below seconds x rate_hz; the generator spins to the due time
    (it never sleeps), makes the call and synchronises: the
    pair's latency runs from its due time to the host seeing it complete,
    so a late pair delays the ones after it and they count the wait.
  source "host_rings", arrivals "paced": a producer thread pushes pair j's
    two eyes at its due time into one native FrameRing per eye (eye 0
    without blocking: a full ring drops the pair; eye 1 then blocking),
    with j written into each eye's first texel. The serving loop behind
    the rings is a copy of the port's tools/stream_bench.py::stream_run
    (commit 28546975116d8068293ff5b32b22b8593be022b5): an uploader thread
    polls both rings into one of two pinned host buffers, copies the pair
    to one of two device buffers on its own CUDA stream and hands the
    consumer an event; the consumer (this thread) waits on it, calls the
    model, copies the tags the kernel read, and synchronises each pair.
    A dropped pair never completes: its latency is beyond every other.
  source "host_rings", arrivals "closed": the same, unpaced: the producer
    pushes both eyes blocking, as fast as the rings take, until the window
    ends; each pair is due when its push begins.

`inputs` pairs rotate, pair j being input j % inputs. Each mode returns a
Window. The sampled outputs (`samples`) are what the judge compares: the
call drawn from the seed and the last call on the same input (closed and
paced on the card), or the first pair processed at or after the tag drawn
from the seed (the stream).
"""

import contextlib
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["Window", "StreamRig", "run_window", "POLL_S"]

POLL_S = 0.0005      # the uploader's wait between empty-ring polls
ITEM_TIMEOUT_S = 60.0
UNPACED_MAX_HZ = 2000  # bounds an unpaced stream's pairs per second
CLOSED_SAMPLE_RANGE = 1000   # the closed loop's sample is among its first calls


@dataclass
class Window:
    seconds: float                 # host clock, first call to last completion
    attempted: int                 # pairs due (open) or made (closed)
    completed: int
    failed: int                    # dropped or never completed
    latencies_ms: list = None      # per pair due, inf where it failed
    late_ms: list = None           # how late the generator made each pair
    enqueue_ms: list = None        # host ms inside each model call (paced)
    samples: list = field(default_factory=list)   # (input index, tag, output)
    push_s: list = field(default_factory=list)    # FrameRing.push calls
    pop_s: list = field(default_factory=list)     # FrameRing.pop calls that popped
    upload_ms: list = field(default_factory=list)  # H2D copy per pair (events)
    tag_errors: int = 0            # pairs the kernel read out of place
    t0: float = 0.0                # perf_counter when the window opened


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _wait_until(t):
    """Spin to t: a thread woken from sleep runs its next call cold, and
    that wake-up would set the tail (its p95 doubled in trials)."""
    while time.perf_counter() < t:
        pass


def run_window(model, traffic, pairs, seconds, rng, tracer, device):
    """One measured window of `traffic` over `pairs` (the input tensors on
    the card, or the stream's StreamRig), drawing the sample from `rng`."""
    mode = (traffic["source"], traffic["arrivals"])
    if mode == ("device", "closed"):
        return _closed(model, pairs, seconds, rng, tracer, device)
    if mode == ("device", "paced"):
        return _paced(model, pairs, seconds, float(traffic["rate_hz"]), rng,
                      tracer, device)
    if mode == ("host_rings", "paced"):
        return _stream(model, pairs, seconds, float(traffic["rate_hz"]), rng,
                       tracer, device)
    if mode == ("host_rings", "closed"):
        return _stream(model, pairs, seconds, 0.0, rng, tracer, device)
    raise ValueError(f"no generator for source {mode[0]!r} with arrivals "
                     f"{mode[1]!r}")


def _closed(model, pairs, seconds, rng, tracer, device):
    n_in = len(pairs)
    k = int(rng.integers(0, CLOSED_SAMPLE_RANGE))
    first = last = None
    _sync(device)
    tracer.start()
    with tracer.span("window"):
        t0 = time.perf_counter()
        t_end = t0 + seconds
        i = 0
        while True:
            with tracer.span("process"):
                out = model(pairs[i % n_in])
            if i == k:
                first = out
            if i % n_in == k % n_in:
                last = out
            i += 1
            if time.perf_counter() >= t_end:
                break
        with tracer.span("sync"):
            _sync(device)
        t1 = time.perf_counter()
    tracer.stop()
    samples = [(k % n_in, None, o) for o in (first, last) if o is not None]
    if not samples:        # a window too short to reach input k % n_in
        samples = [((i - 1) % n_in, None, out)]
    return Window(seconds=t1 - t0, attempted=i, completed=i, failed=0,
                  samples=samples, t0=t0)


def _paced(model, pairs, seconds, rate, rng, tracer, device):
    n_in = len(pairs)
    n = max(1, int(round(seconds * rate)))
    period = 1.0 / rate
    k = int(rng.integers(0, n))
    first = last = None
    lat, late, enq = [], [], []
    _sync(device)
    tracer.start()
    with tracer.span("window"):
        t0 = time.perf_counter() + 0.001
        for j in range(n):
            due = t0 + j * period
            with tracer.span("pace_wait"):
                _wait_until(due)
            ts = time.perf_counter()
            with tracer.span("process"):
                out = model(pairs[j % n_in])
            te = time.perf_counter()
            with tracer.span("sync"):
                _sync(device)
            td = time.perf_counter()
            late.append((ts - due) * 1e3)
            enq.append((te - ts) * 1e3)
            lat.append((td - due) * 1e3)
            if j == k:
                first = out
            if j % n_in == k % n_in:
                last = out
        t1 = time.perf_counter()
    tracer.stop()
    samples = [(k % n_in, None, o) for o in (first, last) if o is not None]
    return Window(seconds=t1 - t0, attempted=n, completed=n, failed=0,
                  latencies_ms=lat, late_ms=late, enqueue_ms=enq,
                  samples=samples, t0=t0)


class StreamRig:
    """The stream's two FrameRings (one eye a slot), pinned host buffers,
    device buffers and the uploader's CUDA stream: made once in set-up,
    warmed by a short window, and reused by the measured one."""

    def __init__(self, srcs, slots, device):
        from openvr_fsr_tpu_torch.native_rt import FrameRing

        self.srcs = srcs
        self.device = device
        self.cuda = device.type == "cuda"
        shape = srcs[0].shape
        self.parts = [slice(0, 1), slice(1, 2)]
        self.ring = [FrameRing(srcs[0][p].nbytes, nslots=slots)
                     for p in self.parts]
        self.host = [torch.empty(shape, dtype=torch.int32,
                                 pin_memory=self.cuda) for _ in range(2)]
        self.host_np = [t.numpy() for t in self.host]
        self.dbuf = [torch.empty(shape, dtype=torch.int32, device=device)
                     for _ in range(2)]
        self.up_stream = torch.cuda.Stream(device) if self.cuda else None

    def close(self):
        for r in self.ring:
            r.close()


def _stream(model, rig, seconds, rate, rng, tracer, device):
    """One window through the rig's rings, uploader and consumer."""
    cuda = rig.cuda
    srcs, ring, parts = rig.srcs, rig.ring, rig.parts
    host, host_np, dbuf, up_stream = rig.host, rig.host_np, rig.dbuf, \
        rig.up_stream
    n_in = len(srcs)
    # rate 0: unpaced, the producer pushes (blocking) as fast as the rings
    # take until the window's end, each pair due when its push begins
    n = max(1, int(round(seconds * (rate or UNPACED_MAX_HZ))))
    k = int(rng.integers(0, n if rate else 1))
    due = [0.0] * n
    n_pushed = [n]
    copied = [None, None]      # the copy out of host[k] (timing events)
    consumed = [None, None]    # behind the consumer's last kernel on dbuf[k]
    free = threading.Semaphore(2)
    items = queue.Queue()
    producer_done = threading.Event()
    dropped = [False] * n
    late = [0.0] * n
    up = {"error": None, "copies": [], "pop_s": [], "push_s": []}
    t0_box = []

    def producer():
        t0 = t0_box[0]
        own = [x.copy() for x in srcs]
        try:
            for j in range(n):
                if rate:
                    due[j] = t0 + j / rate
                    with tracer.span("pace_wait"):
                        dt = due[j] - time.perf_counter()
                        if dt > 0:
                            time.sleep(dt)
                else:
                    due[j] = time.perf_counter()
                    if due[j] >= t0 + seconds:
                        n_pushed[0] = j
                        break
                late[j] = (time.perf_counter() - due[j]) * 1e3
                frame = own[j % n_in]
                frame[:, 0, 0] = j
                with tracer.span("ring_push"):
                    ts = time.perf_counter()
                    ok = ring[0].push(frame[parts[0]], blocking=not rate)
                    if ok:
                        ring[1].push(frame[parts[1]])
                    up["push_s"].append(time.perf_counter() - ts)
                dropped[j] = not ok
        finally:
            producer_done.set()

    def poll(r, out):
        """Pop the next eye from ring r into out, waiting; False once the
        producer is done and the ring is empty."""
        while True:
            ts = time.perf_counter()
            got = r.pop(out.shape, np.int32, blocking=False, out=out)
            if got is not None:
                up["pop_s"].append(time.perf_counter() - ts)
                return True
            if producer_done.is_set() and r.stats()["depth"] == 0:
                return False
            with tracer.span("poll_sleep"):
                time.sleep(POLL_S)

    def uploader():
        try:
            with (torch.cuda.stream(up_stream) if cuda
                  else contextlib.nullcontext()):
                slot = 0
                while True:
                    free.acquire()         # the consumer is done with slot
                    if copied[slot] is not None:
                        copied[slot].synchronize()   # host[slot] copied out
                    with tracer.span("ring_pop"):
                        ok = all(poll(r, host_np[slot][p])
                                 for r, p in zip(ring, parts))
                    if not ok:
                        break
                    tag = int(host_np[slot].reshape(-1)[0])
                    ev = None
                    with tracer.span("h2d"):
                        if cuda:
                            if consumed[slot] is not None:
                                up_stream.wait_event(consumed[slot])
                            c0 = torch.cuda.Event(enable_timing=True)
                            ev = torch.cuda.Event(enable_timing=True)
                            c0.record(up_stream)
                            dbuf[slot].copy_(host[slot], non_blocking=True)
                            ev.record(up_stream)
                            copied[slot] = ev
                            up["copies"].append((c0, ev))
                        else:
                            dbuf[slot].copy_(host[slot])
                    items.put((slot, tag, dbuf[slot], ev))
                    slot ^= 1
        except Exception as e:             # reported by the consumer
            up["error"] = e
        finally:
            items.put(None)

    cur = torch.cuda.current_stream(device) if cuda else None
    lat = [float("inf")] * n
    host_tags, dev_tags = [], []
    sample = None
    _sync(device)
    tracer.start()
    threads = [threading.Thread(target=producer, daemon=True),
               threading.Thread(target=uploader, daemon=True)]
    with tracer.span("window"):
        t0_box.append(time.perf_counter() + 0.005)
        t0 = t0_box[0]
        for t in threads:
            t.start()
        while True:
            with tracer.span("wait_item"):
                try:
                    item = items.get(timeout=ITEM_TIMEOUT_S)
                except queue.Empty:
                    item = None
                    up["error"] = up["error"] or RuntimeError(
                        f"stream: no pair for {ITEM_TIMEOUT_S} s")
            if item is None:
                break
            slot, tag, frame, ev = item
            with tracer.span("process"):
                if ev is not None:
                    cur.wait_event(ev)
                out = model(frame)
                dev_tags.append(frame[:, 0, 0].clone())   # behind the kernel
                if cuda:
                    done = torch.cuda.Event()
                    done.record(cur)
                    consumed[slot] = done
            free.release()
            with tracer.span("sync"):
                _sync(device)
            if 0 <= tag < n:
                lat[tag] = (time.perf_counter() - due[tag]) * 1e3
            host_tags.append(tag)
            if sample is None and tag >= k:
                sample = (tag % n_in, tag, out)
            last = (tag % n_in, tag, out)
        t1 = time.perf_counter()
    tracer.stop()
    for t in threads:
        t.join(timeout=30)
    if up["error"] is not None:
        raise RuntimeError(f"stream: {up['error']!r}") from up["error"]
    if any(t.is_alive() for t in threads):
        raise RuntimeError("stream: a producer or uploader thread did not end")
    n = n_pushed[0]
    lat, late = lat[:n], late[:n]
    pushed = [j for j in range(n) if not dropped[j]]
    got = torch.stack(dev_tags).cpu().tolist() if dev_tags else []
    tag_errors = sum(1 for a, b in zip(host_tags, got) if b != [a, a])
    tag_errors += sum(1 for a, b in zip(host_tags, host_tags[1:]) if b <= a)
    tag_errors += abs(len(host_tags) - len(pushed))
    tag_errors += len(set(pushed) - set(host_tags))
    if sample is None and host_tags:
        sample = last
    upload = [a.elapsed_time(b) for a, b in up["copies"]]
    done_ok = sum(1 for j in range(n) if lat[j] != float("inf"))
    return Window(seconds=t1 - t0, attempted=n, completed=done_ok,
                  failed=n - done_ok, latencies_ms=lat, late_ms=late,
                  samples=[sample] if sample else [], push_s=up["push_s"],
                  pop_s=up["pop_s"], upload_ms=upload, tag_errors=tag_errors,
                  t0=t0)
