"""The texel words a configuration's `color_bits` chooses (texels.py), and
the harness at both formats on the CPU: the inputs, the reference's feed
and the judge. RGBA8 pairs equal, bit for bit, those of make_pairs before
it took a format; R10G10B10A2 words hold every value of each channel where
DXGI puts it; the judge reads 10-bit outputs in 10-bit units. A 10-bit
deployment stops at set-up with the port's own refusal of packed planes at
color_bits 10: the port's packed 10-bit path does not exist yet."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import ROOT

from fsrbench import harness, inputs, judge, work
from fsrbench.judge import WORKER
from fsrbench.reference import pipeline_oracle as frozen_oracle
from fsrbench.spec import Cell, Spec
from fsrbench.texels import BYTES_PER_TEXEL, RGB10A2, RGBA8, texel_format

CPU = torch.device("cpu")
SEEDS = [2**31 + 77, 3_100_000_555, 7]


def _make_pairs_rgba8(seed, n, w, h, device):
    """make_pairs as it was before it took a format, frozen here."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    hb, wb = -(-h // 8), -(-w // 8)
    blocks = torch.randint(0, 256, (n, 2, hb, wb, 3), generator=g,
                           device=device, dtype=torch.uint8)
    base = blocks.repeat_interleave(8, dim=2).repeat_interleave(
        8, dim=3)[:, :, :h, :w].to(torch.int16)
    noise = torch.randint(-24, 25, (n, 2, h, w, 3), generator=g,
                          device=device, dtype=torch.int16)
    rgba = torch.empty((n, 2, h, w, 4), dtype=torch.uint8, device=device)
    rgba[..., :3] = (base + noise).clamp_(0, 255).to(torch.uint8)
    rgba[..., 3] = torch.randint(0, 256, (n, 2, h, w), generator=g,
                                 device=device, dtype=torch.uint8)
    packed = rgba.view(torch.int32)[..., 0]
    return [packed[i].contiguous() for i in range(n)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("wh", [(63, 54), (97, 40)])
def test_rgba8_pairs_unchanged(seed, wh):
    w, h = wh
    want = _make_pairs_rgba8(seed, 3, w, h, CPU)
    got = inputs.make_pairs(seed, 3, w, h, CPU, color_bits=8)
    default = inputs.make_pairs(seed, 3, w, h, CPU)
    for a, b, c in zip(want, got, default):
        assert b.dtype == torch.int32 and b.shape == (2, h, w)
        assert b.is_contiguous()
        assert torch.equal(a, b) and torch.equal(a, c)


def _all_values(fmt):
    """Every value of each channel, in turn, with the others walking."""
    rows = []
    for i, m in enumerate(fmt.channel_max):
        v = np.arange(m + 1)
        c = np.stack([(v * 7 + 3 * j) % (mj + 1) for j, mj in
                      enumerate(fmt.channel_max)], axis=-1)
        c[:, i] = v
        rows.append(c)
    return np.concatenate(rows).astype(fmt.dtype)


@pytest.mark.parametrize("fmt", [RGBA8, RGB10A2], ids=["rgba8", "rgb10a2"])
@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_words_round_trip_every_value(fmt, kind):
    c = _all_values(fmt)
    x = c if kind == "numpy" else torch.from_numpy(c.astype(np.int32))
    words = fmt.to_words(x)
    back = fmt.from_words(words)
    if kind == "torch":
        assert words.dtype == torch.int32
        assert back.dtype == fmt.torch_dtype
        words, back = words.numpy(), back.to(torch.int32).numpy()
    else:
        assert words.dtype == np.int32 and back.dtype == fmt.dtype
    np.testing.assert_array_equal(back, c)
    # the words are DXGI's: each channel shifted to its place
    want = sum(c[:, i].astype(np.uint64) << np.uint64(s)
               for i, s in enumerate(fmt.shifts))
    np.testing.assert_array_equal(words.view(np.uint32),
                                  want.astype(np.uint32))


def test_rgb10a2_unit_values_at_bits_0_10_20_30():
    unit = np.eye(4, dtype=np.uint16)
    words = RGB10A2.to_words(unit).view(np.uint32)
    np.testing.assert_array_equal(words, [1 << 0, 1 << 10, 1 << 20, 1 << 30])
    top = RGB10A2.to_words(np.array([[1023, 1023, 1023, 3]], np.uint16))
    assert top.view(np.uint32)[0] == 0xFFFFFFFF
    assert RGB10A2.channel_max == (1023, 1023, 1023, 3)
    assert RGBA8.channel_max == (255,) * 4
    assert (RGBA8.dtype, RGB10A2.dtype) == (np.uint8, np.uint16)
    assert BYTES_PER_TEXEL == 4
    assert texel_format(8) is RGBA8 and texel_format(10) is RGB10A2
    with pytest.raises(ValueError):
        texel_format(16)


def test_rgba8_from_words_is_the_byte_view():
    pair = inputs.make_pairs(SEEDS[0], 1, 63, 54, CPU)[0]
    words = pair.numpy()
    view = words.view(np.uint8).reshape(2, 54, 63, 4)
    np.testing.assert_array_equal(RGBA8.from_words(words), view)
    np.testing.assert_array_equal(RGBA8.from_words(pair).numpy(), view)
    np.testing.assert_array_equal(RGBA8.to_words(view), words)


def test_rgb10a2_pairs_in_range_and_seeded():
    a = inputs.make_pairs(SEEDS[0], 3, 63, 54, CPU, color_bits=10)
    b = inputs.make_pairs(SEEDS[0], 3, 63, 54, CPU, color_bits=10)
    c = inputs.make_pairs(SEEDS[1], 3, 63, 54, CPU, color_bits=10)
    for x, y, z in zip(a, b, c):
        assert x.dtype == torch.int32 and x.shape == (2, 54, 63)
        assert x.is_contiguous()
        assert torch.equal(x, y) and not torch.equal(x, z)
    ch = RGB10A2.from_words(torch.stack(a)).to(torch.int32)
    rgb, alpha = ch[..., :3], ch[..., 3]
    assert int(rgb.min()) == 0 and int(rgb.max()) == 1023
    assert int((rgb > 255).sum()) > rgb.numel() // 2     # the 10-bit scale
    assert sorted(torch.unique(alpha).tolist()) == [0, 1, 2, 3]
    # the 8x8 blocks with noise of +-96 on them: neighbours in a block
    # differ by at most 2 x 96 where neither was clamped
    d = (rgb[:, :, :, 1:8] - rgb[:, :, :, 0:7]).abs()
    assert int(d.max()) <= 192


# --- the judge at 10 bits -------------------------------------------------

W10, H10 = 96, 104


def _config10(family):
    """The deployment at 10 bits and the CPU's size (rs 0.75, radius 0.5:
    both foveation classes)."""
    c = Spec().config(f"{family}_rs075_2244x2492")
    ow, oh = int(W10 / 0.75), int(H10 / 0.75)
    return dict(c, color_bits=10, eye_in_wh=[W10, H10], eye_out_wh=[ow, oh])


@pytest.fixture(scope="module")
def judged10():
    """Per family: the config, one 10-bit pair, its reference through the
    judge, and the port's plain CPU path on the decoded frames, packed."""
    got = {}
    for family in ("fsr", "nis"):
        config = _config10(family)
        pair = inputs.make_pairs(SEEDS[1], 1, W10, H10, CPU,
                                 color_bits=10)[0]
        frames = RGB10A2.from_words(pair)
        out = harness.build_model(config, CPU)(frames)
        assert out.dtype == torch.uint16
        got[family] = (config, pair, frames, out,
                       judge.reference_pair(pair.numpy(), config))
    return got


@pytest.mark.parametrize("family", ["fsr", "nis"])
def test_judge10_reads_what_a_direct_comparison_reads(judged10, family):
    config, pair, frames, out, ref = judged10[family]
    masks = work.inside_masks(config)
    assert 0 < sum(int(m.sum()) for m in masks) < out[..., 0].numel()
    assert ref.dtype == np.uint16 and ref.shape == tuple(out.shape)
    words = RGB10A2.to_words(out).numpy()
    r = judge.compare(words, ref, masks, 10)
    direct = 0
    for eye in (0, 1):
        want = frozen_oracle(frames[eye].numpy(),
                             **judge.oracle_kwargs(config, eye))
        assert want.dtype == np.uint16
        np.testing.assert_array_equal(want, ref[eye])
        direct = max(direct, int(np.abs(
            out[eye].numpy().astype(np.int32) - want.astype(np.int32)).max()))
    assert r["max_lsb"] == direct
    assert r["max_lsb"] == 0 and r["unequal_texels"] == 0


@pytest.mark.parametrize("family", ["fsr", "nis"])
@pytest.mark.parametrize("channel", [1, 3], ids=["g", "alpha"])
def test_judge10_counts_one_lsb_of_the_channel(judged10, family, channel):
    """One texel's G one 10-bit LSB up, or its alpha one 2-bit LSB moved:
    max_lsb 1, one unequal texel."""
    config, _, _, out, ref = judged10[family]
    ch = out.to(torch.int32).clone()
    v = int(ch[1, 40, 50, channel])
    ch[1, 40, 50, channel] = v + 1 if v < RGB10A2.channel_max[channel] \
        else v - 1
    words = RGB10A2.to_words(ch).numpy()
    r = judge.compare(words, ref, work.inside_masks(config), 10)
    assert (r["max_lsb"], r["unequal_texels"]) == (1, 1)


@pytest.mark.parametrize("family", ["fsr", "nis"])
def test_judge10_half_precision_reads_above_0(judged10, family):
    config, _, frames, _, ref = judged10[family]
    half = harness.build_model(config, CPU, precision="half")(frames)
    r = judge.compare(RGB10A2.to_words(half).numpy(), ref,
                      work.inside_masks(config), 10)
    assert r["max_lsb"] > 0


def _worker(config, frame, eye=0):
    h, w = frame.shape[:2]
    head = dict(judge.oracle_kwargs(config, eye), h=h, w=w)
    p = subprocess.run([sys.executable, str(WORKER)],
                       input=json.dumps(head).encode() + b"\n" +
                       frame.tobytes(), capture_output=True, timeout=120)
    assert p.returncode == 0, p.stderr.decode()[-2000:]
    return p.stdout


@pytest.mark.parametrize("bits", [8, 10])
def test_ref_worker_answers_in_the_format(bits):
    config = _config10("fsr") if bits == 10 else dict(
        _config10("fsr"), color_bits=8)
    fmt = texel_format(bits)
    pair = inputs.make_pairs(SEEDS[2], 1, W10, H10, CPU,
                             color_bits=bits)[0].numpy()
    # at 8 bits the eye's bytes as the judge fed them before formats
    frame = (pair.view(np.uint8).reshape(2, H10, W10, 4) if bits == 8
             else fmt.from_words(pair))[0]
    data = _worker(config, frame)
    ow, oh = config["eye_out_wh"]
    assert len(data) == oh * ow * 4 * np.dtype(fmt.dtype).itemsize
    want = frozen_oracle(frame, **judge.oracle_kwargs(config, 0))
    assert want.dtype == fmt.dtype
    assert data == np.ascontiguousarray(want).tobytes()


def test_10bit_deployment_stops_at_the_ports_packed_refusal(monkeypatch):
    """A 10-bit deployment at the cells' geometry (not a cell of
    BENCHMARK.json): the harness makes it 10-bit pairs and gives the judge
    its format, and set-up stops where the port refuses packed planes at
    color_bits 10 (api/pipeline.py). The port's packed R10G10B10A2 path,
    and with it a 10-bit cell, start from here."""
    spec = Spec()
    config = dict(spec.config("fsr_rs075_2244x2492"), color_bits=10,
                  name="fsr_rs075_10bit_2244x2492")
    assert config["name"] not in {c["name"] for c in spec.doc["configs"]}
    cell = Cell("fsr_rs075_10bit_device", config,
                spec.traffic("closed_device"), 1, [], [])
    made = []
    make = inputs.make_pairs

    def spy(*a, **kw):
        pairs = make(*a, **kw)
        made.append((kw.get("color_bits"), pairs))
        return pairs
    monkeypatch.setattr(inputs, "make_pairs", spy)
    with pytest.raises(ValueError, match="packed-u32 frames require "
                                         "color_bits=8"):
        harness.run_cell(cell, SEEDS[0], 1.0, False, spec=spec, device=CPU,
                         t_process=time.perf_counter())
    [(bits, pairs)] = made
    iw, ih = config["eye_in_wh"]
    assert bits == 10 and len(pairs) == 3
    assert pairs[0].shape == (2, ih, iw) and pairs[0].dtype == torch.int32
    ch = RGB10A2.from_words(pairs[0][:, :64, :64]).to(torch.int32)
    assert int(ch[..., :3].max()) > 255 and int(ch[..., 3].max()) <= 3
    assert texel_format(config["color_bits"]) is RGB10A2
