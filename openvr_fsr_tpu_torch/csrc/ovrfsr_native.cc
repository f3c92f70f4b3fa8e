// Native runtime components for openvr_fsr_tpu_torch: the port's copy of
// the JAX package's native/src/ovrfsr_native.cc (ABI 2), every line of
// code unchanged.
//
// The reference ships three native non-compute subsystems that carry real
// weight: a vendored jsoncpp for the comment-tolerant openvr_mod.cfg
// (reference src/jsoncpp.cpp, src/postprocess/Config.cpp), the DirectXTK
// ScreenGrab DDS writer (src/postprocess/ScreenGrab11.cpp), and the
// lazily-managed texture/staging resource pools inside PostProcessor.
// This file provides their equivalents behind a small C ABI consumed via
// ctypes (openvr_fsr_tpu_torch/native_rt.py):
//
//   1. a JSON-with-comments scanner that extracts the "fsr" config object
//      into flat key=value lines (jsoncpp analog, Config.h:10-69 schema),
//   2. an uncompressed RGBA8 / R10G10B10A2 DDS encoder/decoder
//      (ScreenGrab11 analog; format layout per PostProcessor.cpp:63-74),
//   3. a thread-safe frame ring: fixed-slot staging buffers with
//      producer/consumer semantics for streaming benchmarks (the staging
//      resource-pool analog, PostProcessor.cpp:498-561).
//
// Host C++, not CUDA: native_rt.py builds it at first use with
// g++ -O2 -shared -fPIC -std=c++17 -lpthread into the package's _build/
// (kernels/_build.py compiles only csrc/*.cu). No external dependencies.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <condition_variable>
#include <mutex>
#include <string>
#include <vector>

extern "C" {

// ABI version of this library. Bump whenever any exported signature
// changes (e.g. the `cap` parameter added to ovrfsr_ring_pop); the Python
// loader (native_rt.lib) refuses, with an error, to bind a library whose
// version (or absence of this symbol) does not match.
#define OVRFSR_ABI_VERSION 2
int ovrfsr_abi_version(void) { return OVRFSR_ABI_VERSION; }

// ---------------------------------------------------------------------------
// 1. JSON-with-comments config scanner (jsoncpp/Config::Load analog)
// ---------------------------------------------------------------------------
// Strips // and /* */ comments (string-literal aware), locates the "fsr"
// object, and emits "key=value" lines for scalar members plus
// "hotkeys.key=value" for the nested hotkeys object. Returns the number of
// bytes written to `out` (excluding NUL), or -1 on parse failure.

static std::string strip_comments(const char* src) {
  std::string out;
  bool in_str = false, esc = false;
  for (const char* p = src; *p; ++p) {
    if (in_str) {
      out += *p;
      if (esc) esc = false;
      else if (*p == '\\') esc = true;
      else if (*p == '"') in_str = false;
    } else if (*p == '"') {
      in_str = true;
      out += *p;
    } else if (p[0] == '/' && p[1] == '/') {
      while (*p && *p != '\n') ++p;
      if (*p) out += '\n'; else break;
    } else if (p[0] == '/' && p[1] == '*') {
      p += 2;
      while (*p && !(p[0] == '*' && p[1] == '/')) ++p;
      if (*p) ++p; else break;
    } else {
      out += *p;
    }
  }
  return out;
}

static void skip_ws(const char*& p) { while (*p && strchr(" \t\r\n,", *p)) ++p; }

static bool parse_string(const char*& p, std::string& s) {
  if (*p != '"') return false;
  s.clear();
  for (++p; *p && *p != '"'; ++p) {
    if (*p == '\\' && p[1]) { s += p[1]; ++p; } else s += *p;
  }
  if (*p != '"') return false;
  ++p;
  return true;
}

static bool skip_value(const char*& p);  // fwd

static bool emit_object(const char*& p, const std::string& prefix,
                        std::string& out) {
  if (*p != '{') return false;
  ++p;
  while (true) {
    skip_ws(p);
    if (*p == '}') { ++p; return true; }
    std::string key;
    if (!parse_string(p, key)) return false;
    skip_ws(p);
    if (*p != ':') return false;
    ++p;
    skip_ws(p);
    if (*p == '{') {
      if (!emit_object(p, prefix + key + ".", out)) return false;
    } else if (*p == '[') {
      if (!skip_value(p)) return false;  // arrays not in the cfg schema
    } else if (*p == '"') {
      std::string v;
      if (!parse_string(p, v)) return false;
      out += prefix + key + "=" + v + "\n";
    } else {
      const char* start = p;
      while (*p && !strchr(",}\n\r\t ", *p)) ++p;
      out += prefix + key + "=" + std::string(start, p - start) + "\n";
    }
  }
}

static bool skip_value(const char*& p) {
  skip_ws(p);
  if (*p == '{' || *p == '[') {
    char open = *p, close = (*p == '{') ? '}' : ']';
    int depth = 0;
    bool in_str = false, esc = false;
    for (; *p; ++p) {
      if (in_str) {
        if (esc) esc = false;
        else if (*p == '\\') esc = true;
        else if (*p == '"') in_str = false;
      } else if (*p == '"') in_str = true;
      else if (*p == open) ++depth;
      else if (*p == close && --depth == 0) { ++p; return true; }
    }
    return false;
  }
  if (*p == '"') { std::string s; return parse_string(p, s); }
  while (*p && !strchr(",}]\n\r\t ", *p)) ++p;
  return true;
}

int ovrfsr_parse_cfg(const char* text, char* out, int out_cap) {
  std::string clean = strip_comments(text);
  const char* p = clean.c_str();
  skip_ws(p);
  if (*p != '{') return -1;
  ++p;
  std::string result;
  while (true) {
    skip_ws(p);
    if (*p == '}' || !*p) break;
    std::string key;
    if (!parse_string(p, key)) return -1;
    skip_ws(p);
    if (*p != ':') return -1;
    ++p;
    skip_ws(p);
    if (key == "fsr" && *p == '{') {
      if (!emit_object(p, "", result)) return -1;
    } else {
      if (!skip_value(p)) return -1;
    }
  }
  if ((int)result.size() >= out_cap) return -1;
  memcpy(out, result.c_str(), result.size() + 1);
  return (int)result.size();
}

// ---------------------------------------------------------------------------
// 2. DDS encoder/decoder (ScreenGrab11 analog)
// ---------------------------------------------------------------------------
// Uncompressed 32-bit formats only, matching the two output formats the
// pipeline produces (PostProcessor.cpp:63-74): R8G8B8A8 and R10G10B10A2.

#pragma pack(push, 1)
struct DdsHeader {
  uint32_t magic, size, flags, height, width, pitch, depth, mips;
  uint32_t reserved[11];
  uint32_t pf_size, pf_flags, pf_fourcc, pf_bits;
  uint32_t mask_r, mask_g, mask_b, mask_a;
  uint32_t caps, caps2, caps3, caps4, reserved2;
};
#pragma pack(pop)
static_assert(sizeof(DdsHeader) == 128, "DDS header must be 128 bytes");

int ovrfsr_dds_write(const char* path, int width, int height,
                     const uint8_t* data, int color_bits) {
  DdsHeader h;
  memset(&h, 0, sizeof h);
  h.magic = 0x20534444u;  // "DDS "
  h.size = 124;
  h.flags = 0x1 | 0x2 | 0x4 | 0x1000 | 0x8;  // CAPS|HEIGHT|WIDTH|PF|PITCH
  h.height = height;
  h.width = width;
  h.pitch = width * 4;
  h.pf_size = 32;
  h.pf_flags = 0x41;  // DDPF_RGB | DDPF_ALPHAPIXELS
  h.pf_bits = 32;
  if (color_bits == 10) {  // R10G10B10A2_UNORM masks
    h.mask_r = 0x000003FFu; h.mask_g = 0x000FFC00u;
    h.mask_b = 0x3FF00000u; h.mask_a = 0xC0000000u;
  } else {                 // R8G8B8A8_UNORM masks
    h.mask_r = 0x000000FFu; h.mask_g = 0x0000FF00u;
    h.mask_b = 0x00FF0000u; h.mask_a = 0xFF000000u;
  }
  h.caps = 0x1000;
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  size_t n = fwrite(&h, 1, sizeof h, f);
  n += fwrite(data, 1, (size_t)width * height * 4, f);
  fclose(f);
  return n == sizeof h + (size_t)width * height * 4 ? 0 : -1;
}

// Query pass: fills width/height/color_bits; returns payload byte count.
// Only the formats this encoder writes are accepted: uncompressed 32bpp
// DDPF_RGB with the RGBA8 or R10G10B10A2 masks (a fourcc/DX10/compressed or
// non-32bpp header returns -1 rather than decoding garbage), and the
// dimensions are sanity-bounded so a corrupt header cannot drive the
// caller's allocation size.
long ovrfsr_dds_query(const char* path, int* width, int* height,
                      int* color_bits) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  DdsHeader h;
  if (fread(&h, 1, sizeof h, f) != sizeof h || h.magic != 0x20534444u) {
    fclose(f);
    return -1;
  }
  fclose(f);
  const uint32_t kFourCC = 0x4, kRGB = 0x40;  // DDPF_FOURCC, DDPF_RGB
  if ((h.pf_flags & kFourCC) || h.pf_fourcc != 0) return -1;
  if (!(h.pf_flags & kRGB) || h.pf_bits != 32) return -1;
  bool rgba8 = h.mask_r == 0x000000FFu && h.mask_g == 0x0000FF00u &&
               h.mask_b == 0x00FF0000u;
  bool rgb10 = h.mask_r == 0x000003FFu && h.mask_g == 0x000FFC00u &&
               h.mask_b == 0x3FF00000u;
  if (!rgba8 && !rgb10) return -1;
  if (h.width == 0 || h.height == 0 || h.width > 32768 || h.height > 32768)
    return -1;
  *width = (int)h.width;
  *height = (int)h.height;
  *color_bits = rgb10 ? 10 : 8;
  return (long)h.width * h.height * 4;
}

int ovrfsr_dds_read(const char* path, uint8_t* out, long cap) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  if (fseek(f, sizeof(DdsHeader), SEEK_SET) != 0) { fclose(f); return -1; }
  long n = (long)fread(out, 1, cap, f);
  fclose(f);
  return n == cap ? 0 : -1;
}

// ---------------------------------------------------------------------------
// 3. Frame ring (staging resource-pool analog)
// ---------------------------------------------------------------------------
// Fixed-size slots with blocking push/pop — the host-side staging pipeline
// that feeds frames to the device at stream rate (the reference's lazily
// created copy/staging textures, PostProcessor.cpp:196-217, 498-561).

struct FrameRing {
  std::vector<uint8_t> storage;
  std::vector<long> sizes;
  size_t slot_bytes, nslots, head = 0, tail = 0, count = 0;
  uint64_t pushed = 0, popped = 0, dropped = 0;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  bool closed = false;
};

void* ovrfsr_ring_create(long slot_bytes, int nslots) {
  FrameRing* r = new FrameRing();
  r->slot_bytes = (size_t)slot_bytes;
  r->nslots = (size_t)nslots;
  r->storage.resize(r->slot_bytes * r->nslots);
  r->sizes.resize(nslots, 0);
  return r;
}

void ovrfsr_ring_destroy(void* ring) { delete (FrameRing*)ring; }

// blocking=0: returns 1 if pushed, 0 if full (frame dropped — stream mode).
int ovrfsr_ring_push(void* ring, const uint8_t* data, long n, int blocking) {
  FrameRing* r = (FrameRing*)ring;
  std::unique_lock<std::mutex> lk(r->mu);
  if ((size_t)n > r->slot_bytes) return -1;
  if (r->count == r->nslots) {
    if (!blocking) { r->dropped++; return 0; }
    r->cv_push.wait(lk, [&] { return r->count < r->nslots || r->closed; });
    if (r->closed) return -1;
  }
  memcpy(&r->storage[r->head * r->slot_bytes], data, n);
  r->sizes[r->head] = n;
  r->head = (r->head + 1) % r->nslots;
  r->count++;
  r->pushed++;
  r->cv_pop.notify_one();
  return 1;
}

// cap: capacity of `out` in bytes. A queued frame larger than cap returns
// -2 (and stays queued) instead of overflowing the caller's buffer.
long ovrfsr_ring_pop(void* ring, uint8_t* out, long cap, int blocking) {
  FrameRing* r = (FrameRing*)ring;
  std::unique_lock<std::mutex> lk(r->mu);
  if (r->count == 0) {
    if (!blocking) return 0;
    r->cv_pop.wait(lk, [&] { return r->count > 0 || r->closed; });
    if (r->count == 0) return -1;
  }
  long n = r->sizes[r->tail];
  if (n > cap) return -2;
  memcpy(out, &r->storage[r->tail * r->slot_bytes], n);
  r->tail = (r->tail + 1) % r->nslots;
  r->count--;
  r->popped++;
  r->cv_push.notify_one();
  return n;
}

void ovrfsr_ring_close(void* ring) {
  FrameRing* r = (FrameRing*)ring;
  std::lock_guard<std::mutex> lk(r->mu);
  r->closed = true;
  r->cv_push.notify_all();
  r->cv_pop.notify_all();
}

void ovrfsr_ring_stats(void* ring, uint64_t* pushed, uint64_t* popped,
                       uint64_t* dropped, uint64_t* depth) {
  FrameRing* r = (FrameRing*)ring;
  std::lock_guard<std::mutex> lk(r->mu);
  *pushed = r->pushed;
  *popped = r->popped;
  *dropped = r->dropped;
  *depth = r->count;
}

}  // extern "C"
