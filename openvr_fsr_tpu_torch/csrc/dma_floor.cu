// dma_floor.cu — the DMA floor (B7) for Hopper: the least time this card
// needs to move one compute kernel's exact words.
//
// Replaces the TPU kernel openvr_fsr_tpu/kernels/sol.py::build_dma_floor
// (pallas_call at :85): a kernel that moves the device-memory words of one
// compute kernel of the port and computes nothing, so its time is a floor
// under that kernel's on the same card, and vs_sol = floor / kernel <= 1 when
// both are timed together.
//
// What it moves, from the compute kernel's published DMA geometry
// (kernels/_maps.py::dma_geometry), one box per output tile: a tile the
// compute kernel stages (class 1) loads its window; any other tile (class 0)
// loads what the compute kernel's outside pass reads there, its own texels
// (the copy pass of the sharpen-only kernels) or the footprint of its four
// bilinear taps (the upscalers' outside pass). NVScaler's per-output RGBA
// taps lie inside its staged window (kernels/sol.py::check_geometry), so the
// window moves them. Every output word is stored once: the box word at the
// output's tap (the host's box-relative tap tables), which is what the plain
// version (kernels/sol.py::dma_floor_reference) computes.
//
// How, with perfect overlap: one host list of items (b, ty, tx, kind), the
// span items first. Each span item takes a CTA of its own, and persistent
// CTAs (SMs x CTAs per SM) stride over the box items behind them. A box
// item (kind 1: a staging
// tile; kind 0: another tile of the list form) has one thread load its box
// into shared memory by TMA (cp.async.bulk.tensor.3d, one tensor map per
// box shape; a box's rows start and end on 16-byte boundaries, so a window
// loads from its origin rounded down to 4 words), which fills out-of-image
// words with 0 without reading them, into a ring of kStages buffers, each
// completing on its mbarrier: the CTA's next boxes are in flight while a
// tile stores. The threads then gather 4 outputs of one row each from the
// box and store them with one 16-byte store (where the output rows are not
// whole 16-byte units, each warp stores 32 words of a tile row, 128
// coalesced bytes). A span item (kind -n: n neighbouring outside tiles of
// one tile row of the copy form) is a straight copy of its rows, 16 bytes
// per load, a span in one batch: a copy needs no shared memory, and on
// the card a row-major copy of a span moves the same words faster than one
// box per tile in and out. Nothing is computed, so
// only the card's memory system bounds it. TMA takes a row pitch of a
// multiple of 16 bytes; the wrapper refuses any other (kernels/sol.py
// PITCH_WORDS).
//
// Both texel formats run in words: a tile is 32 outputs wide, 32 words of
// RGBA8 texels or 64 words of R10G10B10A2 ones (two words per texel, the
// geometry a 10-bit build publishes, kernels/_maps.py::word_geometry), so
// the kernel is instantiated at both tile widths (TW) and the launch
// dispatches on tile_w. Box origins, widths and the 16-byte alignment are
// all in words, and the floor moves the 10-bit kernel's exact bytes.
//
// The band form (dma_floor_band_kernel) is the floor of a row-band strip of
// B1 or B5 (kernels/_maps.py::band_geometry): the strip kernels run the
// 32-row tiles that overlap the band, and a tile a band edge cuts loads its
// whole window (or its outside footprint over the band's rows) and stores
// only the band's rows. So the geometry's tile grid starts row0 rows above
// the band's first output row: the band form loads each item's box as the
// whole form does and stores grid row gy as output row gy - row0 where
// that is a row of the band. It is instantiated apart, so the whole form's
// SASS stays as it was; a strip's geometry is of the list form (no spans).

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kRun = 4;          // words per 16-byte store
constexpr int kStages = 4;       // boxes in flight per CTA
constexpr int kMaxBox = 256;     // a TMA box's largest extent
constexpr int kAlign = 128;      // a TMA destination's alignment in shared memory
constexpr int kCachedMaps = 16;  // tensor maps kept: two per frame, three ring frames
constexpr uint32_t kMaxPolls = 1u << 26;   // barrier polls before a missing box traps

struct Params {
  uint32_t* out;           // (B, out_h, out_w)
  const int4* tiles;       // (n_tiles,): b, ty, tx, kind (1, 0: the box of that class; -n: a span)
  const int32_t* rel_x;    // (2, tiles_x * TW): per class, each output column's box column
  const int32_t* rel_y;    // (2, tiles_y * tile_h): per class, each output row's box row
  const int32_t* box_x0;   // (2, tiles_x): per class, the box origin per tile column
  const int32_t* box_y0;   // (2, tiles_y): per class, the box origin per tile row
  int n_tiles, tiles_x, tiles_y, tile_h, out_h, out_w;
  int n_spans;             // the leading span items, one CTA each
  int box_w[2], box_h[2];  // per class, the box extent
  int stage_words;         // words per ring buffer
  const uint32_t* img;     // the frame, for the span copies
  int rows, pitch;
  int row0;                // the band form's grid row of output row 0 (else 0)
};

// ---- the asynchronous copy (TMA): the only inline PTX of this file ---------
using BoxMap = CUtensorMap;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// The first kAlign-aligned byte at or after p.
__device__ __forceinline__ uint8_t* align_smem(uint8_t* p) {
  return p + (kAlign - smem_u32(p) % kAlign) % kAlign;
}
__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
// The initialised barriers, visible to the copy engine.
__device__ __forceinline__ void bars_visible() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One thread: load the (x, y, b) box of `map` into dst; its `bytes` (the
// whole box, zero-filled words included) complete the barrier's phase.
__device__ __forceinline__ void box_load(uint32_t* dst, const BoxMap* map, int x, int y, int b,
                                         uint64_t* bar, uint32_t bytes) {
  // the reads of this buffer by the threads (ordered by the barrier before
  // this call) come before the copy engine writes it
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(b), "r"(smem_u32(bar))
      : "memory");
}
// Wait until the barrier's phase of parity `parity` has completed. A box
// that never arrives is a fault: after kMaxPolls polls (seconds) the kernel
// traps, and the launch fails, instead of holding the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == kMaxPolls) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (nothing
// links libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                  : nullptr;
  }();
  return fn;
}

// The map of (bw, bh) boxes over the (batch, h, w) words at img, `pitch`
// words per row and `rows` rows per frame; words outside (h, w) read as 0.
// False if the driver refuses it.
bool encode_box_map(BoxMap* map, const void* img, int batch, int h, int w, int rows, int pitch,
                    int bw, int bh) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(pitch) * 4,
                                 static_cast<cuuint64_t>(rows) * pitch * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(bw), static_cast<cuuint32_t>(bh), 1};
  const cuuint32_t elems[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, const_cast<void*>(img), dims, strides, box,
             elems, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}
// -----------------------------------------------------------------------------

// One thread: start the load of the box of item t into dst.
__device__ __forceinline__ void load_box(const Params& p, int t, uint32_t* dst, uint64_t* bar,
                                         const BoxMap* map0, const BoxMap* map1) {
  const int4 item = p.tiles[t];
  const int c = item.w;
  const int words = c ? p.box_w[1] * p.box_h[1] : p.box_w[0] * p.box_h[0];
  box_load(dst, c ? map1 : map0, p.box_x0[c * p.tiles_x + item.z], p.box_y0[c * p.tiles_y + item.y],
           item.x, bar, static_cast<uint32_t>(words * 4));
}

// All threads: copy the rows of span item (b, ty, tx, -n), 16 bytes per
// load, with plain loads and stores, a whole span of FLOOR_SPAN 32-row
// tiles in one batch (TW / 8 loads in flight per thread: 16 KB at 32-word
// tiles, 32 KB at 64). In turns on the H100 the streaming cache hints read
// slower at both tile widths, and at 64-word tiles a span in two batches of
// 4 loads read slower than the batch of 8: there the sharpen-only kernels'
// copy pass is itself about as fast as a copy, so the floor has no time to
// spare.
template <int TW>
__device__ __forceinline__ void copy_span(const Params& p, int4 item, int tid) {
  const int x0 = item.z * TW, y0 = item.y * p.tile_h;
  const int per_row = (min(-item.w * TW, p.out_w - x0) + kRun - 1) / kRun;
  const int runs = per_row * min(p.tile_h, p.out_h - y0);
  const uint32_t* src = p.img + (static_cast<size_t>(item.x) * p.rows + y0) * p.pitch + x0;
  uint32_t* dst = p.out + (static_cast<size_t>(item.x) * p.out_h + y0) * p.out_w + x0;
  constexpr int kFlight = TW / 8;
  for (int r0 = tid; r0 < runs; r0 += kFlight * kThreads) {
    uint4 v[kFlight];
#pragma unroll
    for (int u = 0; u < kFlight; ++u) {
      const int r = r0 + u * kThreads;
      if (r < runs)
        v[u] = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r / per_row) * p.pitch +
                                               r % per_row * kRun);
    }
#pragma unroll
    for (int u = 0; u < kFlight; ++u) {
      const int r = r0 + u * kThreads;
      if (r < runs)
        *reinterpret_cast<uint4*>(dst + static_cast<size_t>(r / per_row) * p.out_w +
                                  r % per_row * kRun) = v[u];
    }
  }
}

// The floor's items (every thread of a CTA). kBand: the band form of a
// row-band strip's geometry, whose tile grid starts p.row0 rows above the
// first stored output row: a tile loads its box as any other and stores
// only the rows of the band, grid row gy as output row gy - row0 (rel_y
// is per grid row). A strip's geometry is of the list form: no span items.
template <int TW, bool kBand>
__device__ __forceinline__ void floor_items(const BoxMap& map0, const BoxMap& map1, const Params& p) {
  extern __shared__ uint8_t s_dyn[];
  uint8_t* s = align_smem(s_dyn);
  uint64_t* bars = reinterpret_cast<uint64_t*>(s);   // kStages barriers
  uint32_t* bufs = reinterpret_cast<uint32_t*>(s + kAlign);
  const int tid = threadIdx.x;
  if (!kBand && static_cast<int>(blockIdx.x) < p.n_spans) {   // a leading span item
    copy_span<TW>(p, p.tiles[blockIdx.x], tid);
    return;
  }
  // the persistent CTAs: box items blockIdx.x, + stride, ... from n_spans on
  const int stride = gridDim.x - p.n_spans;

  // thread 0: the next of this CTA's items to load, and the boxes issued;
  // the items take the ring's buffers in their order
  int to_load = blockIdx.x, issued = 0;
  auto load_next = [&]() {
    if (to_load >= p.n_tiles) return;
    const int slot = issued++ % kStages;
    load_box(p, to_load, bufs + slot * p.stage_words, &bars[slot], &map0, &map1);
    to_load += stride;
  };
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) bar_init(&bars[i]);
    bars_visible();
    for (int i = 0; i < kStages; ++i) load_next();
  }
  __syncthreads();

  const bool vec = p.out_w % kRun == 0;   // whole 16-byte output runs
  int used = 0;                           // items done
  for (int t = blockIdx.x; t < p.n_tiles; t += stride) {
    const int4 item = p.tiles[t];
    const int stage = used % kStages;
    uint32_t* buf = bufs + stage * p.stage_words;
    const int c = item.w, bw = c ? p.box_w[1] : p.box_w[0];
    const int32_t* rel_x = p.rel_x + c * p.tiles_x * TW;
    const int32_t* rel_y = p.rel_y + c * p.tiles_y * p.tile_h;
    uint32_t* out = p.out + static_cast<size_t>(item.x) * p.out_h * p.out_w;
    bar_wait(&bars[stage], (used / kStages) & 1);
    if (vec) {   // runs of 4 outputs of one row, one 16-byte store each
      for (int r = tid; r < TW / kRun * p.tile_h; r += kThreads) {
        const int gy = item.y * p.tile_h + r / (TW / kRun);
        const int oy = kBand ? gy - p.row0 : gy;
        const int ox = item.z * TW + r % (TW / kRun) * kRun;
        const int4 rx = *reinterpret_cast<const int4*>(rel_x + ox);
        const uint32_t* row = buf + rel_y[gy] * bw;
        const uint4 v = make_uint4(row[rx.x], row[rx.y], row[rx.z], row[rx.w]);
        if ((!kBand || oy >= 0) && oy < p.out_h && ox < p.out_w)
          *reinterpret_cast<uint4*>(out + static_cast<size_t>(oy) * p.out_w + ox) = v;
      }
    } else {     // TW threads per tile row: coalesced 4-byte stores
      const int ox = item.z * TW + tid % TW, rx = rel_x[ox];
      for (int r = tid / TW; r < p.tile_h; r += kThreads / TW) {
        const int gy = item.y * p.tile_h + r;
        const int oy = kBand ? gy - p.row0 : gy;
        const uint32_t v = buf[rel_y[gy] * bw + rx];
        if ((!kBand || oy >= 0) && oy < p.out_h && ox < p.out_w)
          out[static_cast<size_t>(oy) * p.out_w + ox] = v;
      }
    }
    ++used;
    // every thread is done with this buffer, and none runs a ring ahead
    __syncthreads();
    if (tid == 0) load_next();
  }
}

template <int TW>
__global__ void __launch_bounds__(kThreads) dma_floor_kernel(const __grid_constant__ BoxMap map0,
                                                             const __grid_constant__ BoxMap map1,
                                                             const Params p) {
  floor_items<TW, false>(map0, map1, p);
}
template <int TW>
__global__ void __launch_bounds__(kThreads)
    dma_floor_band_kernel(const __grid_constant__ BoxMap map0, const __grid_constant__ BoxMap map1,
                          const Params p) {
  floor_items<TW, true>(map0, map1, p);
}

struct MapKey {
  const void* img;
  int batch, h, w, rows, pitch, bw, bh;
  bool operator==(const MapKey& o) const {
    return img == o.img && batch == o.batch && h == o.h && w == o.w && rows == o.rows &&
           pitch == o.pitch && bw == o.bw && bh == o.bh;
  }
};

// One tensor map per frame pointer and box shape, encoded once: the bench's
// three ring frames rotate, each with its two box shapes.
bool cached_map(const MapKey& key, BoxMap* map) {
  static std::mutex mutex;
  static MapKey keys[kCachedMaps];
  static BoxMap maps[kCachedMaps];
  static int used = 0, next = 0;
  const std::lock_guard<std::mutex> lock(mutex);
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) {
      *map = maps[i];
      return true;
    }
  if (!encode_box_map(map, key.img, key.batch, key.h, key.w, key.rows, key.pitch, key.bw, key.bh))
    return false;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % kCachedMaps;
  used = used < kCachedMaps ? used + 1 : used;
  return true;
}

// The persistent grid of the TW-word-tile kernel (kBand: its band form):
// SMs x the CTAs of `smem` bytes one SM holds, for the current device
// (kept for the last device and size asked).
template <int TW, bool kBand>
int grid_ctas(size_t smem) {
  static std::mutex mutex;
  static int last_dev = -1, last_ctas = 0;
  static size_t last_smem = 0;
  const void* kernel = kBand ? reinterpret_cast<const void*>(dma_floor_band_kernel<TW>)
                             : reinterpret_cast<const void*>(dma_floor_kernel<TW>);
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const std::lock_guard<std::mutex> lock(mutex);
  if (dev == last_dev && smem == last_smem) return last_ctas;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem) !=
          cudaSuccess)
    return 0;
  last_dev = dev;
  last_smem = smem;
  last_ctas = sms * per_sm;
  return last_ctas;
}

bool box_ok(int bw, int bh) { return bw >= 4 && bw % 4 == 0 && bw <= kMaxBox && bh >= 1 && bh <= kMaxBox; }

// The launch of the TW-word-tile kernel (kBand: its band form): the span
// items' CTAs, then the persistent CTAs over the box items.
template <int TW, bool kBand>
int launch_tiles(const BoxMap& map0, const BoxMap& map1, const Params& p, size_t smem,
                 cudaStream_t stream) {
  const int ctas = grid_ctas<TW, kBand>(smem), boxes = p.n_tiles - p.n_spans;
  if (ctas <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = p.n_spans + (boxes < ctas ? boxes : ctas);
  if (kBand)
    dma_floor_band_kernel<TW><<<grid, kThreads, smem, stream>>>(map0, map1, p);
  else
    dma_floor_kernel<TW><<<grid, kThreads, smem, stream>>>(map0, map1, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the launch's cudaError_t (0 = launched). The
// caller (kernels/sol.py) has built the tables from a checked geometry: the
// item list covers every (b, ty, tx) once, its first n_spans items are the
// span items, every output's tap lies in its box, and span items are whole
// outside tiles of the copy form whose output rows are whole 16-byte units.
// img must be 16-byte aligned with a pitch of a multiple of 4 words; each
// box is at most 256 x 256 words, its width a multiple of 4, and its column
// origin too; tile_w must be 32 (RGBA8) or 64 (R10G10B10A2) words. row0 > 0
// launches the band form: out_h output rows from row row0 of a grid of
// ceil((row0 + out_h) / tile_h) tile rows, rel_y per grid row, and no span
// items; row0 0 the whole form.
extern "C" int dma_floor_launch(const void* img, void* out, const void* tiles, int n_tiles,
                                int n_spans, const void* rel_x, const void* rel_y, const void* box_x0,
                                const void* box_y0, int batch, int in_h, int in_w, int rows,
                                int pitch, int out_h, int out_w, int tile_w, int tile_h, int box_w0,
                                int box_h0, int box_w1, int box_h1, int row0, void* stream) {
  if (n_tiles <= 0 || n_spans < 0 || n_spans > n_tiles || batch <= 0 || in_h <= 0 || in_w <= 0 || out_h <= 0 || out_w <= 0 ||
      in_h > rows || in_w > pitch || pitch % 4 != 0 || reinterpret_cast<uintptr_t>(img) % 16 != 0 ||
      (tile_w != 32 && tile_w != 64) || tile_h < 1 || tile_h > kMaxBox || !box_ok(box_w0, box_h0) ||
      !box_ok(box_w1, box_h1) || row0 < 0 || row0 >= tile_h || (row0 > 0 && n_spans > 0))
    return static_cast<int>(cudaErrorInvalidValue);
  BoxMap map0, map1;
  if (!cached_map({img, batch, in_h, in_w, rows, pitch, box_w0, box_h0}, &map0) ||
      !cached_map({img, batch, in_h, in_w, rows, pitch, box_w1, box_h1}, &map1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.out = static_cast<uint32_t*>(out);
  p.tiles = static_cast<const int4*>(tiles);
  p.rel_x = static_cast<const int32_t*>(rel_x);
  p.rel_y = static_cast<const int32_t*>(rel_y);
  p.box_x0 = static_cast<const int32_t*>(box_x0);
  p.box_y0 = static_cast<const int32_t*>(box_y0);
  p.n_tiles = n_tiles;
  p.n_spans = n_spans;
  p.tiles_x = (out_w + tile_w - 1) / tile_w;
  p.tiles_y = (row0 + out_h + tile_h - 1) / tile_h;
  p.tile_h = tile_h;
  p.out_h = out_h;
  p.out_w = out_w;
  p.box_w[0] = box_w0;
  p.box_h[0] = box_h0;
  p.box_w[1] = box_w1;
  p.box_h[1] = box_h1;
  p.img = static_cast<const uint32_t*>(img);
  p.rows = rows;
  p.pitch = pitch;
  p.row0 = row0;
  const int words = box_w0 * box_h0 > box_w1 * box_h1 ? box_w0 * box_h0 : box_w1 * box_h1;
  p.stage_words = (words + kAlign / 4 - 1) / (kAlign / 4) * (kAlign / 4);
  // the barriers, the ring, and the slack that aligns them
  const size_t smem = kAlign + static_cast<size_t>(kStages) * p.stage_words * 4 + kAlign;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row0 > 0)
    return tile_w == 64 ? launch_tiles<64, true>(map0, map1, p, smem, s)
                        : launch_tiles<32, true>(map0, map1, p, smem, s);
  return tile_w == 64 ? launch_tiles<64, false>(map0, map1, p, smem, s)
                      : launch_tiles<32, false>(map0, map1, p, smem, s);
}
