// Inverse transform of one residual bucket, in one launch: the compact
// coefficients expanded, the row pass, the intermediate round and clip,
// the column pass, and the result clip-added onto a plane, written raw
// into one, or written out as (B, h, w) residuals.
//
// Replaces dav1d_mirror_tpu/ops/itx.py::_residual_multi_core (:116) and
// ::_residual_core's WHT branch (:39-47), with the sparse expand and the
// clip-add scatter around them (dav1d_mirror_tpu/models/frame_exec.py:94,
// :103, :626-645, ops/mc_tpu.py:292). On the TPU these were no Pallas
// kernel: XLA fused each (tx size, bit depth) into one program. Its plain
// PyTorch version is dav1d_mirror_tpu_torch/ops/itx.py::itx_bucket.
//
// Per block of tx size w x h (sw = min(w, 32), sh = min(h, 32)):
//   c[y][x]  = vals[k] at pos[k] = y * sw + x (pos clamped to [0, S],
//              S = sh * sw dropped); rect2 (w = 2h or h = 2w):
//              c = (c * 181 + 128) >> 8; WHT: c = c >> 2
//   row pass: each of the sh rows through the block's row family
//             (row_sel into itx_families(w)), butterflies clipped to
//             [row_min, row_max]; then t = clip((t + rnd) >> shift,
//             col_min, col_max) (WHT: iwht4, nothing else)
//   col pass: each of the w columns (sh inputs) through the column family,
//             clipped to [col_min, col_max]; r = (r + 8) >> 4 (WHT: iwht4)
//   add:  plane[ys + y][xs + x] = clip(plane + r, 0, 2^bd - 1)
//   raw:  plane[ys + y][xs + x] = r, cast to the plane's type
//   hres: out[b][y][x] = r, cast to int16 or int32
// Elements outside the plane (pad rows at PAD_OOB, units cut by the
// plane's edge) are neither read nor written. The 1-D functions are
// generated from ops/itx_1d.py (itx_1d.cuh, tools/gen_itx_cuh.py), so the
// arithmetic is the plain path's, int32 wrap included.
//
// Bound on the H100: bytes, at the published rates. A block reads its K
// coefficients and positions (8 bytes a lane, K = 16 on the sparse
// buckets), selectors and origin, and reads and writes its w x h pixels
// (int32 planes in the executor: 8 bytes a pixel, 8 KB for 32x32); it
// runs sh + w lines of 8-1289 integer operations (a 32x32 DCT block: 64
// lines of 570, ~42 K operations with the roundings), a quarter of the
// byte time at 67 T/s. At the decode's buckets (tens to a few thousand
// blocks, a fraction of one wave of CTAs) the launch floor weighs as
// much as either.
//
// Design, simple first: one thread per line, the block's tile in shared
// memory. A CTA holds G = max(1, 64 / T) tx blocks of T = max(sh, w)
// threads each, so a 4x4 bucket still runs 64 threads a CTA. The tile is
// sh x (w + 1) int32 (at most 32 x 65: 8.3 KB; the odd row stride keeps
// the row pass's strided reads off one bank). A thread loads its line
// into registers, runs the generated straight-line function (the switch
// on the family is uniform within a tx block), and stores its line; the
// column pass's thread writes its column of the unit, so a warp's stores
// of one output row are contiguous. No atomics: the units of a bucket
// are disjoint and pad rows lie off the plane. The kernel allocates
// nothing; the wrapper (ops/itx_cuda.py) allocates the hres output.
#include <cuda_runtime.h>
#include <stdint.h>

#include "itx_1d.cuh"

enum { MODE_ADD = 0, MODE_RAW = 1, MODE_HRES = 2 };
enum { DST_I32 = 0, DST_I16 = 1, DST_U8 = 2 };

struct ItxArgs {
    const int32_t* vals;     // (B, K)
    const int32_t* pos;      // (B, K), or null: lane k at position k
    const int32_t* row_sel;  // (B,), or null: row_fix for every block
    const int32_t* col_sel;  // (B,), or null: col_fix for every block
    const int32_t* ys;       // (B,) unit origins (add, raw)
    const int32_t* xs;
    void* dst;               // (H, W) plane, or (B, h, w) residuals
    int K, row_fix, col_fix, dst_kind, H, W, B, mode;
    int row_min, row_max, col_min, col_max, pix_max;
};

template <int N>
__device__ __forceinline__ void itx_line(int fam, const int32_t* in,
                                         int32_t* out, int32_t mn,
                                         int32_t mx);
#define ITX_LINE(N)                                                        \
    template <>                                                            \
    __device__ __forceinline__ void itx_line<N>(                           \
        int fam, const int32_t* in, int32_t* out, int32_t mn, int32_t mx) { \
        itx_line_##N(fam, in, out, mn, mx);                                \
    }
ITX_LINE(4)
ITX_LINE(8)
ITX_LINE(16)
ITX_LINE(32)
ITX_LINE(64)
#undef ITX_LINE

__device__ __forceinline__ int32_t load_px(const void* p, int kind,
                                           size_t i) {
    if (kind == DST_U8) return ((const uint8_t*)p)[i];
    if (kind == DST_I16) return ((const int16_t*)p)[i];
    return ((const int32_t*)p)[i];
}

__device__ __forceinline__ void store_px(void* p, int kind, size_t i,
                                         int32_t v) {
    if (kind == DST_U8)
        ((uint8_t*)p)[i] = (uint8_t)v;
    else if (kind == DST_I16)
        ((int16_t*)p)[i] = (int16_t)v;
    else
        ((int32_t*)p)[i] = v;
}

template <int TW, int TH>
struct Geom {
    static constexpr int SW = TW < 32 ? TW : 32;
    static constexpr int SH = TH < 32 ? TH : 32;
    static constexpr int T = SH > TW ? SH : TW;   // threads a tx block
    static constexpr int G = T >= 64 ? 1 : 64 / T;  // tx blocks a CTA
    static constexpr int STRIDE = TW + 1;
    static constexpr int TILE = SH * STRIDE;
};

template <int TW, int TH, int SHIFT, bool WHT, int NT>
__global__ void __launch_bounds__(NT) itx_kernel(const ItxArgs a) {
    using Gm = Geom<TW, TH>;
    static_assert(NT == Gm::G * Gm::T, "threads a CTA");
    constexpr int SW = Gm::SW, SH = Gm::SH, T = Gm::T, G = Gm::G;
    constexpr int STRIDE = Gm::STRIDE, S = SH * SW;
    constexpr bool RECT2 = TW * 2 == TH || TH * 2 == TW;
    constexpr int RND = (1 << SHIFT) >> 1;
    __shared__ int32_t tile[G * Gm::TILE];

    const int g = threadIdx.x / T;
    const int t = threadIdx.x % T;
    const int b = blockIdx.x * G + g;
    const bool live = b < a.B;
    int32_t* my = tile + g * Gm::TILE;

    for (int i = threadIdx.x; i < G * Gm::TILE; i += G * T) tile[i] = 0;
    __syncthreads();

    // the coefficients, scattered into the tile (with the prescale,
    // which leaves the zeros zero)
    if (live) {
        const size_t base = (size_t)b * a.K;
        for (int k = t; k < a.K; k += T) {
            int p = a.pos ? a.pos[base + k] : k;
            p = min(max(p, 0), S);
            if (p < S) {
                int32_t c = a.vals[base + k];
                if constexpr (WHT)
                    c = itx_shr(c, 2);
                else if constexpr (RECT2)
                    c = itx_shr(itx_add(itx_mul(c, 181), 128), 8);
                my[(p / SW) * STRIDE + p % SW] = c;
            }
        }
    }
    __syncthreads();

    // row pass: thread t transforms row t in place
    if (live && t < SH) {
        int32_t in[SW], out[TW];
#pragma unroll
        for (int k = 0; k < SW; k++) in[k] = my[t * STRIDE + k];
        if constexpr (WHT)
            itx_wht_4(in, out, 0, 0);
        else
            itx_line<TW>(a.row_sel ? a.row_sel[b] : a.row_fix, in, out,
                         a.row_min, a.row_max);
#pragma unroll
        for (int x = 0; x < TW; x++) {
            int32_t v = out[x];
            if constexpr (!WHT)
                v = itx_clip(itx_shr(itx_add(v, RND), SHIFT), a.col_min,
                             a.col_max);
            my[t * STRIDE + x] = v;
        }
    }
    __syncthreads();

    // column pass: thread t transforms column t and writes it out
    if (live && t < TW) {
        int32_t in[SH], out[TH];
#pragma unroll
        for (int k = 0; k < SH; k++) in[k] = my[k * STRIDE + t];
        if constexpr (WHT)
            itx_wht_4(in, out, 0, 0);
        else
            itx_line<TH>(a.col_sel ? a.col_sel[b] : a.col_fix, in, out,
                         a.col_min, a.col_max);
        if constexpr (!WHT) {   // the final rounding
#pragma unroll
            for (int y = 0; y < TH; y++)
                out[y] = itx_shr(itx_add(out[y], 8), 4);
        }
        if (a.mode == MODE_HRES) {
            const size_t o = (size_t)b * TH * TW + t;
#pragma unroll
            for (int y = 0; y < TH; y++)
                store_px(a.dst, a.dst_kind, o + (size_t)y * TW, out[y]);
        } else {
            const int32_t y0 = a.ys[b];
            const int32_t x = itx_add(a.xs[b], t);
            if (x >= 0 && x < a.W) {
#pragma unroll
                for (int y = 0; y < TH; y++) {
                    const int32_t yy = itx_add(y0, y);
                    if (yy < 0 || yy >= a.H) continue;
                    int32_t r = out[y];
                    const size_t i = (size_t)yy * a.W + x;
                    if (a.mode == MODE_ADD)
                        r = min(max(itx_add(load_px(a.dst, a.dst_kind, i), r),
                                    0), a.pix_max);
                    store_px(a.dst, a.dst_kind, i, r);
                }
            }
        }
    }
}

template <int TW, int TH, int SHIFT, bool WHT>
static int launch(const ItxArgs& a, cudaStream_t stream) {
    using Gm = Geom<TW, TH>;
    const int grid = (a.B + Gm::G - 1) / Gm::G;
    constexpr int NT = Gm::G * Gm::T;
    itx_kernel<TW, TH, SHIFT, WHT, NT><<<grid, NT, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

// tx: the TX_INFO index of ops/itx_meta.py (w, h, shift); wht only at 0
extern "C" int itx_launch(const void* vals, const void* pos,
                          const void* row_sel, const void* col_sel,
                          const void* ys, const void* xs, void* dst, int K,
                          int row_fix, int col_fix, int dst_kind, int H,
                          int W, int B, int tx, int mode, int wht,
                          int row_min, int row_max, int col_min,
                          int col_max, int pix_max, void* stream) {
    ItxArgs a;
    a.vals = (const int32_t*)vals;
    a.pos = (const int32_t*)pos;
    a.row_sel = (const int32_t*)row_sel;
    a.col_sel = (const int32_t*)col_sel;
    a.ys = (const int32_t*)ys;
    a.xs = (const int32_t*)xs;
    a.dst = dst;
    a.K = K;
    a.row_fix = row_fix;
    a.col_fix = col_fix;
    a.dst_kind = dst_kind;
    a.H = H;
    a.W = W;
    a.B = B;
    a.mode = mode;
    a.row_min = row_min;
    a.row_max = row_max;
    a.col_min = col_min;
    a.col_max = col_max;
    a.pix_max = pix_max;
    cudaStream_t s = (cudaStream_t)stream;
    if (wht) return tx == 0 ? launch<4, 4, 0, true>(a, s)
                            : (int)cudaErrorInvalidValue;
    switch (tx) {
    case 0: return launch<4, 4, 0, false>(a, s);
    case 1: return launch<8, 8, 1, false>(a, s);
    case 2: return launch<16, 16, 2, false>(a, s);
    case 3: return launch<32, 32, 2, false>(a, s);
    case 4: return launch<64, 64, 2, false>(a, s);
    case 5: return launch<4, 8, 0, false>(a, s);
    case 6: return launch<8, 4, 0, false>(a, s);
    case 7: return launch<8, 16, 1, false>(a, s);
    case 8: return launch<16, 8, 1, false>(a, s);
    case 9: return launch<16, 32, 1, false>(a, s);
    case 10: return launch<32, 16, 1, false>(a, s);
    case 11: return launch<32, 64, 1, false>(a, s);
    case 12: return launch<64, 32, 1, false>(a, s);
    case 13: return launch<4, 16, 1, false>(a, s);
    case 14: return launch<16, 4, 1, false>(a, s);
    case 15: return launch<8, 32, 2, false>(a, s);
    case 16: return launch<32, 8, 2, false>(a, s);
    case 17: return launch<16, 64, 2, false>(a, s);
    case 18: return launch<64, 16, 2, false>(a, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* itx_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
