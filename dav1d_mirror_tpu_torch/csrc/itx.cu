// Inverse transform of a work list of residual buckets, in one launch:
// for each table entry (one bucket), the compact coefficients
// expanded, the row pass, the intermediate round and clip, the column
// pass, and the result clip-added onto a plane, written raw into one, or
// written out as (B, h, w) residuals into one flat output.
//
// Replaces dav1d_mirror_tpu/ops/itx.py::_residual_multi_core (:116) and
// ::_residual_core's WHT branch (:39-47), with the sparse expand and the
// clip-add scatter around them (dav1d_mirror_tpu/models/frame_exec.py:94,
// :103, :626-645, ops/mc_tpu.py:292). On the TPU these were no Pallas
// kernel: XLA fused each (tx size, bit depth) into one program. Its plain
// PyTorch version is dav1d_mirror_tpu_torch/ops/itx.py::itx_run (one
// ops/itx.itx_bucket per entry).
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
//   hres: out[hres_off + b * h * w + y * w + x] = r, as int16 or int32
// Elements outside the plane (units cut by the plane's edge) are neither
// read nor written. The 1-D functions are generated from ops/itx_1d.py
// (itx_1d.cuh, tools/gen_itx_cuh.py), so the arithmetic is the plain
// path's, int32 wrap included (done in uint32_t).
//
// The work list (ops/itx.py builds it; the planner emits it into the
// frame's int32 descriptor buffer): ENTRY ints an entry (tx size, flags,
// plane, K, B, real rows, the offsets of vals, pos, selectors, ys, xs and
// of the hres output, the entry's first work item), then the map from
// work item to entry. A work item is G tx blocks of one entry (G =
// TX_BLOCKS_PER_CTA[tx]), run by one CTA of CTA_THREADS threads; the map
// puts the longest items first (64-point lines, then 32-point, then the
// most coefficients), so that they start in the first wave and the short
// ones fill in behind them. The grid is at most a fixed multiple of the
// SM count and walks the work items with a static stride. One kernel
// takes every tx size, bound to two CTAs an SM: with three, ptxas spills
// the 64-point sizes' lines; a kernel of their own would be a second
// launch behind the first on the stream.
//
// Bound on the H100: bytes, at the published rates. A run reads each real
// block's K coefficients and positions (2 or 4 bytes each), selectors
// and origin once, and reads (add) and writes its pixels inside the plane
// once (int32 planes in the executor: 8 bytes a pixel for add); at 3.35
// TB/s that is 0.3 us for 128 32x32 blocks. Its integer operations (the
// generated lines the data needs: nonzero rows, zero-tail variants) come
// to a fifth of that or less at 67 T/s. What holds it is latency: a
// thread runs one line's dependent chain (78 to 1289 operations), a run
// of a 1080p frame has a few hundred work items (fewer warps than the
// card holds), and each item waits on its chain of loads (map, entry,
// coefficients, pixels). tools/itx_phases.py times each phase. One launch
// a run (a few thousand blocks) in place of one a bucket (the launch
// floor, ~2 us, weighed more than a bucket's bound), and these, are what
// the design does about it:
//   - a real block's first coefficient lanes (EXPAND of them a thread)
//     are loaded before its tile is zeroed and its origin is known;
//   - the expand writes the block's tile in shared memory (sh x (w + 1)
//     int32, the odd stride keeps the row pass's strided reads off one
//     bank); each row's last nonzero column is read back from the tile;
//   - the row pass runs only the nonzero rows (a zero row stays zero
//     through every family and the rounding), through the zero-tail
//     variant that covers the warp's last nonzero column;
//   - the column pass runs the variant that covers the block's last
//     nonzero row (uniform in the block: a ballot in the warp that holds
//     the block's row threads, kept in shared memory);
//   - clip-add onto an int32 plane (the executor's): the block's pixels
//     are copied into shared memory with cp.async while it is
//     transformed, so the write-out does not wait on them (other planes:
//     ROWS_IN_FLIGHT loads a thread, then their stores);
//   - rows past an entry's real rows and blocks wholly outside the plane
//     do no work (an hres pad row writes its zeros).
// One thread a line: thread t of a block transforms row t, then column
// t, which it writes out, so a warp's stores of one output row are
// contiguous. Coefficients, positions, selectors and origins are read in
// place from the descriptor buffers (int16 or int32, as the entry says).
// No atomics: the blocks of a run are disjoint on each plane (transform
// blocks tile a plane), pad rows are off it, and each hres entry has its
// own range; the result is the same for any CTA order. The kernel
// allocates nothing: the wrapper (ops/itx_cuda.py) allocates the hres
// output. Each launch returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include "itx_1d.cuh"

enum { MODE_ADD = 0, MODE_RAW = 1, MODE_HRES = 2 };
enum { DST_I32 = 0, DST_I16 = 1, DST_U8 = 2 };
// the fields of a table entry (ops/itx.py E_*)
enum {
    E_TX, E_FLAGS, E_PLANE, E_K, E_B, E_NREAL, E_VALS, E_POS, E_RSEL,
    E_CSEL, E_YS, E_XS, E_HRES, E_CTA0, E_SPARE0, E_SPARE1, ENTRY
};
// E_FLAGS bits (ops/itx.py F_*): WHT; vals, pos in the int16 buffer; no
// pos (dense vals); E_RSEL/E_CSEL are the families themselves
enum { F_WHT = 1, F_VALS16 = 2, F_POS16 = 4, F_DENSE = 8, F_FIXED = 16 };
// base pointers that entry offsets count from (ops/itx_cuda.py)
enum { B_VALS32, B_VALS16, B_POS32, B_POS16, B_RSEL, B_CSEL, B_YS, B_XS,
       N_BASES };
constexpr int MAX_PLANES = 3;
constexpr int CTA_THREADS = 128;
constexpr int EXPAND = 8;   // coefficient loads a thread has in flight
constexpr int ROWS_IN_FLIGHT = 8;  // pixel loads a thread has in flight

// tx size index of ops/itx_meta.TX_INFO -> (w, h, shift)
constexpr int TX_W[19] = {4, 8, 16, 32, 64, 4, 8, 8, 16, 16,
                          32, 32, 64, 4, 16, 8, 32, 16, 64};
constexpr int TX_H[19] = {4, 8, 16, 32, 64, 8, 4, 16, 8, 32,
                          16, 64, 32, 16, 4, 32, 8, 64, 16};
constexpr int TX_SHIFT[19] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1,
                              1, 1, 1, 1, 1, 2, 2, 2, 2};
// tx blocks a CTA (G), each of CTA_THREADS / G threads: one a row and one
// a column (ops/itx.cta_geometry)
constexpr int TX_BLOCKS_PER_CTA[19] = {32, 16, 8, 4, 2, 16, 16, 8, 8, 4,
                                       4, 4, 2, 8, 8, 4, 4, 4, 2};

template <int TX>
struct Geom {
    static constexpr int TW = TX_W[TX], TH = TX_H[TX];
    static constexpr int SHIFT = TX_SHIFT[TX];
    static constexpr int SW = TW < 32 ? TW : 32;
    static constexpr int SH = TH < 32 ? TH : 32;
    static constexpr int G = TX_BLOCKS_PER_CTA[TX];
    static constexpr int T = CTA_THREADS / G;   // threads a tx block
    static constexpr int STRIDE = TW + 1;
    static constexpr int TILE = SH * STRIDE;
    static_assert(G * T == CTA_THREADS, "G divides the CTA");
    static_assert(T == (SH > TW ? SH : TW), "a thread a row and a column");
};

// the largest G coefficient tiles (rounded to 16 bytes: zeroed as int4)
// and the largest G destination units (w x h each) of any tx size
constexpr int smem_ints(bool units) {
    int m = 0;
    for (int tx = 0; tx < 19; tx++) {
        const int sh = TX_H[tx] < 32 ? TX_H[tx] : 32;
        const int v = TX_BLOCKS_PER_CTA[tx] *
                      (units ? TX_H[tx] * TX_W[tx] : sh * (TX_W[tx] + 1));
        m = v > m ? v : m;
    }
    return (m + 3) & ~3;
}
constexpr int TILE_INTS = smem_ints(false);
constexpr int UNIT_INTS = smem_ints(true);
constexpr size_t SMEM_BYTES = (size_t)(TILE_INTS + UNIT_INTS) * 4;

struct ItxRunArgs {
    const int32_t* tab;   // entries (ENTRY ints each), or null: `one`
    const int32_t* map;   // work item -> entry, or null: entry 0
    const void* base[N_BASES];
    void* dst[MAX_PLANES];  // (H, W) planes (add, raw)
    void* hres;             // the flat hres output
    int n_work, mode, hres_kind;
    int H[MAX_PLANES], W[MAX_PLANES], kind[MAX_PLANES];
    int row_min, row_max, col_min, col_max, pix_max;
    int one[ENTRY];         // the entry of a one-entry list (tab null)
};

template <int V>
struct Int {
    static constexpr int value = V;
};

template <int N>
__device__ __forceinline__ void itx_line_tail(int fam, int m,
                                              const int32_t* in,
                                              int32_t* out, int32_t mn,
                                              int32_t mx);
#define ITX_LINE(N)                                                      \
    template <>                                                          \
    __device__ __forceinline__ void itx_line_tail<N>(                    \
        int fam, int m, const int32_t* in, int32_t* out, int32_t mn,     \
        int32_t mx) {                                                    \
        itx_line_##N##_tail(fam, m, in, out, mn, mx);                    \
    }
ITX_LINE(4)
ITX_LINE(8)
ITX_LINE(16)
ITX_LINE(32)
ITX_LINE(64)
#undef ITX_LINE

// f(Int<m>) for the variant of a line of length N that `need` live
// inputs select (itx_tail_inputs), m a compile-time constant in each call
template <int N, class F>
__device__ __forceinline__ void with_tail(int need, F&& f) {
    constexpr int NIN = N < 32 ? N : 32;
    const int m = itx_tail_inputs(need, N);
    if constexpr (4 < NIN) {
        if (m == 4) return f(Int<4>{});
    }
    if constexpr (8 < NIN) {
        if (m == 8) return f(Int<8>{});
    }
    if constexpr (16 < NIN) {
        if (m == 16) return f(Int<16>{});
    }
    f(Int<NIN>{});
}

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

// a coefficient, position or selector: int32, or int16 where `narrow`
__device__ __forceinline__ int32_t load_desc(const void* base32,
                                             const void* base16,
                                             bool narrow, size_t i) {
    return narrow ? (int32_t)((const int16_t*)base16)[i]
                  : ((const int32_t*)base32)[i];
}

// a 4-byte copy from device memory into shared memory that completes in
// the background (sm_80+), and the wait for this thread's copies
__device__ __forceinline__ void cp_async4(int32_t* smem, const int32_t* g) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(g));
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                     : "memory");
}

#ifdef ITX_PHASES
// tools/itx_phases.py builds with -DITX_PHASES: a globaltimer stamp at
// each phase boundary of each work item (slot k of 8: 0 before its entry
// is read, 1 after, 2 tile zeroed, 3 expanded, 4 row pass, 5 column pass,
// 6 written)
constexpr int ITX_PHASE_ITEMS = 16384;
__device__ unsigned long long itx_phase_ns[ITX_PHASE_ITEMS * 8];
#define ITX_STAMP(w, k)                                                    \
    do {                                                                   \
        if (threadIdx.x == 0 && (w) < ITX_PHASE_ITEMS) {                   \
            unsigned long long ts_;                                        \
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ts_));        \
            itx_phase_ns[(size_t)(w) * 8 + (k)] = ts_;                     \
        }                                                                  \
    } while (0)
extern "C" int itx_phase_read(unsigned long long* out, int n_items) {
    return (int)cudaMemcpyFromSymbol(
        out, itx_phase_ns, sizeof(unsigned long long) * 8 * n_items);
}
#else
#define ITX_STAMP(w, k)
#endif

struct Ent {
    int tx, flags, plane, K, B, n_real, vals, pos, rsel, csel, ys, xs,
        hres, cta0;
};

__device__ __forceinline__ Ent load_entry(const ItxRunArgs& a, int e) {
    auto f = [&](int i) {
        return a.tab ? a.tab[(size_t)e * ENTRY + i] : a.one[i];
    };
    Ent en;
    en.tx = f(E_TX);
    en.flags = f(E_FLAGS);
    en.plane = f(E_PLANE);
    en.K = f(E_K);
    en.B = f(E_B);
    en.n_real = f(E_NREAL);
    en.vals = f(E_VALS);
    en.pos = f(E_POS);
    en.rsel = f(E_RSEL);
    en.csel = f(E_CSEL);
    en.ys = f(E_YS);
    en.xs = f(E_XS);
    en.hres = f(E_HRES);
    en.cta0 = f(E_CTA0);
    return en;
}

// EXPAND coefficient lanes k0, k0 + T, ... of a block's row of vals
// (and pos) into p[] and c[] (S, 0 past K)
template <int T, int S>
__device__ __forceinline__ void load_lanes(const ItxRunArgs& a,
                                           const Ent& en, size_t row,
                                           bool v16, bool p16, bool dense,
                                           int k0, int (&p)[EXPAND],
                                           int32_t (&c)[EXPAND]) {
#pragma unroll
    for (int j = 0; j < EXPAND; j++) {
        const int k = k0 + j * T;
        p[j] = S;
        c[j] = 0;
        if (k < en.K) {
            p[j] = dense ? k
                         : load_desc(a.base[B_POS32], a.base[B_POS16], p16,
                                     en.pos + row + k);
            c[j] = load_desc(a.base[B_VALS32], a.base[B_VALS16], v16,
                             en.vals + row + k);
        }
    }
}

// The G blocks of one work item of an entry of tx size TX: every thread
// of the CTA runs it (the tx size is uniform in the CTA).
template <int TX>
__device__ __forceinline__ void itx_block(const ItxRunArgs& a,
                                          const Ent& en, int item,
                                          int32_t* tile, int32_t* units,
                                          int32_t* s_last) {
    using Gm = Geom<TX>;
    constexpr int TW = Gm::TW, TH = Gm::TH, SW = Gm::SW, SH = Gm::SH;
    constexpr int T = Gm::T, G = Gm::G, STRIDE = Gm::STRIDE;
    constexpr int S = SH * SW;
    constexpr bool RECT2 = TW * 2 == TH || TH * 2 == TW;
    constexpr int RND = (1 << Gm::SHIFT) >> 1;
    const int g = threadIdx.x / T;
    const int t = threadIdx.x % T;
    const int b = item * G + g;
    const bool wht = TX == 0 && (en.flags & F_WHT);
    const bool hres = a.mode == MODE_HRES;
    int32_t* my = tile + g * Gm::TILE;
    int32_t* unit = units + g * TH * TW;   // the block's staged pixels

    // the block's plane and origin; live: a real block with pixels in the
    // plane (hres: a real block)
    const int pl = en.plane;
    void* const dst = pl == 0 ? a.dst[0] : pl == 1 ? a.dst[1] : a.dst[2];
    const int H = pl == 0 ? a.H[0] : pl == 1 ? a.H[1] : a.H[2];
    const int W = pl == 0 ? a.W[0] : pl == 1 ? a.W[1] : a.W[2];
    const int kind = pl == 0 ? a.kind[0] : pl == 1 ? a.kind[1] : a.kind[2];
    const bool real = b < en.n_real;
    bool live = real;
    int32_t y0 = 0, x0 = 0;
    // the block's families (loaded here, with its origin, so that their
    // latency overlaps the tile's zeroing and the expand)
    int rfam = 0, cfam = 0;
    if (live && !wht) {
        const bool fixed = en.flags & F_FIXED;
        rfam = fixed ? en.rsel
                     : ((const int32_t*)a.base[B_RSEL])[(size_t)en.rsel + b];
        cfam = fixed ? en.csel
                     : ((const int32_t*)a.base[B_CSEL])[(size_t)en.csel + b];
    }
    if (live && !hres) {
        y0 = ((const int32_t*)a.base[B_YS])[(size_t)en.ys + b];
        x0 = ((const int32_t*)a.base[B_XS])[(size_t)en.xs + b];
        live = y0 < H && (int64_t)y0 + TH > 0 && x0 < W &&
               (int64_t)x0 + TW > 0;
    }

    // the coefficients, scattered into the tile (with the prescale, which
    // leaves the zeros zero): EXPAND lanes a thread in flight, so that a
    // dense block's K loads do not wait on each other; a real block's
    // first lanes are loaded before the tile is zeroed and before its
    // origin is known
    const size_t row = (size_t)b * en.K;
    const bool v16 = en.flags & F_VALS16, p16 = en.flags & F_POS16;
    const bool dense = en.flags & F_DENSE;
    int p[EXPAND];
    int32_t c[EXPAND];
    if (real) load_lanes<T, S>(a, en, row, v16, p16, dense, t, p, c);

    for (int i = threadIdx.x; i < (G * Gm::TILE + 3) / 4; i += CTA_THREADS)
        ((int4*)tile)[i] = make_int4(0, 0, 0, 0);
    // clip-add onto an int32 plane: the block's pixels are copied into
    // shared memory in the background (thread t: its column), so that
    // their latency is spent during the transform
    const bool staged = a.mode == MODE_ADD && kind == DST_I32;
    if (staged && live && t < TW) {
        const int32_t x = itx_add(x0, t);
        if (x >= 0 && x < W) {
#pragma unroll 8
            for (int y = 0; y < TH; y++) {
                const int32_t yy = itx_add(y0, y);
                if (yy >= 0 && yy < H)
                    cp_async4(unit + y * TW + t,
                              (const int32_t*)dst + (size_t)yy * W + x);
            }
        }
    }
    __syncthreads();
    ITX_STAMP(en.cta0 + item, 2);

    if (live) {
        for (int k0 = t; k0 < en.K; k0 += EXPAND * T) {
            if (k0 != t)
                load_lanes<T, S>(a, en, row, v16, p16, dense, k0, p, c);
#pragma unroll
            for (int j = 0; j < EXPAND; j++) {
                const int pj = min(max(p[j], 0), S);
                if (pj < S) {
                    int32_t cj = c[j];
                    if (wht)
                        cj = itx_shr(cj, 2);
                    else if constexpr (RECT2)
                        cj = itx_shr(itx_add(itx_mul(cj, 181), 128), 8);
                    my[(pj / SW) * STRIDE + pj % SW] = cj;
                }
            }
        }
    }
    __syncthreads();
    ITX_STAMP(en.cta0 + item, 3);

    // each row's last nonzero column (-1: a zero row); the block's last
    // nonzero row (its row threads lie in one warp) and the warp's last
    // nonzero column
    int lastc = -1;
    if (live && t < SH) {
#pragma unroll
        for (int x = 0; x < SW; x++)
            if (my[t * STRIDE + x] != 0) lastc = x;
    }
    const unsigned nz = __ballot_sync(0xffffffffu, lastc >= 0);
    const int need_c = __reduce_max_sync(0xffffffffu, lastc) + 1;
    if (t == 0) {
        unsigned rows = nz >> ((g * T) & 31);
        if constexpr (SH < 32) rows &= (1u << SH) - 1;
        s_last[g] = rows ? 31 - __clz(rows) : -1;
    }

    // row pass: thread t transforms its nonzero row t in place
    if (lastc >= 0) {
        const int fam = rfam;
        int32_t out[TW];
        if (wht) {
            int32_t in[4];
#pragma unroll
            for (int k = 0; k < 4; k++) in[k] = my[t * STRIDE + k];
            itx_wht_4(in, out, 0, 0);
        } else {
            with_tail<TW>(need_c, [&](auto M) {
                constexpr int m = decltype(M)::value;
                int32_t in[m];
#pragma unroll
                for (int k = 0; k < m; k++) in[k] = my[t * STRIDE + k];
                itx_line_tail<TW>(fam, m, in, out, a.row_min, a.row_max);
            });
        }
#pragma unroll
        for (int x = 0; x < TW; x++) {
            int32_t v = out[x];
            if (!wht)
                v = itx_clip(itx_shr(itx_add(v, RND), Gm::SHIFT), a.col_min,
                             a.col_max);
            my[t * STRIDE + x] = v;
        }
    }
    __syncthreads();
    ITX_STAMP(en.cta0 + item, 4);

    // column pass: thread t transforms column t and writes it out
    if (live && t < TW) {
        const int fam = cfam;
        int32_t out[TH];
        if (wht) {
            int32_t in[4];
#pragma unroll
            for (int k = 0; k < 4; k++) in[k] = my[k * STRIDE + t];
            itx_wht_4(in, out, 0, 0);
        } else {
            with_tail<TH>(s_last[g] + 1, [&](auto M) {
                constexpr int m = decltype(M)::value;
                int32_t in[m];
#pragma unroll
                for (int k = 0; k < m; k++) in[k] = my[k * STRIDE + t];
                itx_line_tail<TH>(fam, m, in, out, a.col_min, a.col_max);
            });
#pragma unroll
            for (int y = 0; y < TH; y++)   // the final rounding
                out[y] = itx_shr(itx_add(out[y], 8), 4);
        }
        ITX_STAMP(en.cta0 + item, 5);
        if (hres) {
            const size_t o = (size_t)en.hres + (size_t)b * TH * TW + t;
#pragma unroll
            for (int y = 0; y < TH; y++)
                store_px(a.hres, a.hres_kind, o + (size_t)y * TW, out[y]);
        } else {
            // staged: the pixels the thread copied into shared memory;
            // else rows in chunks of ROWS_IN_FLIGHT: a chunk's pixel loads
            // are issued together, then its stores (a load after a store
            // to the same plane would wait for it)
            constexpr int RC = TH < ROWS_IN_FLIGHT ? TH : ROWS_IN_FLIGHT;
            const int32_t x = itx_add(x0, t);
            if (staged && x >= 0 && x < W) {
                cp_async_wait_all();
#pragma unroll
                for (int y = 0; y < TH; y++) {
                    const int32_t yy = itx_add(y0, y);
                    if (yy < 0 || yy >= H) continue;
                    ((int32_t*)dst)[(size_t)yy * W + x] =
                        min(max(itx_add(unit[y * TW + t], out[y]), 0),
                            a.pix_max);
                }
            } else if (x >= 0 && x < W) {
#pragma unroll
                for (int y0c = 0; y0c < TH; y0c += RC) {
                    int32_t px[RC];
                    if (a.mode == MODE_ADD) {
#pragma unroll
                        for (int j = 0; j < RC; j++) {
                            const int32_t yy = itx_add(y0, y0c + j);
                            px[j] = (yy < 0 || yy >= H)
                                        ? 0
                                        : load_px(dst, kind,
                                                  (size_t)yy * W + x);
                        }
                    }
#pragma unroll
                    for (int j = 0; j < RC; j++) {
                        const int32_t yy = itx_add(y0, y0c + j);
                        if (yy < 0 || yy >= H) continue;
                        int32_t r = out[y0c + j];
                        if (a.mode == MODE_ADD)
                            r = min(max(itx_add(px[j], r), 0), a.pix_max);
                        store_px(dst, kind, (size_t)yy * W + x, r);
                    }
                }
            }
        }
    } else if (hres && b >= en.n_real && b < en.B && t < TW) {
        // an hres pad row: the residuals of its zero coefficients
        const size_t o = (size_t)en.hres + (size_t)b * TH * TW + t;
        for (int y = 0; y < TH; y++)
            store_px(a.hres, a.hres_kind, o + (size_t)y * TW, 0);
    }
}

__device__ __forceinline__ void dispatch(const ItxRunArgs& a, const Ent& en,
                                         int item, int32_t* tile,
                                         int32_t* units, int32_t* s_last) {
    switch (en.tx) {
    case 0: itx_block<0>(a, en, item, tile, units, s_last); break;
    case 1: itx_block<1>(a, en, item, tile, units, s_last); break;
    case 2: itx_block<2>(a, en, item, tile, units, s_last); break;
    case 3: itx_block<3>(a, en, item, tile, units, s_last); break;
    case 4: itx_block<4>(a, en, item, tile, units, s_last); break;
    case 5: itx_block<5>(a, en, item, tile, units, s_last); break;
    case 6: itx_block<6>(a, en, item, tile, units, s_last); break;
    case 7: itx_block<7>(a, en, item, tile, units, s_last); break;
    case 8: itx_block<8>(a, en, item, tile, units, s_last); break;
    case 9: itx_block<9>(a, en, item, tile, units, s_last); break;
    case 10: itx_block<10>(a, en, item, tile, units, s_last); break;
    case 11: itx_block<11>(a, en, item, tile, units, s_last); break;
    case 12: itx_block<12>(a, en, item, tile, units, s_last); break;
    case 13: itx_block<13>(a, en, item, tile, units, s_last); break;
    case 14: itx_block<14>(a, en, item, tile, units, s_last); break;
    case 15: itx_block<15>(a, en, item, tile, units, s_last); break;
    case 16: itx_block<16>(a, en, item, tile, units, s_last); break;
    case 17: itx_block<17>(a, en, item, tile, units, s_last); break;
    case 18: itx_block<18>(a, en, item, tile, units, s_last); break;
    default: break;
    }
}

// two CTAs an SM: ptxas then keeps every tx size's lines in registers
// (with three it spills)
__global__ void __launch_bounds__(CTA_THREADS, 2)
    itx_run_kernel(const __grid_constant__ ItxRunArgs a) {
    extern __shared__ int4 smem[];   // SMEM_BYTES: tiles, then units
    int32_t* tile = (int32_t*)smem;
    int32_t* units = tile + TILE_INTS;
    // per block of the CTA (at most CTA_THREADS / 4): its last nonzero row
    __shared__ int32_t s_last[CTA_THREADS / 4];
    for (int w = blockIdx.x; w < a.n_work; w += gridDim.x) {
        ITX_STAMP(w, 0);
        const int e = a.map ? a.map[w] : 0;
        const Ent en = load_entry(a, e);
        ITX_STAMP(w, 1);
        dispatch(a, en, w - en.cta0, tile, units, s_last);
        __syncthreads();   // the next work item reuses the tile
        ITX_STAMP(w, 6);
    }
}

// One launch over a's work items, `grid` CTAs on `stream`. Returns
// cudaGetLastError().
extern "C" int itx_run_launch(const ItxRunArgs* a, int grid, void* stream) {
    if (grid <= 0 || a->n_work <= 0) return (int)cudaErrorInvalidValue;
    static bool attr = false;   // dynamic shared memory above 48 KB
    if (!attr) {
        const cudaError_t e = cudaFuncSetAttribute(
            itx_run_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)SMEM_BYTES);
        if (e != cudaSuccess) return (int)e;
        attr = true;
    }
    itx_run_kernel<<<grid, CTA_THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        *a);
    return (int)cudaGetLastError();
}

// sizeof(ItxRunArgs), for the wrapper's check of its ctypes mirror
extern "C" int itx_args_size() { return (int)sizeof(ItxRunArgs); }

extern "C" const char* itx_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
