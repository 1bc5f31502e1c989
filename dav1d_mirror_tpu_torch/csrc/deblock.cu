// AV1 deblocking, two kernels:
//  - deblock_frame_kernel: both passes of every deblocked plane of a
//    frame, one launch (ops/deblock_cuda.deblock_frame; the decode's
//    dbkrun record);
//  - deblock_pass_kernel: one pass (vertical or horizontal edges) over
//    one int32 view, out of place (ops/deblock_cuda.apply_pass and
//    deblock_plane); only the tile-sharded decode's row bands use it
//    (parallel/filter_shard.band_deblock_plane).
//
// Replaces no Pallas kernel: the JAX package computed deblock in XLA
// (dav1d_mirror_tpu/ops/loopfilter_tpu.py:236 deblock_plane_tpu, with
// _apply_pass :136 and _apply_pass_h :270). The plain PyTorch versions
// are dav1d_mirror_tpu_torch/ops/loopfilter.py::deblock_frame (a
// deblock_plane a plane, the neighbour levels the level maps shifted by
// one edge) and ::_apply_pass, and a launch computes exactly what one
// call of them computes, for any edge map.
//
// The semantics both keep (ops/loopfilter._apply_pass): every edge i of
// view row r sits between view columns base + 4i - 1 and base + 4i; edge
// row r >> 2 of the maps gives its width class (-1 none; luma 0/1/2 =
// 4/8/16 px, chroma 0/1 = 4/6 px) and its two levels. A tap at view
// column v is read at remainder(min(v, W - 1), W), as ops/loopfilter._cols
// reads it: a p-side tap left of column 0 wraps to the end of the row, a
// q-side one past the end is clamped to the last column, and stores
// follow the same map. The plain version computes every edge's outputs
// from the pass's input and then stores them tap by tap, p0, q0, p1, q1,
// ... p5, q5, each store only where that tap's mask is set. Edges 4 px
// apart can name the same pixel (q3 of edge i is p0 of edge i + 1 when
// both are 16 px wide, which a real stream never codes and a random map
// does), and then the later store wins. The vertical pass filters rows
// below 4 h4, the horizontal one columns below 4 w4 (on the vertical
// pass's output); x = 0 and y = 0 have no edge.
//
// The frame kernel: a CTA owns a DBF_TH x DBF_TW output tile of one
// plane (a work list of every plane's tiles, luma first). It stages the
// input tile with a halo of 12 rows and columns (4 for chroma: a pixel is
// written by edges up to 6 px away, which read 7 px beyond themselves) at
// logical coordinates, 16-byte loads away from the plane's sides, and
// every edge's class and level into shared memory; runs the vertical
// pass on every staged row into a second buffer of the tile's columns;
// runs the horizontal pass on that buffer; and writes the tile once. A
// store is an atomicMax of (key << 16 | value), key = 2 k + side, into
// its target pixel, which so keeps the plain version's last store (pixel
// values lie in [0, 2^12)). The vertical pass is row-local, so the rows
// a tile needs are computed on the spot and no CTA waits for another.
// The only stores that land outside an edge's neighbourhood are a 16 px
// luma edge at x = 4 (y = 4) storing p4 and p5 into the plane's last two
// columns (rows): the tile that holds them computes that edge too, from
// the plane's row (vertical) or from the vertical pass's output at its
// taps computed on the spot (horizontal, mid_at). tools/deblock_model.
// fused_tile is its numpy model.
//
// The pass kernel works on a view of the plane given by row and column
// strides: the vertical pass on the plane, the horizontal one on its
// transpose (a row band behind `base` halo rows), so no transposed copy
// is made. A CTA works in two phases on a tile of TR view rows by TC
// view columns:
//  1. every (row, edge) whose writes can reach the tile (the tile's own
//     edges, one more on the left and two on the right) computes its
//     candidate outputs and the mask of the taps it stores, into shared
//     memory, reading the input view only;
//  2. every pixel of the tile walks its writers in the plain version's
//     store order (tap k, p side then q side; at most one edge a store:
//     in closed form, two to three edges, away from the row's last 8
//     columns; there `p_writer` and `q_writer` below, which also invert
//     the wrap and the clamp of _cols) and keeps the last value whose
//     mask is set, else its input value. An edge outside the tile (only a
//     wrapped p-side write of edge 0 or 1 near the end of a row) is
//     computed on the spot.
// Rows from 4 * n_er to `rows` have no edges and are copied, so one launch
// writes the whole output view. tools/deblock_model.apply_pass is its
// numpy model.
//
// Bound on the H100: bytes. The function reads and writes each int32
// pixel once and reads four per-4x4 maps a plane; the arithmetic (at most
// 14 taps and a few dozen integer ops an edge row, a dozen lookups a
// pixel) is below the rate of the integer units. The frame kernel moves
// each pixel through device memory once (the halos are re-read from
// L2); the pass kernel twice, a launch a pass. In both a pixel is written
// by one thread and consecutive threads of a warp take consecutive
// addresses.
#include <cuda_runtime.h>
#include <stdint.h>

#define DBK_THREADS 256

// Mirrored by ops/deblock_cuda.DbkArgs (same order, natural alignment).
struct DbkArgs {
    const int32_t* in;
    int32_t* out;
    const void* edge;   // (n_er, n_e) width classes
    const void* lvl;    // (n_er, n_e) levels
    const void* lvlp;   // (n_er, n_e) fallback neighbour levels
    const void* elut;   // (64,) E limits
    const void* ilut;   // (64,) I limits
    long long in_sr, in_sc, out_sr, out_sc;
    long long edge_s0, edge_s1, lvl_s0, lvl_s1, lvlp_s0, lvlp_s1;
    int edge_es, lvl_es, lvlp_es, elut_es, ilut_es;  // element bytes 1/2/4
    int rows;        // view rows written (4 * n_er filtered, then copied)
    int W;           // view columns
    int n_er, n_e;   // edge rows, edges a row
    int base;        // view column of edge 0 (halo rows of a band)
    int first_edge;  // edges below it are inactive (1: the frame's x/y = 0)
    int luma, bd;
};

__device__ __forceinline__ int ld(const void* p, int es, int off) {
    if (es == 1) return ((const int8_t*)p)[off];
    if (es == 2) return ((const int16_t*)p)[off];
    return ((const int32_t*)p)[off];
}

// ops/loopfilter._cols: remainder(min(v, W - 1), W), for v >= -7, W >= 8
__device__ __forceinline__ int tap_col(int v, int W) {
    v = min(v, W - 1);
    return v < 0 ? v + W : v;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

__device__ __forceinline__ int floordiv4(int v) {
    return v >= 0 ? v >> 2 : -((3 - v) >> 2);
}

// One edge row: each output it stores goes to put(k, new p_k) and
// put(NS + k, new q_k), one at a time (no array of outputs stays live);
// returns the mask of the taps k it stores (bit k: p_k and q_k alike).
// ops/loopfilter._filter_values and the selection of _apply_pass, on the
// edge's taps p[k], q[k], its width class and the limits of its level.
template <bool LUMA, typename Put>
__device__ __forceinline__ int filter_core(const int (&p)[LUMA ? 7 : 3],
                                           const int (&q)[LUMA ? 7 : 3],
                                           int cls, int E, int I, int H,
                                           int bd, Put&& put) {
    constexpr int NS = LUMA ? 6 : 2;  // taps stored a side
    const int sh = bd - 8;
    const int F = 1 << sh;
    const int bd_max = (1 << bd) - 1;
    const int p0 = p[0], p1 = p[1], p2 = p[2];
    const int q0 = q[0], q1 = q[1], q2 = q[2];

    const bool fm = abs(p1 - p0) <= I && abs(q1 - q0) <= I &&
                    abs(p0 - q0) * 2 + (abs(p1 - q1) >> 1) <= E;
    const bool fm6 = fm && abs(p2 - p1) <= I && abs(q2 - q1) <= I;
    const bool flat6 = abs(p2 - p0) <= F && abs(p1 - p0) <= F &&
                       abs(q1 - q0) <= F && abs(q2 - q0) <= F;

    // the 4 px filter (the narrow fallback of every wider width)
    const bool hev = abs(p1 - p0) > H || abs(q1 - q0) > H;
    const int lo = -128 * (1 << sh), hi = 128 * (1 << sh) - 1;
    const int f = clampi(3 * (q0 - p0) + (hev ? clampi(p1 - q1, lo, hi) : 0),
                         lo, hi);
    const int f1 = min(f + 4, hi) >> 3;
    const int f2 = min(f + 3, hi) >> 3;
    const int fo = (f1 + 1) >> 1;
    int n4[4];
    n4[0] = clampi(p0 + f2, 0, bd_max);
    n4[1] = hev ? p1 : clampi(p1 + fo, 0, bd_max);
    n4[2] = clampi(q0 - f1, 0, bd_max);
    n4[3] = hev ? q1 : clampi(q1 - fo, 0, bd_max);

    if constexpr (!LUMA) {
        const bool m4 = cls == 0 && fm;
        const bool m6 = cls == 1 && fm6;
        if (m4 || (m6 && !flat6)) {
            put(0, n4[0]); put(1, n4[1]);
            put(NS, n4[2]); put(NS + 1, n4[3]);
            return 3;
        }
        if (m6 && flat6) {
            put(1, (p2 + 2 * p2 + 2 * p1 + 2 * p0 + q0 + 4) >> 3);
            put(0, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
            put(NS, (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
            put(NS + 1, (p0 + 2 * q0 + 2 * q1 + 2 * q2 + q2 + 4) >> 3);
            return 3;
        }
        return 0;
    } else {
        const int p3 = p[3], q3 = q[3];
        const int p4 = p[4], p5 = p[5], p6 = p[6];
        const int q4 = q[4], q5 = q[5], q6 = q[6];
        const bool fm8 = fm6 && abs(p3 - p2) <= I && abs(q3 - q2) <= I;
        const bool flat8 = flat6 && abs(p3 - p0) <= F && abs(q3 - q0) <= F;
        const bool flat8out = abs(p6 - p0) <= F && abs(p5 - p0) <= F &&
                              abs(p4 - p0) <= F && abs(q4 - q0) <= F &&
                              abs(q5 - q0) <= F && abs(q6 - q0) <= F;
        const bool flatout = flat8out && flat8;
        const bool m4 = cls == 0 && fm;
        const bool m8 = cls == 1 && fm8;
        const bool m16 = cls == 2 && fm8;
        const bool full = m16 && flatout;
        const bool w8 = (m8 && flat8) || (m16 && !flatout && flat8);
        const bool w4 = m4 || (m8 && !flat8) || (m16 && !flatout && !flat8);
        if (w4) {
            put(0, n4[0]); put(1, n4[1]);
            put(NS, n4[2]); put(NS + 1, n4[3]);
            return 3;
        }
        if (w8) {
            put(2, (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3);
            put(1, (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3);
            put(0, (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3);
            put(NS, (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3);
            put(NS + 1, (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3);
            put(NS + 2, (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3);
            return 7;
        }
        if (full) {
            put(5, (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0 +
                      8) >> 4);
            put(4, (p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 +
                      q1 + 8) >> 4);
            put(3, (p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 +
                      q1 + q2 + 8) >> 4);
            put(2, (p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 +
                      q1 + q2 + q3 + 8) >> 4);
            put(1, (p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 +
                      q1 + q2 + q3 + q4 + 8) >> 4);
            put(0, (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 +
                      q2 + q3 + q4 + q5 + 8) >> 4);
            put(NS, (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 +
                       q2 + q3 + q4 + q5 + q6 + 8) >> 4);
            put(NS + 1, (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 +
                           q2 * 2 + q3 + q4 + q5 + q6 * 2 + 8) >> 4);
            put(NS + 2, (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 +
                           q3 * 2 + q4 + q5 + q6 * 3 + 8) >> 4);
            put(NS + 3, (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 +
                           q4 * 2 + q5 + q6 * 4 + 8) >> 4);
            put(NS + 4, (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 +
                           q5 * 2 + q6 * 5 + 8) >> 4);
            put(NS + 5, (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 +
                           q6 * 7 + 8) >> 4);
            return 63;
        }
        return 0;
    }
}

// One edge row of a pass: its maps, limits and taps, then filter_core.
template <bool LUMA>
__device__ int edge_filter(const DbkArgs& a, int r, int i, int* out) {
    constexpr int NR = LUMA ? 7 : 3;  // taps read a side
    // offsets in int: the wrapper takes planes and maps under 2^31
    // elements
    const int er = r >> 2;
    const int cls = ld(a.edge, a.edge_es,
                       er * (int)a.edge_s0 + i * (int)a.edge_s1);
    const int lc = ld(a.lvl, a.lvl_es, er * (int)a.lvl_s0 + i * (int)a.lvl_s1);
    const int lp = ld(a.lvlp, a.lvlp_es,
                      er * (int)a.lvlp_s0 + i * (int)a.lvlp_s1);
    const int L = lc != 0 ? lc : lp;
    if (i < a.first_edge || cls < 0 || cls > (LUMA ? 2 : 1) || L == 0)
        return 0;
    const int sh = a.bd - 8;
    const int E = ld(a.elut, a.elut_es, L) << sh;
    const int I = ld(a.ilut, a.ilut_es, L) << sh;
    const int H = (L >> 4) << sh;

    const int32_t* row = a.in + r * (int)a.in_sr;
    const int sc = (int)a.in_sc;
    const int c0 = a.base + 4 * i;
    int p[NR], q[NR];
    if (sc == 1 && c0 >= 4 * (NR > 4 ? 2 : 1) &&
        c0 + 4 * (NR > 4 ? 2 : 1) <= a.W &&
        ((reinterpret_cast<uintptr_t>(row + c0) & 15) == 0)) {
        // unit-stride taps inside the row, 16-byte aligned (the vertical
        // pass on a plane): the read is 2 (chroma) or 4 (luma) int4
        // loads, and a warp's lanes (consecutive edges) cover one span
        const int4* v = reinterpret_cast<const int4*>(row + c0);
        const int4 b = v[-1], c = v[0];
        p[0] = b.w; p[1] = b.z; p[2] = b.y;
        q[0] = c.x; q[1] = c.y; q[2] = c.z;
        if constexpr (NR > 4) {
            const int4 a4 = v[-2], d = v[1];
            p[3] = b.x; p[4] = a4.w; p[5] = a4.z; p[6] = a4.y;
            q[3] = c.w; q[4] = d.x; q[5] = d.y; q[6] = d.z;
        }
    } else {
#pragma unroll
        for (int k = 0; k < NR; ++k) {
            p[k] = row[tap_col(c0 - 1 - k, a.W) * sc];
            q[k] = row[tap_col(c0 + k, a.W) * sc];
        }
    }
    return filter_core<LUMA>(p, q, cls, E, I, H, a.bd,
                             [&](int k, int v) { out[k] = v; });
}

// The edge whose p-side store of tap k lands on view column c (at most
// one), or -1: its column base + 4i - 1 - k is c, or wraps to c from below
// zero.
__device__ __forceinline__ int p_writer(const DbkArgs& a, int c, int k) {
    int t = c - a.base + 1 + k;
    if (t >= 0 && (t & 3) == 0 && (t >> 2) < a.n_e) return t >> 2;
    t -= a.W;
    if (t >= 0 && (t & 3) == 0 && (t >> 2) < a.n_e) return t >> 2;
    return -1;
}

// The edge whose q-side store of tap k lands on view column c, or -1: its
// column base + 4i + k is c, or is clamped to the last column (only the
// last edge, as 4 n_e + base <= W).
__device__ __forceinline__ int q_writer(const DbkArgs& a, int c, int k) {
    const int t = c - a.base - k;
    if (t >= 0 && (t & 3) == 0 && (t >> 2) < a.n_e) return t >> 2;
    if (c == a.W - 1 && a.n_e > 0 && a.base + 4 * (a.n_e - 1) + k > c)
        return a.n_e - 1;
    return -1;
}

template <bool LUMA, bool ROWS_FAST>
__global__ void __launch_bounds__(DBK_THREADS)
deblock_pass_kernel(const DbkArgs a) {
    constexpr int NS = LUMA ? 6 : 2;
    constexpr int TR = ROWS_FAST ? 32 : 4;     // view rows a tile
    // view columns a tile: in the vertical pass 61 edges' columns, so that
    // its 64 phase-1 edges of 4 rows take one round of the 256 threads
    constexpr int TC = ROWS_FAST ? 64 : 244;
    constexpr int NE = TC / 4 + 4;             // edges whose writes reach it
    __shared__ int s_val[TR * NE][2 * NS];
    __shared__ int s_mask[TR * NE];

    const int r0 = blockIdx.y * TR;
    const int c0 = blockIdx.x * TC;
    const int rf = 4 * a.n_er;
    // edges whose store span [base + 4i - 6, base + 4i + 5] meets the tile
    const int i_lo = max(floordiv4(c0 - a.base - 2), 0);
    const int i_hi = min(floordiv4(c0 + TC + 5 - a.base), a.n_e - 1);
    const int ne = i_hi - i_lo + 1;

    if (r0 < rf && ne > 0) {
        for (int t = threadIdx.x; t < TR * ne; t += DBK_THREADS) {
            const int rr = ROWS_FAST ? t % TR : t / ne;
            const int ii = ROWS_FAST ? t / TR : t % ne;
            const int r = r0 + rr;
            s_mask[rr * NE + ii] =
                r < rf ? edge_filter<LUMA>(a, r, i_lo + ii,
                                           s_val[rr * NE + ii])
                       : 0;
        }
    }
    __syncthreads();

    for (int t = threadIdx.x; t < TR * TC; t += DBK_THREADS) {
        const int rr = ROWS_FAST ? t % TR : t / TC;
        const int cc = ROWS_FAST ? t / TR : t % TC;
        const int r = r0 + rr, c = c0 + cc;
        if (r >= a.rows || c >= a.W) continue;
        int val = a.in[r * (int)a.in_sr + c * (int)a.in_sc];
        if (r < rf && c < a.W - 8) {
            // away from the last 8 columns a pixel's writers are exact
            // (no wrap, no clamp): with c - base = 4j + m, the q side of
            // edge j (tap m), the p side of edge j + 1 (tap 3 - m), and
            // (16 px luma) the q side of edge j - 1 (tap m + 4) or the p
            // side of edge j + 2 (tap 7 - m), here in store order; every
            // one in [0, n_e) is one of the tile's phase-1 edges
            const int cp = c - a.base, m = cp & 3, j = cp >> 2;
            const bool lo = m < 2;
            const int ks[3] = {lo ? m : 3 - m, lo ? 3 - m : m,
                               lo ? m + 4 : 7 - m};
            const int qs[3] = {lo, !lo, lo};
            const int es[3] = {lo ? j : j + 1, lo ? j + 1 : j,
                               lo ? j - 1 : j + 2};
#pragma unroll
            for (int n = 0; n < 3; ++n) {
                const int i = es[n], k = ks[n];
                if (k >= NS || i < i_lo || i > i_hi) continue;
                const int e = rr * NE + i - i_lo;
                if ((s_mask[e] >> k) & 1) val = s_val[e][qs[n] * NS + k];
            }
        } else if (r < rf) {
            // the last columns: every store, by p_writer and q_writer
#pragma unroll
            for (int k = 0; k < NS; ++k) {
#pragma unroll
                for (int side = 0; side < 2; ++side) {
                    const int i = side ? q_writer(a, c, k) : p_writer(a, c, k);
                    if (i < 0) continue;
                    int m, v;
                    if (i >= i_lo && i <= i_hi) {
                        m = s_mask[rr * NE + i - i_lo];
                        v = s_val[rr * NE + i - i_lo][side * NS + k];
                    } else {   // a wrapped write of edge 0 or 1
                        int own[2 * NS];
                        m = edge_filter<LUMA>(a, r, i, own);
                        v = own[side * NS + k];
                    }
                    if ((m >> k) & 1) val = v;
                }
            }
        }
        a.out[r * (int)a.out_sr + c * (int)a.out_sc] = val;
    }
}

// ---- the frame kernel: both passes of every deblocked plane, one launch
// a frame (the decode's dbkrun record) ----

#define DBF_TH 64        // output tile rows
#define DBF_TW 64        // output tile columns
#define DBF_THREADS 256
#define DBF_HALO_MAX 12  // staged rows and columns a side (luma)
// shared memory: the staged input (later the horizontal pass's stores and
// the wrapped edge's taps), then the vertical pass's output; odd pitches
#define DBF_SP_MAX (DBF_TW + 2 * DBF_HALO_MAX + 1)
#define DBF_SR_MAX (DBF_TH + 2 * DBF_HALO_MAX)
#define DBF_MP (DBF_TW + 1)
// vertical edges a staged row (DBF_TW / 4 + 3 and the wrapped edge 1),
// horizontal edges a column
#define DBF_NV_MAX (DBF_TW / 4 + 4)
#define DBF_NH_MAX (DBF_TH / 4 + 3)
#define DBF_SMEM_INTS (DBF_SR_MAX * DBF_SP_MAX + DBF_SR_MAX * DBF_MP + \
                       DBF_SR_MAX * DBF_NV_MAX + DBF_NH_MAX * (DBF_TW / 4) + \
                       128)

// Mirrored by ops/deblock_cuda.DbkPlane (same order, natural alignment).
struct DbkPlane {
    const int32_t* in;
    int32_t* out;
    const void* ev;     // (h4, w4) vertical edge classes
    const void* eh;     // (h4, w4) horizontal edge classes
    const void* lv;     // (h4, w4) vertical edge levels
    const void* lh;     // (h4, w4) horizontal edge levels
    long long in_sr, out_sr;
    long long ev_s0, ev_s1, eh_s0, eh_s1, lv_s0, lv_s1, lh_s0, lh_s1;
    int ev_es, eh_es, lv_es, lh_es;
    int Hp, Wp, h4, w4;
    int luma;
    int vec;            // in and in_sr are multiples of 4 ints
    int tiles_x;        // tiles across the plane
    int tile0;          // the plane's first CTA
};

// Mirrored by ops/deblock_cuda.DbkFrameArgs.
struct DbkFrameArgs {
    DbkPlane pl[3];
    const void* elut;   // (64,) E limits
    const void* ilut;   // (64,) I limits
    int elut_es, ilut_es;
    int n_planes, n_tiles, bd;
};

// remainder(min(v, W - 1), W) for any v (staging reaches 12 px past an
// edge of the plane, which can be more than W)
__device__ __forceinline__ int tap_mod(int v, int W) {
    v = min(v, W - 1);
    if (v >= 0) return v;
    v %= W;
    return v < 0 ? v + W : v;
}

// ceil(v / 4)
__device__ __forceinline__ int ceil4(int v) { return -floordiv4(-v); }

// The level of edge i of a map (stride se along the edges, so at the
// other index o): its own, else the previous edge's (0 at i = 0).
__device__ __forceinline__ int edge_level(const void* m, int es, int se,
                                          int so, int i, int o) {
    const int lc = ld(m, es, i * se + o * so);
    return lc != 0 ? lc : (i > 0 ? ld(m, es, (i - 1) * se + o * so) : 0);
}

// An edge's parameters as the tile's phases read them from shared
// memory: its width class and level, or -1 where it stores nothing
// (no class, level 0).
template <bool LUMA>
__device__ __forceinline__ int edge_word(int cls, int L) {
    return cls < 0 || cls > (LUMA ? 2 : 1) || L == 0 ? -1
                                                     : cls | (L & 63) << 2;
}

// filter_core of an edge from its parameter word (edge_word), the limits
// from the tile's LUTs in shared memory.
template <bool LUMA, typename Put>
__device__ __forceinline__ void word_edge(int w, const int* s_e,
                                          const int* s_i, int bd,
                                          const int (&p)[LUMA ? 7 : 3],
                                          const int (&q)[LUMA ? 7 : 3],
                                          Put&& put) {
    const int L = w >> 2;
    filter_core<LUMA>(p, q, w & 3, s_e[L], s_i[L], (L >> 4) << (bd - 8), bd,
                      put);
}

// The vertical pass's taps of edge i of plane row `row`, through the
// column map (tap_col).
template <bool LUMA>
__device__ __forceinline__ void row_taps(const int32_t* row, int i, int W,
                                         int (&p)[LUMA ? 7 : 3],
                                         int (&q)[LUMA ? 7 : 3]) {
#pragma unroll
    for (int k = 0; k < (LUMA ? 7 : 3); ++k) {
        p[k] = row[tap_col(4 * i - 1 - k, W)];
        q[k] = row[tap_col(4 * i + k, W)];
    }
}

// The vertical pass's output at plane row r, column x, from the plane:
// the last set store of its writers, the edges whose stores reach x
// (edge_range of one column) and edge 1 (a p-side store wrapped to the
// last two columns). Only the wrapped horizontal edge reads it.
template <bool LUMA>
__device__ int mid_at(const DbkFrameArgs& a, const DbkPlane& pl,
                      const int* s_e, const int* s_i, int r, int x) {
    constexpr int NS = LUMA ? 6 : 2, NR = LUMA ? 7 : 3;
    const int32_t* row = pl.in + r * (int)pl.in_sr;
    if (r >= 4 * pl.h4) return row[x];
    const int lo = max(ceil4(x - NS + 1), 1);
    const int hi = min((x + NS) >> 2, pl.w4 - 1);
    int best = -1;
#pragma unroll 1
    for (int n = lo - 1; n <= hi; ++n) {
        const int i = n < lo ? 1 : n;
        if (i >= pl.w4) continue;
        const int cls = ld(pl.ev, pl.ev_es,
                           (r >> 2) * (int)pl.ev_s0 + i * (int)pl.ev_s1);
        const int L = edge_level(pl.lv, pl.lv_es, (int)pl.lv_s1,
                                 (int)pl.lv_s0, i, r >> 2);
        const int w = edge_word<LUMA>(cls, L);
        if (w < 0) continue;
        int p[NR], q[NR];
        row_taps<LUMA>(row, i, pl.Wp, p, q);
        word_edge<LUMA>(w, s_e, s_i, a.bd, p, q, [&](int n, int v) {
            const int k = n < NS ? n : n - NS, side = n >= NS;
            if (tap_col(side ? 4 * i + k : 4 * i - 1 - k, pl.Wp) == x)
                best = max(best, (2 * k + side) << 16 | v);
        });
    }
    return best >= 0 ? best & 0xFFFF : row[x];
}

// The sink of an edge at logical position c (along a view `W` long,
// through the column map) for filter_core: a store whose target t lies
// in [t0, t0 + n) goes to buf[(t - t0) * st] as an atomicMax of (key <<
// 16 | value), key = 2 k + side, the plain version's store order: a
// pixel keeps its last store.
template <bool LUMA>
struct Scatter {
    int* buf;
    int st, c, W, t0, n;
    __device__ __forceinline__ void operator()(int idx, int v) const {
        constexpr int NS = LUMA ? 6 : 2;
        const int k = idx < NS ? idx : idx - NS, side = idx >= NS;
        const int t = tap_col(side ? c + k : c - 1 - k, W) - t0;
        if (t >= 0 && t < n) atomicMax(buf + t * st, (2 * k + side) << 16 | v);
    }
};

// One CTA's output tile (DBF_TH x DBF_TW at tile index `tile` of plane
// pl). tools/deblock_model.fused_tile is its numpy model.
template <bool LUMA>
__device__ void frame_tile(const DbkFrameArgs& a, const DbkPlane& pl,
                           int tile, int* smem) {
    constexpr int NS = LUMA ? 6 : 2, NR = LUMA ? 7 : 3;
    constexpr int HL = LUMA ? 12 : 4;
    constexpr int SR = DBF_TH + 2 * HL, SC = DBF_TW + 2 * HL;
    constexpr int SP = SC + 1;
    constexpr int MP = DBF_MP;
    int* S = smem;                               // SR x SP, then Q
    int* M = S + DBF_SR_MAX * DBF_SP_MAX;        // SR x MP
    int* s_vw = M + DBF_SR_MAX * DBF_MP;         // vertical edge words
    int* s_hw = s_vw + DBF_SR_MAX * DBF_NV_MAX;  // horizontal edge words
    int* s_e = s_hw + DBF_NH_MAX * (DBF_TW / 4); // E limits << (bd - 8)
    int* s_i = s_e + 64;                         // I limits << (bd - 8)
    const int ty = tile / pl.tiles_x;
    const int y0 = ty * DBF_TH, x0 = (tile - ty * pl.tiles_x) * DBF_TW;
    const int Hp = pl.Hp, Wp = pl.Wp, h4 = pl.h4, w4 = pl.w4;
    const int tid = threadIdx.x;
    const int sh = a.bd - 8;

    // the vertical pass's edges: those whose stores reach the tile's
    // columns, and in a tile holding one of the last two columns edge 1
    // (its p-side stores wrap there); the horizontal pass's: those whose
    // stores reach the tile's rows, at columns left of 4 w4
    const int i_lo = max(ceil4(x0 - NS + 1), 1);
    const int i_hi = min((x0 + DBF_TW - 1 + NS) >> 2, w4 - 1);
    const int ne = max(i_hi - i_lo + 1, 0);
    const bool v_wrap = LUMA && w4 > 1 && i_lo > 1 && x0 + DBF_TW >= Wp - 1;
    const int nv = ne + (v_wrap ? 1 : 0);
    const int j_lo = max(ceil4(y0 - NS + 1), 1);
    const int j_hi = min((y0 + DBF_TH - 1 + NS) >> 2, h4 - 1);
    const int nj = max(j_hi - j_lo + 1, 0);
    const int ncol = min(DBF_TW, 4 * w4 - x0);

    // 1. the input tile, HL rows and columns a side, at logical
    // coordinates (rows and columns past the plane through the column
    // map, as the plain version's taps read them), 16-byte loads away
    // from the plane's left and right edges; the LUTs and every edge's
    // parameter word (a staged row's own: the maps are read once a
    // CTA, all loads independent)
    if (pl.vec && x0 >= HL && x0 + DBF_TW + HL <= Wp) {
        constexpr int V = SC / 4;
#pragma unroll 4
        for (int t = tid; t < SR * V; t += DBF_THREADS) {
            const int rr = t / V, v = t - rr * V;
            const int r = tap_mod(y0 - HL + rr, Hp);
            const int4 w = *reinterpret_cast<const int4*>(
                pl.in + r * (int)pl.in_sr + x0 - HL + 4 * v);
            int* d = S + rr * SP + 4 * v;
            d[0] = w.x; d[1] = w.y; d[2] = w.z; d[3] = w.w;
        }
    } else {
#pragma unroll 4
        for (int t = tid; t < SR * SC; t += DBF_THREADS) {
            const int rr = t / SC, cc = t - rr * SC;
            S[rr * SP + cc] = pl.in[tap_mod(y0 - HL + rr, Hp) * (int)pl.in_sr +
                                    tap_mod(x0 - HL + cc, Wp)];
        }
    }
    for (int t = tid; t < SR * MP; t += DBF_THREADS) M[t] = -1;
    if (tid < 64) {
        s_e[tid] = ld(a.elut, a.elut_es, tid) << sh;
        s_i[tid] = ld(a.ilut, a.ilut_es, tid) << sh;
    }
#pragma unroll 4
    for (int t = tid; t < SR * nv; t += DBF_THREADS) {
        const int ii = t / SR, rr = t - ii * SR;
        const int r = tap_mod(y0 - HL + rr, Hp);
        const int i = ii < ne ? i_lo + ii : 1;
        const int r4 = min(r >> 2, h4 - 1);      // rows past 4 h4: no edge
        const int o = r4 * (int)pl.ev_s0 + i * (int)pl.ev_s1;
        const int ol = r4 * (int)pl.lv_s0 + i * (int)pl.lv_s1;
        const int cls = ld(pl.ev, pl.ev_es, o);
        const int lc = ld(pl.lv, pl.lv_es, ol);
        const int lp = ld(pl.lv, pl.lv_es, ol - (int)pl.lv_s1);
        s_vw[t] = r >= 4 * h4 ? -1 : edge_word<LUMA>(cls, lc ? lc : lp);
    }
#pragma unroll 4
    for (int t = tid; t < nj * (DBF_TW / 4); t += DBF_THREADS) {
        const int jj = t / (DBF_TW / 4), xq = (x0 >> 2) + t - jj * (DBF_TW / 4);
        int w = -1;
        if (xq < w4) {
            const int j = j_lo + jj;
            const int ol = j * (int)pl.lh_s0 + xq * (int)pl.lh_s1;
            const int cls = ld(pl.eh, pl.eh_es,
                               j * (int)pl.eh_s0 + xq * (int)pl.eh_s1);
            const int lc = ld(pl.lh, pl.lh_es, ol);
            const int lp = ld(pl.lh, pl.lh_es, ol - (int)pl.lh_s0);
            w = edge_word<LUMA>(cls, lc ? lc : lp);
        }
        s_hw[t] = w;
    }
    __syncthreads();

    // 2. the vertical pass on every staged row, a thread a (row, edge)
    // with the rows fastest, taps from S (the wrapped edge's from the
    // plane's row)
    for (int t = tid; t < SR * nv; t += DBF_THREADS) {
        const int w = s_vw[t];
        if (w < 0) continue;
        const int ii = t / SR, rr = t - ii * SR;
        const int i = ii < ne ? i_lo + ii : 1;
        int p[NR], q[NR];
        if (ii < ne) {
            const int* c = S + rr * SP + 4 * i - (x0 - HL);
#pragma unroll
            for (int k = 0; k < NR; ++k) {
                p[k] = c[-1 - k];
                q[k] = c[k];
            }
        } else {
            row_taps<LUMA>(pl.in + tap_mod(y0 - HL + rr, Hp) * (int)pl.in_sr,
                           i, Wp, p, q);
        }
        word_edge<LUMA>(w, s_e, s_i, a.bd, p, q,
                        Scatter<LUMA>{M + rr * MP, 1, 4 * i, Wp, x0, DBF_TW});
    }
    __syncthreads();

    // 3. the vertical pass's output: the last store, else the input
    for (int t = tid; t < SR * DBF_TW; t += DBF_THREADS) {
        const int rr = t / DBF_TW, cc = t - rr * DBF_TW;
        const int v = M[rr * MP + cc];
        M[rr * MP + cc] = v >= 0 ? v & 0xFFFF : S[rr * SP + cc + HL];
    }
    __syncthreads();
    int* Q = S;                                  // DBF_TH x MP
    for (int t = tid; t < DBF_TH * MP; t += DBF_THREADS) Q[t] = -1;
    __syncthreads();

    // 4. the horizontal pass on M, a thread a (edge, column) with the
    // columns fastest; and in a tile holding one of the last two rows edge
    // 1's wrapped stores, its taps the vertical pass's output at rows
    // -3..10 computed on the spot (only a 16 px edge stores there)
    for (int t = tid; t < nj * DBF_TW; t += DBF_THREADS) {
        const int jj = t / DBF_TW, cc = t - jj * DBF_TW;
        const int w = s_hw[jj * (DBF_TW / 4) + (cc >> 2)];
        if (w < 0) continue;
        const int j = j_lo + jj;
        const int* c = M + (4 * j - (y0 - HL)) * MP + cc;
        int p[NR], q[NR];
#pragma unroll
        for (int k = 0; k < NR; ++k) {
            p[k] = c[(-1 - k) * MP];
            q[k] = c[k * MP];
        }
        word_edge<LUMA>(w, s_e, s_i, a.bd, p, q,
                        Scatter<LUMA>{Q + cc, MP, 4 * j, Hp, y0, DBF_TH});
    }
    if (LUMA && h4 > 1 && j_lo > 1 && y0 + DBF_TH >= Hp - 1) {
        int* col_all = S + DBF_TH * MP;          // 14 ints a column
        for (int cc = tid; cc < ncol; cc += DBF_THREADS) {
            const int xq = (x0 + cc) >> 2;
            const int cls = ld(pl.eh, pl.eh_es,
                               (int)pl.eh_s0 + xq * (int)pl.eh_s1);
            const int L = edge_level(pl.lh, pl.lh_es, (int)pl.lh_s0,
                                     (int)pl.lh_s1, 1, xq);
            if (cls != 2 || L == 0) continue;
            int* col = col_all + cc * 2 * NR;
#pragma unroll 1
            for (int t = 0; t < 2 * NR; ++t)
                col[t] = mid_at<LUMA>(a, pl, s_e, s_i, tap_col(t - 3, Hp),
                                      x0 + cc);
            int p[NR], q[NR];
#pragma unroll
            for (int k = 0; k < NR; ++k) {
                p[k] = col[6 - k];     // logical row 3 - k
                q[k] = col[7 + k];     // logical row 4 + k
            }
            word_edge<LUMA>(edge_word<LUMA>(cls, L), s_e, s_i, a.bd, p, q,
                            Scatter<LUMA>{Q + cc, MP, 4, Hp, y0, DBF_TH});
        }
    }
    __syncthreads();

    // 5. the tile, written once, coalesced
    for (int t = tid; t < DBF_TH * DBF_TW; t += DBF_THREADS) {
        const int rr = t / DBF_TW, cc = t - rr * DBF_TW;
        const int y = y0 + rr, x = x0 + cc;
        if (y >= Hp || x >= Wp) continue;
        const int v = Q[rr * MP + cc];
        pl.out[y * (int)pl.out_sr + x] =
            v >= 0 ? v & 0xFFFF : M[(rr + HL) * MP + cc];
    }
}

// three CTAs an SM (80 registers, no spill): a third more warps than two
__global__ void __launch_bounds__(DBF_THREADS, 3)
deblock_frame_kernel(const DbkFrameArgs a) {
    extern __shared__ int smem[];
    int pi = 0;
    while (pi + 1 < a.n_planes && (int)blockIdx.x >= a.pl[pi + 1].tile0) ++pi;
    const DbkPlane& pl = a.pl[pi];
    const int tile = blockIdx.x - pl.tile0;
    if (pl.luma)
        frame_tile<true>(a, pl, tile, smem);
    else
        frame_tile<false>(a, pl, tile, smem);
}

extern "C" int deblock_frame_args_size() { return (int)sizeof(DbkFrameArgs); }

extern "C" int deblock_frame_launch(const DbkFrameArgs* args, void* stream) {
    if (args->n_tiles <= 0) return 0;
    const int bytes = DBF_SMEM_INTS * (int)sizeof(int);
    cudaError_t e = cudaFuncSetAttribute(
        deblock_frame_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e != cudaSuccess) return (int)e;
    deblock_frame_kernel<<<args->n_tiles, DBF_THREADS, bytes,
                           (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}

extern "C" int deblock_args_size() { return (int)sizeof(DbkArgs); }

extern "C" int deblock_pass_launch(const DbkArgs* args, void* stream) {
    const DbkArgs a = *args;
    if (a.rows <= 0 || a.W <= 0) return 0;
    const bool rows_fast = a.in_sr == 1;
    const int tr = rows_fast ? 32 : 4, tc = rows_fast ? 64 : 244;
    const dim3 grid((a.W + tc - 1) / tc, (a.rows + tr - 1) / tr);
    cudaStream_t s = (cudaStream_t)stream;
    if (a.luma) {
        if (rows_fast)
            deblock_pass_kernel<true, true><<<grid, DBK_THREADS, 0, s>>>(a);
        else
            deblock_pass_kernel<true, false><<<grid, DBK_THREADS, 0, s>>>(a);
    } else {
        if (rows_fast)
            deblock_pass_kernel<false, true><<<grid, DBK_THREADS, 0, s>>>(a);
        else
            deblock_pass_kernel<false, false><<<grid, DBK_THREADS, 0, s>>>(a);
    }
    return (int)cudaGetLastError();
}

extern "C" const char* deblock_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
