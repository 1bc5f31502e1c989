// AV1 deblocking: one pass (vertical or horizontal edges) over one int32
// plane, out of place.
//
// Replaces no Pallas kernel: the JAX package computed deblock in XLA
// (dav1d_mirror_tpu/ops/loopfilter_tpu.py:236 deblock_plane_tpu, with
// _apply_pass :136 and _apply_pass_h :270). Its plain PyTorch version is
// dav1d_mirror_tpu_torch/ops/loopfilter.py::_apply_pass, and a launch
// computes exactly what one call of it computes, for any edge map.
//
// The pass works on a view of the plane given by row and column strides:
// the vertical pass on the plane, the horizontal one on its transpose
// (plane.T, or a row band behind `base` halo rows), so no transposed copy
// is made. Every edge i of view row r sits between view columns
// base + 4i - 1 and base + 4i; edge row r >> 2 of the maps gives its
// width class (-1 none; luma 0/1/2 = 4/8/16 px, chroma 0/1 = 4/6 px) and
// its two levels. A tap at view column v is read at
// remainder(min(v, W - 1), W), as ops/loopfilter._cols reads it.
//
// The plain version computes every edge's outputs from the pass's input
// and then stores them tap by tap, p0, q0, p1, q1, ... p5, q5, each store
// only where that tap's mask is set. Edges 4 px apart can name the same
// pixel (q3 of edge i is p0 of edge i + 1 when both are 16 px wide, which
// a real stream never codes and a random map does), and then the later
// store wins. A CTA therefore works in two phases on a tile of TR view
// rows by TC view columns:
//  1. every (row, edge) whose writes can reach the tile (the tile's own
//     edges, one more on the left and two on the right) computes its
//     candidate outputs and the mask of the taps it stores, into shared
//     memory, reading the input plane only;
//  2. every pixel of the tile walks its writers in the plain version's
//     store order (tap k, p side then q side; at most one edge a store:
//     in closed form, two to three edges, away from the row's last 8
//     columns; there `p_writer` and `q_writer` below, which also invert
//     the wrap and the clamp of _cols) and keeps the last value whose
//     mask is set, else its input value. An edge outside the tile (only a
//     wrapped p-side write of edge 0 or 1 near the end of a row) is
//     computed on the spot.
// Rows from 4 * n_er to `rows` have no edges and are copied, so one launch
// writes the whole output view.
//
// Bound on the H100: bytes. A pass reads and writes each int32 pixel once
// and reads three per-4x4 maps; the arithmetic (at most 14 taps and a few
// dozen integer ops an edge row, a dozen lookups a pixel) is far below the
// rate of the integer units. Design for that: a pixel is written by one
// thread, consecutive threads of a warp take consecutive addresses of the
// pass's unit-stride axis (view columns in the vertical pass, view rows in
// the horizontal one: ROWS_FAST), an edge row's taps come in as 16-byte
// loads where they lie along a row (the vertical pass), and a tile's
// phase 1 is one round of its threads where the tile is 4 rows deep.
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

// One edge row: its stored outputs (out[k] = new p_k, out[NS + k] = new
// q_k) and the mask of the taps k it stores (bit k: p_k and q_k alike).
// ops/loopfilter._filter_values and the selection of _apply_pass.
template <bool LUMA>
__device__ int edge_filter(const DbkArgs& a, int r, int i, int* out) {
    constexpr int NR = LUMA ? 7 : 3;  // taps read a side
    constexpr int NS = LUMA ? 6 : 2;  // taps stored a side
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
    const int F = 1 << sh;
    const int bd_max = (1 << a.bd) - 1;

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
            out[0] = n4[0]; out[1] = n4[1];
            out[NS] = n4[2]; out[NS + 1] = n4[3];
            return 3;
        }
        if (m6 && flat6) {
            out[1] = (p2 + 2 * p2 + 2 * p1 + 2 * p0 + q0 + 4) >> 3;
            out[0] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
            out[NS] = (p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3;
            out[NS + 1] = (p0 + 2 * q0 + 2 * q1 + 2 * q2 + q2 + 4) >> 3;
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
            out[0] = n4[0]; out[1] = n4[1];
            out[NS] = n4[2]; out[NS + 1] = n4[3];
            return 3;
        }
        if (w8) {
            out[2] = (p3 + p3 + p3 + 2 * p2 + p1 + p0 + q0 + 4) >> 3;
            out[1] = (p3 + p3 + p2 + 2 * p1 + p0 + q0 + q1 + 4) >> 3;
            out[0] = (p3 + p2 + p1 + 2 * p0 + q0 + q1 + q2 + 4) >> 3;
            out[NS] = (p2 + p1 + p0 + 2 * q0 + q1 + q2 + q3 + 4) >> 3;
            out[NS + 1] = (p1 + p0 + q0 + 2 * q1 + q2 + q3 + q3 + 4) >> 3;
            out[NS + 2] = (p0 + q0 + q1 + 2 * q2 + q3 + q3 + q3 + 4) >> 3;
            return 7;
        }
        if (full) {
            out[5] = (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0 +
                      8) >> 4;
            out[4] = (p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 +
                      q1 + 8) >> 4;
            out[3] = (p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 +
                      q1 + q2 + 8) >> 4;
            out[2] = (p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 +
                      q1 + q2 + q3 + 8) >> 4;
            out[1] = (p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 +
                      q1 + q2 + q3 + q4 + 8) >> 4;
            out[0] = (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 +
                      q2 + q3 + q4 + q5 + 8) >> 4;
            out[NS] = (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 +
                       q2 + q3 + q4 + q5 + q6 + 8) >> 4;
            out[NS + 1] = (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 +
                           q2 * 2 + q3 + q4 + q5 + q6 * 2 + 8) >> 4;
            out[NS + 2] = (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 +
                           q3 * 2 + q4 + q5 + q6 * 3 + 8) >> 4;
            out[NS + 3] = (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 +
                           q4 * 2 + q5 + q6 * 4 + 8) >> 4;
            out[NS + 4] = (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 +
                           q5 * 2 + q6 * 5 + 8) >> 4;
            out[NS + 5] = (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 +
                           q6 * 7 + 8) >> 4;
            return 63;
        }
        return 0;
    }
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
