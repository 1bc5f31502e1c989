// Scaled-reference unit MC with its destination write fused: one launch
// per bucket of (uw x uh) units whose reference has another size than the
// frame (dav1d mc_tmpl.c put/prep_8tap_scaled:172/287), put or prep, each
// output pixel stored straight into the frame plane or at its flat offset
// in a compound / OBMC slot buffer.
//
// Replaces, on the port's executor path, what XLA fused on the TPU:
// dav1d_mirror_tpu/ops/mc_tpu.py::mc_scaled_batch (:473) followed by
// scatter_units (:266) or scatter_slot_units (:316); not a Pallas kernel.
// Its plain PyTorch versions are dav1d_mirror_tpu_torch/ops/mc.py::
// mc_scaled_plane and mc_scaled_slots.
//
// A unit's row (ref, top, left, mxf, myf, dx, dy, f2d, pad) gives its
// (2uh + 10) x (2uw + 10) window at (top - 3, left - 3), clamped into the
// reference, and its phases: column x steps from mxf by dx, row y from myf
// by dy (1/1024 pixel):
//   phx = mxf + x dx, subx = (phx & 1023) >> 6, col(k) = clamp((phx >> 10)
//   + k, 0, win_w - 1)
//   mid[r][x] = subx ? (sum_k th_k win[r][col(k)] + rs) >> (6 - ib)
//                    : win[r][col(3)] << ib
//   phy, suby and row(k) likewise over mid's win_h rows
//   put:  suby ? clamp((sum_k tv_k mid[row(k)][x] + rl) >> (6 + ib))
//              : clamp((mid[row(3)][x] + ((1 << ib) >> 1)) >> ib)
//   prep: suby ? ((sum_k tv_k mid[row(k)][x] + 32) >> 6) - bias
//              : mid[row(3)][x] - bias
// taps = subpel[row][max(sub, 1) - 1], row = (side <= 4) ? 3 + (type & 1)
// : type.
//
// Destinations: a plane at (ys + y, xs + x), a pixel outside the plane
// dropped (PAD_OOB pad rows write nothing); or the flat offset
// base + y row_w + x of the slot buffer, an offset outside it dropped.
//
// Precondition: AV1's scale limits, 0 <= mxf, myf < 1024 and 0 < dx, dy
// <= 2048 (a reference at most twice the frame's size), as
// models/inter.py's _scale_fac gives them. Outside them a V tap reads the
// nearest mid row the tile holds: in bounds, but not dav1d's value.
//
// Bound on the H100: bytes. Each unit reads at most its window (the
// reference rows its phases touch, about (2uh + 8) x (2uw + 8) int32),
// nine descriptors and its origin, and writes uh x uw int32 pixels.
//
// Design: a CTA takes one tile (at most 32 x 32 outputs) of each of G
// units (up to 64 units of 2 x 2, at most 1024 outputs a CTA). The H pass
// computes, for the tile's columns, the mid rows that the tile's V taps
// can reach (2 th + 8 rows from the tile's first row phase) into shared
// memory, reading the reference through L1 (the per-column phases make
// each column's 8 taps a gather); the V pass reads them from there. The
// subpel table is copied from __constant__ to shared memory, since the
// lanes of a warp read different phases.
#include <cuda_runtime.h>
#include <stdint.h>

#define MS_THREADS 256
#define MS_TILE 32
#define MS_MAX_G 64
#define MS_MAX_OUT 1024
#define MS_SMEM (36 * 1024)

typedef struct {
    const void* ref;       // int32 (R, H, W), rows ref_rstride apart
    const void* rows;      // int32 (B, 9) rows
    const void* ys;        // int32 (B,) destination rows, or flat bases
    const void* xs;        // int32 (B,) destination columns; NULL: flat
    void* dst;             // int32 plane, or the flat slot buffer
    long long ref_pstride;
    long long dst_n;       // flat mode: elements of the slot buffer
    int ref_rstride, H, W;
    int B, uw, uh;
    int ib, bias, bd_max, prep;
    int dst_h, dst_w, dst_rstride, row_w;
} McsArgs;

__constant__ int32_t c_subpel[6 * 15 * 8];
__constant__ int32_t c_f2d[9][2] = {{0, 0}, {0, 1}, {0, 2}, {2, 0}, {2, 1},
                                    {2, 2}, {1, 0}, {1, 1}, {1, 2}};

enum { D_REF, D_TOP, D_LEFT, D_MXF, D_MYF, D_DX, D_DY, D_TH, D_TV, D_Y,
       D_X, D_RLO, D_N };

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

__device__ __forceinline__ int filter_off(int type, int sub, int side) {
    const int row = side <= 4 ? 3 + (type & 1) : type;
    return (row * 15 + clampi(sub, 1, 15) - 1) * 8;
}

// mid[rr][x] of unit d: the H pass at window row rr, output column x
__device__ __forceinline__ int mid_at(const McsArgs& a, const int32_t* d,
                                      const int32_t* tab, int rr, int x) {
    const int win_w = 2 * a.uw + 10;
    const int phx = d[D_MXF] + x * d[D_DX];
    const int subx = (phx & 0x3FF) >> 6, offx = phx >> 10;
    const int y = clampi(d[D_TOP] - 3 + rr, 0, a.H - 1);
    const int32_t* row = (const int32_t*)a.ref + d[D_REF] * a.ref_pstride +
                         (long long)y * a.ref_rstride;
    const int x0 = d[D_LEFT] - 3;
    if (subx == 0)
        return row[clampi(x0 + clampi(offx + 3, 0, win_w - 1), 0,
                          a.W - 1)] * (1 << a.ib);
    const int32_t* f = tab + filter_off(d[D_TH], subx, a.uw);
    int acc = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
        acc += f[k] * row[clampi(x0 + clampi(offx + k, 0, win_w - 1), 0,
                                 a.W - 1)];
    const int sh = 6 - a.ib;
    return (acc + ((1 << sh) >> 1)) >> sh;
}

__global__ void __launch_bounds__(MS_THREADS)
mc_scaled_kernel(McsArgs a, int tw, int th, int tiles_x, int G, int mr) {
    extern __shared__ int32_t mid[];              // [gn][mr][tw]
    __shared__ int32_t tab[6 * 15 * 8];
    __shared__ int32_t s_d[MS_MAX_G][D_N];
    const int b0 = blockIdx.x * G;
    const int gn = min(G, a.B - b0);
    const int ty0 = (blockIdx.y / tiles_x) * th;
    const int tx0 = (blockIdx.y % tiles_x) * tw;
    const int win_h = 2 * a.uh + 10;

    for (int i = threadIdx.x; i < 6 * 15 * 8; i += MS_THREADS)
        tab[i] = c_subpel[i];
    for (int g = threadIdx.x; g < gn; g += MS_THREADS) {
        const int32_t* r = (const int32_t*)a.rows + (long long)(b0 + g) * 9;
        int32_t* d = s_d[g];
        d[D_REF] = r[0];
        d[D_TOP] = r[1];
        d[D_LEFT] = r[2];
        d[D_MXF] = r[3];
        d[D_MYF] = r[4];
        d[D_DX] = r[5];
        d[D_DY] = r[6];
        const int f2d = clampi(r[7], 0, 8);
        d[D_TH] = c_f2d[f2d][0];
        d[D_TV] = c_f2d[f2d][1];
        d[D_Y] = ((const int32_t*)a.ys)[b0 + g];
        d[D_X] = a.xs ? ((const int32_t*)a.xs)[b0 + g] : 0;
        d[D_RLO] = clampi((r[4] + ty0 * r[6]) >> 10, 0, win_h - 1);
    }
    __syncthreads();

    // H pass: the mid rows [rlo, rlo + mr) of the tile's columns
    const int mn = mr * tw;
    for (int i = threadIdx.x; i < gn * mn; i += MS_THREADS) {
        const int g = i / mn, j = i - g * mn;
        const int r = j / tw, c = j - r * tw;
        const int rr = s_d[g][D_RLO] + r;
        if (rr < win_h && tx0 + c < a.uw)
            mid[i] = mid_at(a, s_d[g], tab, rr, tx0 + c);
    }
    __syncthreads();

    // V pass and the write
    const int on = th * tw;
    const int ib = a.ib;
    const int rl = (1 << (6 + ib)) >> 1, irnd = (1 << ib) >> 1;
    int32_t* dst = (int32_t*)a.dst;
    for (int i = threadIdx.x; i < gn * on; i += MS_THREADS) {
        const int g = i / on, j = i - g * on;
        const int r = j / tw, c = j - r * tw;
        const int y = ty0 + r, x = tx0 + c;
        if (y >= a.uh || x >= a.uw) continue;
        const int32_t* d = s_d[g];
        const int32_t* m = mid + g * mn + c;
        const int phy = d[D_MYF] + y * d[D_DY];
        const int suby = (phy & 0x3FF) >> 6, offy = phy >> 10;
        int v;
        if (suby == 0) {
            const int rr = clampi(offy + 3, 0, win_h - 1);
            const int p = m[clampi(rr - d[D_RLO], 0, mr - 1) * tw];
            v = a.prep ? p - a.bias : clampi((p + irnd) >> ib, 0, a.bd_max);
        } else {
            const int32_t* f = tab + filter_off(d[D_TV], suby, a.uh);
            int acc = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const int rr = clampi(offy + k, 0, win_h - 1);
                acc += f[k] * m[clampi(rr - d[D_RLO], 0, mr - 1) * tw];
            }
            v = a.prep ? ((acc + 32) >> 6) - a.bias
                       : clampi((acc + rl) >> (6 + ib), 0, a.bd_max);
        }
        if (a.xs) {
            const int py = d[D_Y] + y, px = d[D_X] + x;
            if (py >= 0 && py < a.dst_h && px >= 0 && px < a.dst_w)
                dst[(long long)py * a.dst_rstride + px] = v;
        } else {
            const long long o = (long long)d[D_Y] + (long long)y * a.row_w + x;
            if (o >= 0 && o < a.dst_n) dst[o] = v;
        }
    }
}

extern "C" int mc_scaled_init(const void* subpel) {
    return (int)cudaMemcpyToSymbol(c_subpel, subpel, sizeof(c_subpel));
}

extern "C" int mc_scaled_args_size() { return (int)sizeof(McsArgs); }

extern "C" int mc_scaled_launch(const McsArgs* a, void* stream) {
    if (a->B <= 0) return 0;
    if (a->uw <= 0 || a->uh <= 0 || a->ib < 0 || a->ib > 6)
        return (int)cudaErrorInvalidValue;
    const int tw = min(a->uw, MS_TILE), th = min(a->uh, MS_TILE);
    const int tiles_x = (a->uw + tw - 1) / tw;
    const int tiles = tiles_x * ((a->uh + th - 1) / th);
    const int mr = min(2 * th + 8, 2 * a->uh + 10);
    const int per_unit = 4 * mr * tw;
    int G = min(MS_MAX_G, max(1, MS_MAX_OUT / (tw * th)));
    G = max(1, min(G, MS_SMEM / per_unit));
    G = min(G, a->B);
    const dim3 grid((a->B + G - 1) / G, tiles);
    mc_scaled_kernel<<<grid, MS_THREADS, G * per_unit,
                       (cudaStream_t)stream>>>(*a, tw, th, tiles_x, G, mr);
    return (int)cudaGetLastError();
}

extern "C" const char* mc_scaled_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
