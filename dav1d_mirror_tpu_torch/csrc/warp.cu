// Affine warp of a batch of 8x8 units, in one launch: a frame program's
// `warp` record (put, stored into the plane) or a compound side's "w"
// sub-op (prep, stored into its slots of the frame's slot arena).
//
// Replaces, on the port's executor path, what XLA fused on the TPU:
// dav1d_mirror_tpu/ops/mc_tpu.py::warp8x8_batch (:366) followed by
// scatter_units (:266) or scatter_slot_units (:316); not a Pallas kernel.
// Its plain PyTorch versions are dav1d_mirror_tpu_torch/ops/mc.py::
// warp_plane and warp_slots (dav1d mc_tmpl.c warp_affine_8x8:758 /
// warp_affine_8x8t:793).
//
//   row   = (ref, oy, ox, mx, my, alpha, beta, gamma, delta, pad)
//   win[r][c] = ref[n][clamp(oy + r, 0, H - 1)][clamp(ox + c, 0, W - 1)],
//               r, c in 0..14
//   mid[y][x] = (sum_k F(mx + x alpha + y beta)[k] win[y][x + k] + rs)
//               >> (7 - ib), y in 0..14, x in 0..7
//   out[y][x] = sum_k F(my + x gamma + y delta)[k] mid[y + k][x]:
//               put  clamp((out + rl) >> (7 + ib), 0, bd_max)
//               prep ((out + 64) >> 7) - bias
// with F(p) the row 64 + ((p + 512) >> 10) of the 193 x 8 warp filter
// table (a negative row counted from the table's end, then clamped into
// it, as the reference's gather takes it), rs = (1 << (7 - ib)) >> 1,
// rl = (1 << (7 + ib)) >> 1, bias 8192 above 8 bit.
//
// Destinations: the plane at (ys + y, xs + x), a pixel outside the plane
// dropped (PAD_OOB pad rows among them); or the flat slot buffer at
// base + y * row_w + x, an offset outside it dropped. The planner's warp
// units are disjoint, and a "w" sub-op's pad rows repeat its last unit
// with the same base and the same values, so plain stores in any order
// give the plain version's result.
//
// Bound on the H100: bytes. A unit reads its 15 x 15 int32 window (the
// windows of neighbouring units overlap by 7 pixels, so the distinct
// reference pixels are about 1.6x its 64 outputs at 8x8 pitch) and ten
// descriptors, and writes 64 int32 pixels; its 1,472 multiply-adds are
// about 6 int32 operations a byte, under the card's ratio of about 20.
//
// Design: a CTA of WP_UNITS units, 64 threads a unit. The table is
// staged from __constant__ (int8) into shared memory once a CTA: the
// phases differ per pixel, and constant memory serialises divergent
// reads. Each unit's window is read once into shared memory (clamped
// addresses give AV1's edge replication), the 15 x 8 horizontal pass
// writes a shared `mid`, and each thread computes one output pixel of
// the vertical pass and stores it straight into its destination.
#include <cuda_runtime.h>
#include <stdint.h>

#define WP_UNITS 4
#define WP_THREADS (64 * WP_UNITS)
#define WARP_ROWS 193
#define WIN 15

typedef struct {
    const int32_t* rows;   // (B, 10) descriptor rows
    const int32_t* ys;     // plane destination rows (null: slot mode)
    const int32_t* xs;     // plane destination columns
    const int32_t* base;   // slot mode: flat offsets into dst
    const int32_t* ref;    // (R, H, W) int32 reference stack
    int32_t* dst;          // the plane, or the flat slot buffer
    long long ref_pstride;
    long long dst_n;       // slot mode: the buffer's elements
    int ref_rstride, ref_n, ref_h, ref_w;
    int dst_h, dst_w, dst_rstride;    // plane mode
    int row_w;             // slot mode: the slot buffer's row width
    int B, ib, bias, bd_max, prep;
} WarpArgs;

__constant__ __align__(16) int8_t c_warp[WARP_ROWS * 8];

// the table row of phase p, as ops/mc.py::_warp_filters takes it
__device__ __forceinline__ int warp_row(int p) {
    int r = 64 + ((p + 512) >> 10);
    if (r < 0) r += WARP_ROWS;
    return min(max(r, 0), WARP_ROWS - 1);
}

__device__ __forceinline__ int dot8(const int8_t* f, const int32_t* v,
                                    int step) {
    const char4 lo = *reinterpret_cast<const char4*>(f);
    const char4 hi = *reinterpret_cast<const char4*>(f + 4);
    return lo.x * v[0] + lo.y * v[step] + lo.z * v[2 * step] +
           lo.w * v[3 * step] + hi.x * v[4 * step] + hi.y * v[5 * step] +
           hi.z * v[6 * step] + hi.w * v[7 * step];
}

__global__ void __launch_bounds__(WP_THREADS)
    warp_kernel(const __grid_constant__ WarpArgs a) {
    __shared__ __align__(16) int8_t s_f[WARP_ROWS * 8];
    __shared__ int32_t s_win[WP_UNITS][WIN * WIN];
    __shared__ int32_t s_mid[WP_UNITS][WIN * 8];
    __shared__ int32_t s_row[WP_UNITS][10];
    const int tid = threadIdx.x, u = tid >> 6, t = tid & 63;
    for (int i = tid; i < WARP_ROWS * 2; i += WP_THREADS)
        reinterpret_cast<int32_t*>(s_f)[i] =
            reinterpret_cast<const int32_t*>(c_warp)[i];
    const long long unit = (long long)blockIdx.x * WP_UNITS + u;
    const bool live = unit < a.B;
    if (live && t < 10) s_row[u][t] = a.rows[unit * 10 + t];
    __syncthreads();
    const int* r = s_row[u];
    if (live) {
        const int n = min(max(r[0], 0), a.ref_n - 1);
        const int32_t* src = a.ref + n * a.ref_pstride;
        for (int i = t; i < WIN * WIN; i += 64) {
            const int wr = i / WIN, wc = i - wr * WIN;
            const int y = min(max(r[1] + wr, 0), a.ref_h - 1);
            const int x = min(max(r[2] + wc, 0), a.ref_w - 1);
            s_win[u][i] = src[(long long)y * a.ref_rstride + x];
        }
    }
    __syncthreads();
    if (live) {
        const int sh = 7 - a.ib, rnd = (1 << sh) >> 1;
        for (int i = t; i < WIN * 8; i += 64) {
            const int y = i >> 3, x = i & 7;
            const int f = warp_row(r[3] + x * r[5] + y * r[6]);
            s_mid[u][i] = (dot8(s_f + 8 * f, &s_win[u][y * WIN + x], 1) +
                           rnd) >> sh;
        }
    }
    __syncthreads();
    if (!live) return;
    const int y = t >> 3, x = t & 7;
    const int f = warp_row(r[4] + x * r[7] + y * r[8]);
    const int s = dot8(s_f + 8 * f, &s_mid[u][y * 8 + x], 8);
    int v;
    if (a.prep) {
        v = ((s + 64) >> 7) - a.bias;
    } else {
        const int sh = 7 + a.ib;
        v = min(max((s + ((1 << sh) >> 1)) >> sh, 0), a.bd_max);
    }
    if (a.ys) {
        const int py = a.ys[unit] + y, px = a.xs[unit] + x;
        if (py >= 0 && py < a.dst_h && px >= 0 && px < a.dst_w)
            a.dst[(long long)py * a.dst_rstride + px] = v;
    } else {
        const long long o = (long long)a.base[unit] +
                            (long long)y * a.row_w + x;
        if (o >= 0 && o < a.dst_n) a.dst[o] = v;
    }
}

extern "C" int warp_init(const void* table) {
    return (int)cudaMemcpyToSymbol(c_warp, table, sizeof(c_warp));
}

extern "C" int warp_args_size() { return (int)sizeof(WarpArgs); }

// One launch over a's B units on `stream`. Returns cudaGetLastError().
extern "C" int warp_launch(const WarpArgs* a, void* stream) {
    if (a->B <= 0) return 0;
    if (a->ib < 0 || a->ib > 6 || a->ref_n <= 0)
        return (int)cudaErrorInvalidValue;
    const int grid = (a->B + WP_UNITS - 1) / WP_UNITS;
    warp_kernel<<<grid, WP_THREADS, 0, (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" const char* warp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
