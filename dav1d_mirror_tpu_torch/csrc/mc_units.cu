// Translational unit MC with its destination write fused: one launch per
// bucket of (uw x uh) units, any of the four (has_h, has_v) cases, put or
// prep, each output pixel stored straight into the frame plane or into
// the unit's slot of a compound / OBMC slot buffer.
//
// Replaces, on the port's executor path, what XLA fused on the TPU:
// dav1d_mirror_tpu/ops/mc_tpu.py::mc_unit_batch (:53) followed by
// scatter_units (:266) or set_slots (:310); not a Pallas kernel. Its
// plain PyTorch versions are dav1d_mirror_tpu_torch/ops/mc.py::
// mc_units_plane and mc_units_slots (mc_unit_batch composed with
// scatter_units / set_slots).
//
//   win[r][c] = ref[n][clamp(oy + r, 0, H - 1)][clamp(ox + c, 0, W - 1)]
//   taps      = subpel[row][m - 1], row = (side <= 4) ? 3 + (type & 1)
//               : type, type from the Filter2d table (f2d)
//   H+V:  mid = (sum_k th_k win[r][c+k] + rs) >> (6 - ib)
//         put  clamp((sum_k tv_k mid[r+k][c] + rl) >> (6 + ib))
//         prep ((sum_k tv_k mid[r+k][c] + 32) >> 6) - bias
//   H:    put  clamp((hsum + 32 + rs) >> 6), prep ((hsum + rs) >> (6-ib)) - bias
//   V:    put  clamp((vsum + 32) >> 6),      prep ((vsum + rs) >> (6-ib)) - bias
//   copy: put  win,                          prep (win << ib) - bias
// with rs = (1 << (6 - ib)) >> 1, rl = (1 << (6 + ib)) >> 1, bias 8192
// above 8 bit.
//
// Destinations: a plane at (ys + r, xs + c), a pixel outside the plane
// dropped (so the planner's PAD_OOB and OOB16 pad rows write nothing:
// ops/mc.unit_index's mask, with no compaction); or slot s of an
// (N, uh, uw) buffer, a slot outside [0, N) dropped. Pad rows repeat a
// real unit's values (or aim at the sacrificial slot), so plain stores
// in any order give the plain version's result.
//
// Descriptors are read in place from the frame's int16 or int32
// descriptor buffer (flags), so the executor widens nothing.
//
// Bound on the H100: bytes. Each unit reads its (uh + 7) x (uw + 7)
// int32 window (at most; less without H or V), six descriptors and its
// origin, and writes uh x uw int32 pixels; the 8- or 16-tap sums per
// output are far below the int32 rate. At the decode's batch sizes the
// time is the launch and one wave of CTAs.
//
// Design: a CTA takes one tile (at most 32 x 32 outputs) of each of G
// units of the bucket (G = 1 for tiles of 32 x 32, up to 64 for 2 x 2
// units, at most 1024 outputs a CTA), so small units fill a CTA and large
// ones (up to 128 x 128) spread over 16 CTAs without sizing shared
// memory for a whole 135 x 135 window:
// - the G units' descriptors and taps go to shared memory once;
// - the G windows are staged in shared memory, coalesced along rows;
// - with H and V, the H pass writes a shared `mid`, then the V pass;
// - each thread computes its outputs and stores them to the destination.
#include <cuda_runtime.h>
#include <stdint.h>

#define MU_THREADS 256
#define MU_TILE 32           // a tile is at most MU_TILE x MU_TILE outputs
#define MU_MAX_G 64          // units a CTA
#define MU_MAX_OUT 1024      // outputs a CTA
#define MU_SMEM (36 * 1024)  // dynamic shared memory a CTA, at most

#define MU_ARR16 1
#define MU_YS16 2
#define MU_XS16 4

typedef struct {
    const void* ref;       // int32 (R, H, W), rows ref_rstride apart
    const void* arr;       // (B, 6) rows (ref, oy, ox, mx, my, f2d)
    const void* ys;        // (B,) destination rows, or slots (slot mode)
    const void* xs;        // (B,) destination columns; NULL: slot mode
    void* dst;             // int32 plane, or (dst_h, uh, uw) slots
    long long ref_pstride;
    int ref_rstride, H, W;
    int B, uw, uh, has_h, has_v;
    int ib, bias, bd_max, prep;
    int flags;             // MU_ARR16 | MU_YS16 | MU_XS16
    int dst_h, dst_w, dst_rstride;
} McuArgs;

__constant__ int32_t c_subpel[6 * 15 * 8];
__constant__ int32_t c_f2d[9][2] = {{0, 0}, {0, 1}, {0, 2}, {2, 0}, {2, 1},
                                    {2, 2}, {1, 0}, {1, 1}, {1, 2}};

__device__ __forceinline__ int ld(const void* p, long long i, int is16) {
    return is16 ? (int)((const int16_t*)p)[i] : ((const int32_t*)p)[i];
}

// the offset of the filter row in c_subpel; subpel 0 indexes -1, which
// wraps to the last phase as the plain version's tensor index does
__device__ __forceinline__ int filter_off(int type, int subpel, int side) {
    const int row = side <= 4 ? 3 + (type & 1) : type;
    int s = subpel - 1;
    if (s < 0) s += 15;
    return (row * 15 + min(max(s, 0), 14)) * 8;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(MU_THREADS)
mc_units_kernel(McuArgs a, int tw, int th, int tiles_x, int G) {
    extern __shared__ int32_t sm[];
    __shared__ int32_t s_d[MU_MAX_G][5];      // ref, oy, ox, dy|slot, dx
    __shared__ int32_t s_f[MU_MAX_G][16];     // H taps, V taps
    const int b0 = blockIdx.x * G;
    const int gn = min(G, a.B - b0);
    const int ty0 = (blockIdx.y / tiles_x) * th;
    const int tx0 = (blockIdx.y % tiles_x) * tw;
    const int hh = a.has_h, hv = a.has_v;
    const int wh = th + (hv ? 7 : 0), ww = tw + (hh ? 7 : 0);
    int32_t* win = sm;                        // [gn][wh][ww]
    int32_t* mid = sm + G * wh * ww;          // [gn][wh][tw] (H and V)

    for (int g = threadIdx.x; g < gn; g += MU_THREADS) {
        const long long b = b0 + g;
        const int a16 = a.flags & MU_ARR16;
        const int ref = ld(a.arr, b * 6 + 0, a16);
        const int mx = ld(a.arr, b * 6 + 3, a16);
        const int my = ld(a.arr, b * 6 + 4, a16);
        const int f2d = clampi(ld(a.arr, b * 6 + 5, a16), 0, 8);
        s_d[g][0] = ref;
        s_d[g][1] = ld(a.arr, b * 6 + 1, a16) + ty0;
        s_d[g][2] = ld(a.arr, b * 6 + 2, a16) + tx0;
        s_d[g][3] = ld(a.ys, b, a.flags & MU_YS16);
        s_d[g][4] = a.xs ? ld(a.xs, b, a.flags & MU_XS16) : 0;
        const int fh = hh ? filter_off(c_f2d[f2d][0], mx, a.uw) : 0;
        const int fv = hv ? filter_off(c_f2d[f2d][1], my, a.uh) : 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            s_f[g][k] = c_subpel[fh + k];
            s_f[g][8 + k] = c_subpel[fv + k];
        }
    }
    __syncthreads();

    // the windows of the G unit tiles, clamped into the reference
    const int wn = wh * ww;
    const int32_t* ref = (const int32_t*)a.ref;
    for (int i = threadIdx.x; i < gn * wn; i += MU_THREADS) {
        const int g = i / wn, j = i - g * wn;
        const int r = j / ww, c = j - r * ww;
        const int y = clampi(s_d[g][1] + r, 0, a.H - 1);
        const int x = clampi(s_d[g][2] + c, 0, a.W - 1);
        win[i] = ref[s_d[g][0] * a.ref_pstride +
                     (long long)y * a.ref_rstride + x];
    }
    __syncthreads();

    const int sh = 6 - a.ib;
    const int rs = (1 << sh) >> 1;
    if (hh && hv) {
        const int mn = wh * tw;
        for (int i = threadIdx.x; i < gn * mn; i += MU_THREADS) {
            const int g = i / mn, j = i - g * mn;
            const int r = j / tw, c = j - r * tw;
            const int32_t* w = win + g * wn + r * ww + c;
            int acc = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) acc += s_f[g][k] * w[k];
            mid[i] = (acc + rs) >> sh;
        }
        __syncthreads();
    }

    const int on = th * tw;
    const int rl = (1 << (6 + a.ib)) >> 1;
    int32_t* dst = (int32_t*)a.dst;
    for (int i = threadIdx.x; i < gn * on; i += MU_THREADS) {
        const int g = i / on, j = i - g * on;
        const int r = j / tw, c = j - r * tw;
        const int uy = ty0 + r, ux = tx0 + c;
        if (uy >= a.uh || ux >= a.uw) continue;
        int v;
        if (hh && hv) {
            const int32_t* m = mid + g * wh * tw + r * tw + c;
            int acc = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) acc += s_f[g][8 + k] * m[k * tw];
            v = a.prep ? ((acc + 32) >> 6) - a.bias
                       : clampi((acc + rl) >> (6 + a.ib), 0, a.bd_max);
        } else if (hh) {
            const int32_t* w = win + g * wn + r * ww + c;
            int acc = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) acc += s_f[g][k] * w[k];
            v = a.prep ? ((acc + rs) >> sh) - a.bias
                       : clampi((acc + 32 + rs) >> 6, 0, a.bd_max);
        } else if (hv) {
            const int32_t* w = win + g * wn + r * ww + c;
            int acc = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) acc += s_f[g][8 + k] * w[k * ww];
            v = a.prep ? ((acc + rs) >> sh) - a.bias
                       : clampi((acc + 32) >> 6, 0, a.bd_max);
        } else {
            const int p = win[g * wn + r * ww + c];
            v = a.prep ? p * (1 << a.ib) - a.bias : p;
        }
        if (a.xs) {
            const int y = s_d[g][3] + uy, x = s_d[g][4] + ux;
            if (y >= 0 && y < a.dst_h && x >= 0 && x < a.dst_w)
                dst[(long long)y * a.dst_rstride + x] = v;
        } else {
            const int s = s_d[g][3];
            if (s >= 0 && s < a.dst_h)
                dst[((long long)s * a.uh + uy) * a.uw + ux] = v;
        }
    }
}

extern "C" int mc_units_init(const void* subpel) {
    return (int)cudaMemcpyToSymbol(c_subpel, subpel, sizeof(c_subpel));
}

extern "C" int mc_units_args_size() { return (int)sizeof(McuArgs); }

extern "C" int mc_units_launch(const McuArgs* a, void* stream) {
    if (a->B <= 0) return 0;
    if (a->uw <= 0 || a->uh <= 0 || a->ib < 0 || a->ib > 6)
        return (int)cudaErrorInvalidValue;
    const int tw = min(a->uw, MU_TILE), th = min(a->uh, MU_TILE);
    const int tiles_x = (a->uw + tw - 1) / tw;
    const int tiles = tiles_x * ((a->uh + th - 1) / th);
    const int wh = th + (a->has_v ? 7 : 0), ww = tw + (a->has_h ? 7 : 0);
    const int per_unit =
        4 * (wh * ww + (a->has_h && a->has_v ? wh * tw : 0));
    int G = min(MU_MAX_G, max(1, MU_MAX_OUT / (tw * th)));
    G = max(1, min(G, MU_SMEM / per_unit));
    G = min(G, a->B);
    const dim3 grid((a->B + G - 1) / G, tiles);
    mc_units_kernel<<<grid, MU_THREADS, G * per_unit,
                      (cudaStream_t)stream>>>(*a, tw, th, tiles_x, G);
    return (int)cudaGetLastError();
}

extern "C" const char* mc_units_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
