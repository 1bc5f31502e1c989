// Translational unit MC of a frame's work list, in one launch: every put
// bucket and every compound side and OBMC lap bucket of whole-block units
// ("t") of a frame, any of the four (has_h, has_v) cases, put or prep,
// each output pixel stored straight into the frame plane or into the
// unit's slot of a slot buffer in the frame's arena.
//
// Replaces, on the port's executor path, what XLA fused on the TPU:
// dav1d_mirror_tpu/ops/mc_tpu.py::mc_unit_batch (:53) followed by
// scatter_units (:266) or set_slots (:310); not a Pallas kernel. Its
// plain PyTorch version is dav1d_mirror_tpu_torch/ops/mc.py::
// mc_units_run (one mc_units_plane or mc_units_slots an entry).
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
// The work list (ops/mc.mc_build_table): MU_ENTRY ints an entry (a
// bucket: unit size, flags, reference stack, destination plane, rows and
// real rows, descriptor offsets in the frame's int32 or int16 buffer,
// its slot buffer's offset and size in the arena, units an item), then
// two an item: entry * 16 + tile, first unit. An item is one tile (at
// most 32 x 32 outputs) of G units of one entry (at most 2048 outputs;
// G = 2 for 32 x 32 tiles, up to 64 for 2 x 2 units), so units of 2 x 2
// to 128 x 128 share one launch and no 135 x 135 window sits in shared
// memory. Only real rows have items: pad rows are neither loaded nor
// computed.
//
// Destinations: a plane at (ys + r, xs + c), a pixel outside the plane
// dropped; or slot s of the entry's (N, uh, uw) slot buffer in the
// arena, a slot outside [0, N) dropped. The units of a frame write
// disjoint pixels and slots (the planner's blocks are disjoint; a
// compound group's pad slot is sacrificial), so plain stores in any order
// give the plain version's result.
//
// Bound on the H100: bytes. A run reads its reference pixels (each unit's
// window, at most (uh + 7) x (uw + 7) int32, neighbouring units' windows
// overlapping), six descriptors and an origin a unit, and writes
// uh x uw int32 pixels a unit; the 8- or 16-tap sums per output are far
// below the int32 rate.
//
// Design: persistent CTAs (as many as fit on the card, at most one an
// item) walk the items at a stride of the grid. Each CTA double-buffers
// its shared memory: while it computes item i, item i + 1's descriptors
// are read and its windows are in flight into the other stage with
// cp.async (4-byte copies from clamped addresses, which give AV1's edge
// replication; TMA would fill outside the reference with zeros). So the
// descriptor -> window -> compute chain of one item overlaps the
// previous item's arithmetic, and a frame's puts, sides and laps are one
// wave of work in place of one launch (and one partial wave) a bucket.
// With H and V, the H pass writes a shared `mid`, then the V pass reads
// it. Shared memory is sized to the run's largest item, two stages. The
// fine-grained loops are bound by instructions: they divide by
// multiplication (fdiv) and read taps as int4.
#include <cuda_runtime.h>
#include <stdint.h>

#define MU_THREADS 256
#define MU_TILE 32           // a tile is at most MU_TILE x MU_TILE outputs
#define MU_MAX_G 64          // units an item
#define MU_ENTRY 16          // ints a table entry
#define MU_REFS 3            // reference stacks (one a plane)
#define MU_PLANES 3

// entry fields and flags (ops/mc.py M_*, MF_*)
enum { M_UW, M_UH, M_FLAGS, M_REF, M_PLANE, M_B, M_NREAL, M_DESC, M_YS,
       M_XS, M_DST, M_DSTN, M_ROWW, M_G, M_ITEM0, M_STEPS };
#define MF_H 1
#define MF_V 2
#define MF_PREP 4
#define MF_ARENA 8
#define MF_DESC16 16
#define MF_YS16 32
#define MF_XS16 64

typedef struct {
    const int32_t* tab;    // entries (MU_ENTRY ints each); null: `one`
    const int32_t* map;    // two ints an item; null with tab null
    const void* base32[3]; // the int32 buffers of rows, ys and xs
    const void* base16[3]; // the int16 ones (MF_*16 flags)
    const void* ref[MU_REFS];         // int32 (R, H, W) stacks
    void* plane[MU_PLANES];           // int32 planes
    void* arena;                      // int32 slot arena
    long long ref_pstride[MU_REFS];
    long long arena_n;
    int ref_rstride[MU_REFS], ref_h[MU_REFS], ref_w[MU_REFS];
    int plane_h[MU_PLANES], plane_w[MU_PLANES], plane_rstride[MU_PLANES];
    int n_items, stage_ints, mid_ints;
    int ib, bias, bd_max;
    int one[MU_ENTRY];     // the entry of a one-entry list (tab null)
} McuRunArgs;

// per stage: the item's entry, then its tile origin, unit count, tile
// and window sizes and the multipliers that divide by them (fdiv)
enum { S_TY0 = MU_ENTRY, S_TX0, S_GN, S_TW, S_TH, S_WH, S_WW, S_MWN, S_MWW,
       S_MMN, S_MTW, S_MON, S_N };

__constant__ int32_t c_subpel[6 * 15 * 8];
__constant__ int32_t c_f2d[9][2] = {{0, 0}, {0, 1}, {0, 2}, {2, 0}, {2, 1},
                                    {2, 2}, {1, 0}, {1, 1}, {1, 2}};

__device__ __forceinline__ int ld(const void* b32, const void* b16,
                                  int narrow, long long i) {
    return narrow ? (int)((const int16_t*)b16)[i]
                  : ((const int32_t*)b32)[i];
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

// n / d as umulhi(n, m) with m = ceil(2^32 / d), exact while n d < 2^32
// (n and d below 2^16 here); d = 1 is m = 0
__device__ __forceinline__ int fdiv(int n, int m) {
    return m ? (int)__umulhi((unsigned)n, (unsigned)m) : n;
}
__device__ __forceinline__ int fdiv_m(int d) {
    return d > 1 ? (int)(0xFFFFFFFFu / (unsigned)d + 1) : 0;
}

// a 4-byte copy from device memory into shared memory that completes in
// the background; the commit of this thread's copies as one group; the
// wait until at most N of its groups are in flight
__device__ __forceinline__ void cp_async4(int32_t* smem, const int32_t* g) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(g));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int ent(const McuRunArgs& a, int e, int i) {
    return a.tab ? a.tab[e * MU_ENTRY + i] : a.one[i];
}

// Read item `it`'s entry and its units' descriptors into stage st: the
// entry and tile origin (s_e), each unit's reference, window origin and
// destination (s_d) and its H and V taps (s_f).
__device__ __forceinline__ void load_item(const McuRunArgs& a, int it,
                                          int* s_e, int (*s_d)[5],
                                          int (*s_f)[16]) {
    int e, tile, u0;
    if (a.tab) {
        const int m = a.map[2 * it];
        e = m >> 4;
        tile = m & 15;
        u0 = a.map[2 * it + 1];
    } else {
        const int tiles = ((a.one[M_UW] + MU_TILE - 1) / MU_TILE) *
                          ((a.one[M_UH] + MU_TILE - 1) / MU_TILE);
        e = 0;
        tile = it % tiles;
        u0 = (it / tiles) * a.one[M_G];
    }
    const int w = ent(a, e, M_UW), h = ent(a, e, M_UH);
    const int fl = ent(a, e, M_FLAGS);
    const int tw = min(w, MU_TILE), th = min(h, MU_TILE);
    const int tiles_x = (w + tw - 1) / tw;
    const int ty0 = (tile / tiles_x) * th, tx0 = (tile % tiles_x) * tw;
    const int gn = min(ent(a, e, M_G), ent(a, e, M_NREAL) - u0);
    if (threadIdx.x < MU_ENTRY) s_e[threadIdx.x] = ent(a, e, threadIdx.x);
    if (threadIdx.x == 0) {
        const int wh = th + (fl & MF_V ? 7 : 0), ww = tw + (fl & MF_H ? 7 : 0);
        s_e[S_TY0] = ty0;
        s_e[S_TX0] = tx0;
        s_e[S_GN] = gn;
        s_e[S_TW] = tw;
        s_e[S_TH] = th;
        s_e[S_WH] = wh;
        s_e[S_WW] = ww;
        s_e[S_MWN] = fdiv_m(wh * ww);
        s_e[S_MWW] = fdiv_m(ww);
        s_e[S_MMN] = fdiv_m(wh * tw);
        s_e[S_MTW] = fdiv_m(tw);
        s_e[S_MON] = fdiv_m(th * tw);
    }
    for (int g = threadIdx.x; g < gn; g += MU_THREADS) {
        const long long b = u0 + g;
        const long long r6 = ent(a, e, M_DESC) + b * 6;
        const int n16 = fl & MF_DESC16;
        const int mx = ld(a.base32[0], a.base16[0], n16, r6 + 3);
        const int my = ld(a.base32[0], a.base16[0], n16, r6 + 4);
        const int f2d = clampi(ld(a.base32[0], a.base16[0], n16, r6 + 5),
                               0, 8);
        s_d[g][0] = ld(a.base32[0], a.base16[0], n16, r6);
        s_d[g][1] = ld(a.base32[0], a.base16[0], n16, r6 + 1) + ty0;
        s_d[g][2] = ld(a.base32[0], a.base16[0], n16, r6 + 2) + tx0;
        s_d[g][3] = ld(a.base32[1], a.base16[1], fl & MF_YS16,
                       ent(a, e, M_YS) + b);
        s_d[g][4] = fl & MF_ARENA ? 0
                    : ld(a.base32[2], a.base16[2], fl & MF_XS16,
                         ent(a, e, M_XS) + b);
        const int fh = fl & MF_H ? filter_off(c_f2d[f2d][0], mx, w) : 0;
        const int fv = fl & MF_V ? filter_off(c_f2d[f2d][1], my, h) : 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            s_f[g][k] = c_subpel[fh + k];
            s_f[g][8 + k] = c_subpel[fv + k];
        }
    }
}

// Start the copies of stage st's windows (the G unit tiles' windows,
// clamped into the reference) and commit them as one group.
__device__ __forceinline__ void issue_windows(const McuRunArgs& a,
                                              const int* s_e,
                                              const int (*s_d)[5],
                                              int32_t* win) {
    const int r = s_e[M_REF];
    const int ww = s_e[S_WW], wn = s_e[S_WH] * ww;
    const int mwn = s_e[S_MWN], mww = s_e[S_MWW];
    const int32_t* ref = (const int32_t*)a.ref[r];
    const long long ps = a.ref_pstride[r];
    const int rs = a.ref_rstride[r], H = a.ref_h[r], W = a.ref_w[r];
    for (int i = threadIdx.x; i < s_e[S_GN] * wn; i += MU_THREADS) {
        const int g = fdiv(i, mwn), j = i - g * wn;
        const int rr = fdiv(j, mww), c = j - rr * ww;
        const int y = clampi(s_d[g][1] + rr, 0, H - 1);
        const int x = clampi(s_d[g][2] + c, 0, W - 1);
        cp_async4(win + i, ref + s_d[g][0] * ps + (long long)y * rs + x);
    }
    cp_async_commit();
}

// The stage's outputs: the H pass into `mid` (H and V), then each
// thread's outputs, stored to the plane or the arena.
__device__ __forceinline__ void compute(const McuRunArgs& a, const int* s_e,
                                        const int (*s_d)[5],
                                        const int (*s_f)[16],
                                        const int32_t* win, int32_t* mid) {
    const int fl = s_e[M_FLAGS], uw = s_e[M_UW], uh = s_e[M_UH];
    const int hh = fl & MF_H, hv = fl & MF_V, prep = fl & MF_PREP;
    const int tw = s_e[S_TW], th = s_e[S_TH];
    const int wh = s_e[S_WH], ww = s_e[S_WW];
    const int wn = wh * ww, gn = s_e[S_GN];
    const int mtw = s_e[S_MTW];
    const int ty0 = s_e[S_TY0], tx0 = s_e[S_TX0];
    const int sh = 6 - a.ib;
    const int rs = (1 << sh) >> 1;
    if (hh && hv) {
        const int mn = wh * tw, mmn = s_e[S_MMN];
        for (int i = threadIdx.x; i < gn * mn; i += MU_THREADS) {
            const int g = fdiv(i, mmn), j = i - g * mn;
            const int r = fdiv(j, mtw), c = j - r * tw;
            const int32_t* w = win + g * wn + r * ww + c;
            const int4 f0 = *(const int4*)&s_f[g][0];
            const int4 f1 = *(const int4*)&s_f[g][4];
            const int acc = f0.x * w[0] + f0.y * w[1] + f0.z * w[2] +
                            f0.w * w[3] + f1.x * w[4] + f1.y * w[5] +
                            f1.z * w[6] + f1.w * w[7];
            mid[i] = (acc + rs) >> sh;
        }
        __syncthreads();
    }

    const int on = th * tw, mon = s_e[S_MON];
    const int rl = (1 << (6 + a.ib)) >> 1;
    const int pl = s_e[M_PLANE];
    int32_t* dst = (int32_t*)(fl & MF_ARENA ? a.arena : a.plane[pl]);
    for (int i = threadIdx.x; i < gn * on; i += MU_THREADS) {
        const int g = fdiv(i, mon), j = i - g * on;
        const int r = fdiv(j, mtw), c = j - r * tw;
        const int uy = ty0 + r, ux = tx0 + c;
        if (uy >= uh || ux >= uw) continue;
        int v;
        if (hv) {
            // the V taps over mid (H and V) or over the window (V)
            const int4 f0 = *(const int4*)&s_f[g][8];
            const int4 f1 = *(const int4*)&s_f[g][12];
            const int32_t* m = hh ? mid + g * wh * tw + r * tw + c
                                  : win + g * wn + r * ww + c;
            const int st = hh ? tw : ww;
            const int acc = f0.x * m[0] + f0.y * m[st] + f0.z * m[2 * st] +
                            f0.w * m[3 * st] + f1.x * m[4 * st] +
                            f1.y * m[5 * st] + f1.z * m[6 * st] +
                            f1.w * m[7 * st];
            if (hh)
                v = prep ? ((acc + 32) >> 6) - a.bias
                         : clampi((acc + rl) >> (6 + a.ib), 0, a.bd_max);
            else
                v = prep ? ((acc + rs) >> sh) - a.bias
                         : clampi((acc + 32) >> 6, 0, a.bd_max);
        } else if (hh) {
            const int32_t* w = win + g * wn + r * ww + c;
            const int4 f0 = *(const int4*)&s_f[g][0];
            const int4 f1 = *(const int4*)&s_f[g][4];
            const int acc = f0.x * w[0] + f0.y * w[1] + f0.z * w[2] +
                            f0.w * w[3] + f1.x * w[4] + f1.y * w[5] +
                            f1.z * w[6] + f1.w * w[7];
            v = prep ? ((acc + rs) >> sh) - a.bias
                     : clampi((acc + 32 + rs) >> 6, 0, a.bd_max);
        } else {
            const int p = win[g * wn + r * ww + c];
            v = prep ? p * (1 << a.ib) - a.bias : p;
        }
        if (fl & MF_ARENA) {
            const long long s = s_d[g][3], n = (long long)uh * uw;
            if (s >= 0 && (s + 1) * n <= s_e[M_DSTN])
                dst[s_e[M_DST] + s * n + (long long)uy * uw + ux] = v;
        } else {
            const int y = s_d[g][3] + uy, x = s_d[g][4] + ux;
            if (y >= 0 && y < a.plane_h[pl] && x >= 0 && x < a.plane_w[pl])
                dst[(long long)y * a.plane_rstride[pl] + x] = v;
        }
    }
}

__global__ void __launch_bounds__(MU_THREADS)
    mc_units_run_kernel(const __grid_constant__ McuRunArgs a) {
    extern __shared__ int32_t sm[];   // [2][stage_ints] windows, mid
    __shared__ int s_e[2][S_N];
    __shared__ int s_d[2][MU_MAX_G][5];    // ref, oy, ox, dy|slot, dx
    __shared__ __align__(16) int s_f[2][MU_MAX_G][16];   // H, V taps
    int32_t* mid = sm + 2 * a.stage_ints;
    int it = blockIdx.x, st = 0;
    if (it >= a.n_items) return;
    load_item(a, it, s_e[0], s_d[0], s_f[0]);
    __syncthreads();
    issue_windows(a, s_e[0], s_d[0], sm);
    for (; it < a.n_items; it += gridDim.x) {
        const int nx = it + gridDim.x;
        // the next item's descriptors, under this item's copies
        if (nx < a.n_items) load_item(a, nx, s_e[st ^ 1], s_d[st ^ 1],
                                      s_f[st ^ 1]);
        __syncthreads();
        if (nx < a.n_items)
            issue_windows(a, s_e[st ^ 1], s_d[st ^ 1],
                          sm + (st ^ 1) * a.stage_ints);
        else
            cp_async_commit();   // an empty group: the wait below is one
        cp_async_wait<1>();      // this item's windows have landed
        __syncthreads();
        compute(a, s_e[st], s_d[st], s_f[st], sm + st * a.stage_ints, mid);
        __syncthreads();         // the next load reuses this stage
        st ^= 1;
    }
}

extern "C" int mc_units_init(const void* subpel) {
    return (int)cudaMemcpyToSymbol(c_subpel, subpel, sizeof(c_subpel));
}

extern "C" int mc_units_args_size() { return (int)sizeof(McuRunArgs); }

// One launch over a's items on `stream`: persistent CTAs, as many as fit
// on the card with the run's shared memory (two stages of stage_ints and
// mid_ints), at most one an item. Returns cudaGetLastError().
extern "C" int mc_units_launch(const McuRunArgs* a, void* stream) {
    if (a->n_items <= 0) return 0;
    if (a->stage_ints <= 0 || a->mid_ints < 0 || a->ib < 0 || a->ib > 6)
        return (int)cudaErrorInvalidValue;
    const size_t smem =
        sizeof(int32_t) * (2 * (size_t)a->stage_ints + a->mid_ints);
    static size_t attr = 48 * 1024;   // dynamic shared memory allowed
    cudaError_t e;
    if (smem > attr) {
        e = cudaFuncSetAttribute(mc_units_run_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
        if (e != cudaSuccess) return (int)e;
        attr = smem;
    }
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, mc_units_run_kernel, MU_THREADS, smem)) != cudaSuccess)
        return (int)e;
    if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    const int grid = min(a->n_items, per_sm * sms);
    mc_units_run_kernel<<<grid, MU_THREADS, smem, (cudaStream_t)stream>>>(
        *a);
    return (int)cudaGetLastError();
}

extern "C" const char* mc_units_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
