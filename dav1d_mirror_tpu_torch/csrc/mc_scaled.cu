// Scaled-reference unit MC of a frame's work list, in one launch: every
// bucket of units whose reference has another size than the frame (dav1d
// mc_tmpl.c put/prep_8tap_scaled:172/287), the scaled puts and the "s"
// units of compound sides and OBMC laps, put or prep, each output pixel
// stored straight into the frame plane or at its flat offset in a slot
// buffer of the frame's arena.
//
// Replaces, on the port's executor path, what XLA fused on the TPU:
// dav1d_mirror_tpu/ops/mc_tpu.py::mc_scaled_batch (:473) followed by
// scatter_units (:266) or scatter_slot_units (:316); not a Pallas kernel.
// Its plain PyTorch version is dav1d_mirror_tpu_torch/ops/mc.py::
// mc_scaled_run (one mc_scaled_plane or mc_scaled_slots an entry).
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
// The work list (ops/mc.mc_build_table): MS_ENTRY ints an entry (a
// bucket: unit size, flags, scaled reference view, destination plane,
// rows and real rows, offsets of its rows, ys (or flat bases) and xs in
// the frame's int32 buffer, its slot buffer's offset, size and row width
// in the arena, units an item), then two an item: entry * 16 + tile,
// first unit. An item is one tile (at most 32 x 32 outputs) of G units of
// one entry (at most 2048 outputs, and as many as two stages of shared
// memory hold at the entry's largest steps); only real rows have items.
//
// Destinations: a plane at (ys + y, xs + x), a pixel outside the plane
// dropped; or the flat offset base + y row_w + x of the entry's slot
// buffer, an offset outside it dropped.
//
// Precondition: AV1's scale limits, 0 <= mxf, myf < 1024 and 0 < dx, dy
// <= 2048 (a reference at most twice the frame's size), as
// models/inter.py's _scale_fac gives them. Under them a th x tw tile's
// phases reach at most 2 th + 8 window rows and 2 tw + 8 window columns
// from its first phase; outside them a tap reads the nearest staged row
// or column: in bounds, but not dav1d's value.
//
// Bound on the H100: bytes. A run reads the reference pixels its units'
// taps touch (neighbouring units' regions overlap), nine descriptors and
// an origin a unit, and writes uh x uw int32 pixels a unit.
//
// Design: persistent CTAs walk the items at a stride of the grid, with
// two shared-memory stages: while a CTA computes item i, item i + 1's
// descriptors are read and the reference region of each of its unit
// tiles is in flight into the other stage with cp.async (4-byte copies
// from clamped addresses: AV1's edge replication). A region holds the
// window rows and columns that the item's phases reach: (th + 8) x
// (2 tw + 8) int32 for super-res's horizontal-only scaling, (2 th + 8) x
// (2 tw + 8) at most. The H pass then reads each column's 8 taps from
// shared memory, into a shared `mid` of as many rows, and the V pass
// reads `mid`. The kernel is bound by its instructions, not by memory:
// flat loops divide by multiplication (fdiv), taps start at one clamped
// offset, and the subpel table is copied from __constant__ to shared
// memory (the lanes of a warp read different phases) and read as int4.
#include <cuda_runtime.h>
#include <stdint.h>

#define MS_THREADS 256
#define MS_TILE 32
#define MS_MAX_G 64
#define MS_ENTRY 16
#define MS_REFS 24       // scaled reference views a frame (srefspec)
#define MS_PLANES 3

// entry fields and flags (ops/mc.py M_*, MF_*)
enum { M_UW, M_UH, M_FLAGS, M_REF, M_PLANE, M_B, M_NREAL, M_DESC, M_YS,
       M_XS, M_DST, M_DSTN, M_ROWW, M_G, M_ITEM0, M_STEPS };
#define MF_PREP 4
#define MF_ARENA 8

typedef struct {
    const int32_t* tab;    // entries (MS_ENTRY ints each); null: `one`
    const int32_t* map;    // two ints an item; null with tab null
    const int32_t* base[3];           // the int32 buffers of rows, ys, xs
    const void* ref[MS_REFS];         // int32 (R, H, W) views
    void* plane[MS_PLANES];           // int32 planes
    void* arena;                      // int32 slot arena
    long long ref_pstride[MS_REFS];
    long long arena_n;
    int ref_rstride[MS_REFS], ref_h[MS_REFS], ref_w[MS_REFS];
    int plane_h[MS_PLANES], plane_w[MS_PLANES], plane_rstride[MS_PLANES];
    int n_items, stage_ints, mid_ints;
    int ib, bias, bd_max;
    int one[MS_ENTRY];     // the entry of a one-entry list (tab null)
} McsRunArgs;

__constant__ int32_t c_subpel[6 * 15 * 8];
__constant__ int32_t c_f2d[9][2] = {{0, 0}, {0, 1}, {0, 2}, {2, 0}, {2, 1},
                                    {2, 2}, {1, 0}, {1, 1}, {1, 2}};

// per stage: the item's entry, then its tile origin, unit count, tile
// size, the multipliers that divide by the tile's width and outputs
// (fdiv), and of units 0-31 and 32-63 the most region rows and columns
// one of their tiles needs
enum { S_TY0 = MS_ENTRY, S_TX0, S_GN, S_TW, S_TH, S_MTW, S_MON, S_NR0,
       S_NR1, S_NC0, S_NC1, S_N };
// per unit: reference index, window origin (top - 3, left - 3), phases
// and steps, filter types, destination, the region's first window row
// and column
enum { D_REF, D_TOP, D_LEFT, D_MXF, D_MYF, D_DX, D_DY, D_TH, D_TV, D_Y,
       D_X, D_RLO, D_CLO, D_N };

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

__device__ __forceinline__ int filter_off(int type, int sub, int side) {
    const int row = side <= 4 ? 3 + (type & 1) : type;
    return (row * 15 + clampi(sub, 1, 15) - 1) * 8;
}

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

__device__ __forceinline__ int ent(const McsRunArgs& a, int e, int i) {
    return a.tab ? a.tab[e * MS_ENTRY + i] : a.one[i];
}

// the 8 taps of filter row `f` (tab + f, 32-byte aligned) times x[k s]
__device__ __forceinline__ int taps8(const int32_t* tab, int f,
                                     const int32_t* x, int s) {
    const int4 f0 = *(const int4*)(tab + f), f1 = *(const int4*)(tab + f + 4);
    return f0.x * x[0] + f0.y * x[s] + f0.z * x[2 * s] + f0.w * x[3 * s] +
           f1.x * x[4 * s] + f1.y * x[5 * s] + f1.z * x[6 * s] +
           f1.w * x[7 * s];
}

// Region rows (columns) that n outputs' phases reach at `step`: from the
// first phase's to the last phase's eighth tap, 2 n + 8 at most
// (ops/mc._reach); step 0: not known, the most
__device__ __forceinline__ int reach(int n, int step) {
    return step ? min(2 * n + 8, (((n - 1) * step + 1023) >> 10) + 8)
                : 2 * n + 8;
}

// Read item `it`'s entry, tile geometry and units' rows into a stage,
// with the region rows (nr) and columns (nc) each unit's tile needs: the
// window rows from its first row phase to its last one's eighth tap, and
// the columns likewise, at least 8 and at most what the entry's largest
// steps reach (M_STEPS; the run's shared memory holds that much).
__device__ __forceinline__ void load_item(const McsRunArgs& a, int it,
                                          int* s_e, int (*s_d)[D_N]) {
    int e, tile, u0;
    if (a.tab) {
        const int m = a.map[2 * it];
        e = m >> 4;
        tile = m & 15;
        u0 = a.map[2 * it + 1];
    } else {
        const int tiles = ((a.one[M_UW] + MS_TILE - 1) / MS_TILE) *
                          ((a.one[M_UH] + MS_TILE - 1) / MS_TILE);
        e = 0;
        tile = it % tiles;
        u0 = (it / tiles) * a.one[M_G];
    }
    const int uw = ent(a, e, M_UW), uh = ent(a, e, M_UH);
    const int tw = min(uw, MS_TILE), th = min(uh, MS_TILE);
    const int tiles_x = (uw + tw - 1) / tw;
    const int ty0 = (tile / tiles_x) * th, tx0 = (tile % tiles_x) * tw;
    const int gn = min(ent(a, e, M_G), ent(a, e, M_NREAL) - u0);
    const int win_h = 2 * uh + 10, win_w = 2 * uw + 10;
    const int steps = ent(a, e, M_STEPS);
    const int cap_r = reach(th, steps >> 12), cap_c = reach(tw, steps & 4095);
    if (threadIdx.x < MS_ENTRY) s_e[threadIdx.x] = ent(a, e, threadIdx.x);
    if (threadIdx.x == 0) {
        s_e[S_TY0] = ty0;
        s_e[S_TX0] = tx0;
        s_e[S_GN] = gn;
        s_e[S_TW] = tw;
        s_e[S_TH] = th;
        s_e[S_MTW] = fdiv_m(tw);
        s_e[S_MON] = fdiv_m(th * tw);
    }
    if (threadIdx.x < 2 * 32) {      // the units (gn <= MS_MAX_G = 64)
        const int g = threadIdx.x;
        int nr = 0, nc = 0;
        if (g < gn) {
            const long long b = u0 + g;
            const int32_t* r = a.base[0] + ent(a, e, M_DESC) + b * 9;
            int32_t* d = s_d[g];
            d[D_REF] = r[0];
            d[D_TOP] = r[1] - 3;
            d[D_LEFT] = r[2] - 3;
            d[D_MXF] = r[3];
            d[D_MYF] = r[4];
            d[D_DX] = r[5];
            d[D_DY] = r[6];
            const int f2d = clampi(r[7], 0, 8);
            d[D_TH] = c_f2d[f2d][0];
            d[D_TV] = c_f2d[f2d][1];
            d[D_Y] = a.base[1][ent(a, e, M_YS) + b];
            d[D_X] = ent(a, e, M_FLAGS) & MF_ARENA
                         ? 0 : a.base[2][ent(a, e, M_XS) + b];
            const int rlo = clampi((r[4] + ty0 * r[6]) >> 10, 0, win_h - 1);
            const int clo = clampi((r[3] + tx0 * r[5]) >> 10, 0, win_w - 1);
            d[D_RLO] = rlo;
            d[D_CLO] = clo;
            nr = clampi(((r[4] + (ty0 + th - 1) * r[6]) >> 10) - rlo + 8, 8,
                        cap_r);
            nc = clampi(((r[3] + (tx0 + tw - 1) * r[5]) >> 10) - clo + 8, 8,
                        cap_c);
        }
        nr = __reduce_max_sync(0xffffffffu, nr);
        nc = __reduce_max_sync(0xffffffffu, nc);
        if ((threadIdx.x & 31) == 0) {
            s_e[S_NR0 + (g >> 5)] = nr;
            s_e[S_NC0 + (g >> 5)] = nc;
        }
    }
}

// Start the copies of the stage's reference regions (nr x nc, the
// item's most): unit g's region row i, column j is window row
// min(rlo + i, win_h - 1), column min(clo + j, win_w - 1), clamped into
// the reference.
__device__ __forceinline__ void issue_regions(const McsRunArgs& a,
                                              const int* s_e,
                                              const int (*s_d)[D_N],
                                              int32_t* reg) {
    const int r = s_e[M_REF];
    const int nr = max(s_e[S_NR0], s_e[S_NR1]);
    const int nc = max(s_e[S_NC0], s_e[S_NC1]), rn = nr * nc;
    const int mrn = fdiv_m(rn), mnc = fdiv_m(nc);
    const int win_h = 2 * s_e[M_UH] + 10, win_w = 2 * s_e[M_UW] + 10;
    const int32_t* ref = (const int32_t*)a.ref[r];
    const long long ps = a.ref_pstride[r];
    const int rs = a.ref_rstride[r], H = a.ref_h[r], W = a.ref_w[r];
    for (int i = threadIdx.x; i < s_e[S_GN] * rn; i += MS_THREADS) {
        const int g = fdiv(i, mrn), j = i - g * rn;
        const int rr = fdiv(j, mnc), c = j - rr * nc;
        const int* d = s_d[g];
        const int y = clampi(d[D_TOP] + min(d[D_RLO] + rr, win_h - 1), 0,
                             H - 1);
        const int x = clampi(d[D_LEFT] + min(d[D_CLO] + c, win_w - 1), 0,
                             W - 1);
        cp_async4(reg + i, ref + d[D_REF] * ps + (long long)y * rs + x);
    }
    cp_async_commit();
}

// The H pass over the stage's regions into `mid` (nr rows of the tile's
// columns), then the V pass and the stores. A column's 8 taps start at
// its phase's region column, a row's at its phase's mid row (under
// AV1's steps they lie inside; outside them the start is clamped, so
// every read stays in the stage).
__device__ __forceinline__ void compute(const McsRunArgs& a, const int* s_e,
                                        const int (*s_d)[D_N],
                                        const int32_t* tab,
                                        const int32_t* reg, int32_t* mid) {
    const int uw = s_e[M_UW], uh = s_e[M_UH], fl = s_e[M_FLAGS];
    const int tw = s_e[S_TW], th = s_e[S_TH], gn = s_e[S_GN];
    const int ty0 = s_e[S_TY0], tx0 = s_e[S_TX0], mtw = s_e[S_MTW];
    const int nr = max(s_e[S_NR0], s_e[S_NR1]);
    const int nc = max(s_e[S_NC0], s_e[S_NC1]);
    const int ib = a.ib, sh = 6 - ib;

    // H pass: the tile's mid rows [rlo, rlo + nr) from the region
    const int mn = nr * tw, rn = nr * nc, mmn = fdiv_m(mn);
    for (int i = threadIdx.x; i < gn * mn; i += MS_THREADS) {
        const int g = fdiv(i, mmn), j = i - g * mn;
        const int r = fdiv(j, mtw), c = j - r * tw;
        const int* d = s_d[g];
        const int phx = d[D_MXF] + (tx0 + c) * d[D_DX];
        const int subx = (phx & 0x3FF) >> 6;
        const int32_t* row = reg + g * rn + r * nc +
                             clampi((phx >> 10) - d[D_CLO], 0, nc - 8);
        if (subx == 0) {
            mid[i] = row[3] * (1 << ib);
        } else {
            const int acc = taps8(tab, filter_off(d[D_TH], subx, uw), row, 1);
            mid[i] = (acc + ((1 << sh) >> 1)) >> sh;
        }
    }
    __syncthreads();

    // V pass and the write
    const int on = th * tw, mon = s_e[S_MON];
    const int rl = (1 << (6 + ib)) >> 1, irnd = (1 << ib) >> 1;
    const int pl = s_e[M_PLANE];
    int32_t* dst = (int32_t*)(fl & MF_ARENA ? a.arena : a.plane[pl]);
    for (int i = threadIdx.x; i < gn * on; i += MS_THREADS) {
        const int g = fdiv(i, mon), j = i - g * on;
        const int r = fdiv(j, mtw), c = j - r * tw;
        const int y = ty0 + r, x = tx0 + c;
        if (y >= uh || x >= uw) continue;
        const int* d = s_d[g];
        const int phy = d[D_MYF] + y * d[D_DY];
        const int suby = (phy & 0x3FF) >> 6;
        const int32_t* m = mid + g * mn + c +
                           clampi((phy >> 10) - d[D_RLO], 0, nr - 8) * tw;
        int v;
        if (suby == 0) {
            const int p = m[3 * tw];
            v = fl & MF_PREP ? p - a.bias
                             : clampi((p + irnd) >> ib, 0, a.bd_max);
        } else {
            const int acc = taps8(tab, filter_off(d[D_TV], suby, uh), m, tw);
            v = fl & MF_PREP ? ((acc + 32) >> 6) - a.bias
                             : clampi((acc + rl) >> (6 + ib), 0, a.bd_max);
        }
        if (fl & MF_ARENA) {
            const long long o =
                (long long)d[D_Y] + (long long)y * s_e[M_ROWW] + x;
            if (o >= 0 && o < s_e[M_DSTN]) dst[s_e[M_DST] + o] = v;
        } else {
            const int py = d[D_Y] + y, px = d[D_X] + x;
            if (py >= 0 && py < a.plane_h[pl] && px >= 0 &&
                px < a.plane_w[pl])
                dst[(long long)py * a.plane_rstride[pl] + px] = v;
        }
    }
}

__global__ void __launch_bounds__(MS_THREADS)
    mc_scaled_run_kernel(const __grid_constant__ McsRunArgs a) {
    extern __shared__ int32_t sm[];   // [2][stage_ints] regions, mid
    __shared__ __align__(16) int32_t tab[6 * 15 * 8];
    __shared__ int s_e[2][S_N];
    __shared__ int s_d[2][MS_MAX_G][D_N];
    int32_t* mid = sm + 2 * a.stage_ints;
    int it = blockIdx.x, st = 0;
    if (it >= a.n_items) return;
    for (int i = threadIdx.x; i < 6 * 15 * 8; i += MS_THREADS)
        tab[i] = c_subpel[i];
    load_item(a, it, s_e[0], s_d[0]);
    __syncthreads();
    issue_regions(a, s_e[0], s_d[0], sm);
    for (; it < a.n_items; it += gridDim.x) {
        const int nx = it + gridDim.x;
        // the next item's rows, under this item's copies
        if (nx < a.n_items) load_item(a, nx, s_e[st ^ 1], s_d[st ^ 1]);
        __syncthreads();
        if (nx < a.n_items)
            issue_regions(a, s_e[st ^ 1], s_d[st ^ 1],
                          sm + (st ^ 1) * a.stage_ints);
        else
            cp_async_commit();   // an empty group: the wait below is one
        cp_async_wait<1>();      // this item's regions have landed
        __syncthreads();
        compute(a, s_e[st], s_d[st], tab, sm + st * a.stage_ints, mid);
        __syncthreads();         // the next load reuses this stage
        st ^= 1;
    }
}

extern "C" int mc_scaled_init(const void* subpel) {
    return (int)cudaMemcpyToSymbol(c_subpel, subpel, sizeof(c_subpel));
}

extern "C" int mc_scaled_args_size() { return (int)sizeof(McsRunArgs); }

// One launch over a's items on `stream`: persistent CTAs, as many as fit
// on the card with the run's shared memory, at most one an item. Returns
// cudaGetLastError().
extern "C" int mc_scaled_launch(const McsRunArgs* a, void* stream) {
    if (a->n_items <= 0) return 0;
    if (a->stage_ints <= 0 || a->mid_ints <= 0 || a->ib < 0 || a->ib > 6)
        return (int)cudaErrorInvalidValue;
    const size_t smem =
        sizeof(int32_t) * (2 * (size_t)a->stage_ints + a->mid_ints);
    static size_t attr = 48 * 1024;   // dynamic shared memory allowed
    cudaError_t e;
    if (smem > attr) {
        e = cudaFuncSetAttribute(mc_scaled_run_kernel,
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
             &per_sm, mc_scaled_run_kernel, MS_THREADS, smem)) !=
            cudaSuccess)
        return (int)e;
    if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    const int grid = min(a->n_items, per_sm * sms);
    mc_scaled_run_kernel<<<grid, MS_THREADS, smem, (cudaStream_t)stream>>>(
        *a);
    return (int)cudaGetLastError();
}

extern "C" const char* mc_scaled_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
