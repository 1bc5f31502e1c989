// Affine warp of a frame's 8x8 warp units, in one launch over the frame's
// work list (its `warprun` record): every `warp` record (put, stored into
// the plane) and every compound side's "w" sub-op (prep, stored into its
// slots of the frame's slot arena).
//
// Replaces, on the port's executor path, what XLA fused on the TPU:
// dav1d_mirror_tpu/ops/mc_tpu.py::warp8x8_batch (:366) followed by
// scatter_units (:266) or scatter_slot_units (:316); not a Pallas kernel.
// Its plain PyTorch version is dav1d_mirror_tpu_torch/ops/mc.py::
// warp_run (one warp_plane or warp_slots an entry; dav1d mc_tmpl.c
// warp_affine_8x8:758 / warp_affine_8x8t:793).
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
// The work list (ops/mc.warp_build_table): WENTRY ints an entry (a warp
// record or "w" sub-op: flags, plane, the offsets of its rows (int32:
// their phases exceed int16) and of its ys and xs, or of its base, in the
// frame's int32 or int16 descriptor buffer, its slot span in the arena,
// real rows, and the prefix sum of the real rows of the entries before
// it). Only real rows are units of the run: pad rows are neither loaded
// nor computed.
//
// Destinations: the plane at (ys + y, xs + x), a pixel outside the plane
// dropped; or the arena at dst + base + y * row_w + x, an offset outside
// the entry's span [dst, dst + dstn) dropped. The planner's warp units
// are disjoint, so plain stores in any order give the plain version's
// result.
//
// Bound on the H100: bytes. A unit reads its 15 x 15 int32 window (the
// windows of neighbouring units overlap by 7 pixels, so the distinct
// reference pixels are about 1.6x its 64 outputs at 8x8 pitch) and ten
// descriptors, and writes 64 int32 pixels; its 1,472 multiply-adds are
// about 6 int32 operations a byte, under the card's ratio of about 20.
// What held the per-record design back was its launches (a grid of a few
// CTAs a record, near the empty-launch floor each), not its arithmetic.
//
// Design: persistent CTAs (as many as fit on the card, at most one a
// group) walk groups of WP_UNITS units at a stride of the grid, 64
// threads a unit. A CTA stages the int8 filter table into shared memory
// once (the phases differ per pixel) and the work list's table, where
// each unit finds its entry by a binary search of the prefix column, so
// no entry field is a dependent read of device memory. Its shared memory
// is double-buffered: while it filters group g, group g + grid's
// descriptors are read and its windows are in flight into the other
// stage with cp.async (4-byte copies from clamped addresses, which give
// AV1's edge replication). The 15 x 8 horizontal pass writes a shared
// `mid`; each thread computes one output pixel of the vertical pass and
// stores it straight into its destination. On the tools path's frame 1
// (11,062 units in 64 entries) a build without the filter takes about
// two thirds of the time (tools/tool_runs.py): the run is held by its
// chain of dependent reads (descriptors, then windows) a group, not by
// bytes or arithmetic; two units a CTA ran faster than four or eight.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef WP_UNITS        // units a CTA (tools/tool_runs.py builds others)
#define WP_UNITS 2
#endif
#define WP_THREADS (64 * WP_UNITS)
#define WP_PLANES 3
#define WP_SMEM_ENTRIES 512    // the table in shared memory up to this
#define WARP_ROWS 193
#define WIN 15

// entry fields and flags (ops/mc.py W_*, WF_*)
enum { W_FLAGS, W_PLANE, W_ROWS, W_YS, W_XS, W_DST, W_DSTN, W_ROWW,
       W_NREAL, W_START, WENTRY };
#define WF_SLOT 1
#define WF_PREP 2
#define WF_YS16 4
#define WF_XS16 8

typedef struct {
    const int32_t* tab;     // n_entries x WENTRY ints
    const int32_t* desc;    // the frame's int32 descriptor buffer
    const int16_t* desc16;  // its int16 buffer
    const int32_t* ref[WP_PLANES];     // (R, H, W) int32 stacks, a plane's
    int32_t* plane[WP_PLANES];
    int32_t* arena;         // the frame's flat int32 slot arena
    long long ref_pstride[WP_PLANES];
    long long arena_n;
    int ref_rstride[WP_PLANES], ref_n[WP_PLANES], ref_h[WP_PLANES],
        ref_w[WP_PLANES];
    int plane_h[WP_PLANES], plane_w[WP_PLANES], plane_rstride[WP_PLANES];
    int n_entries, n_units, ib, bias, bd_max;
} WarpRunArgs;

// in device memory, not __constant__: a CTA stages it with coalesced
// 8-byte loads, where constant memory serialises a warp's distinct
// addresses
__device__ __align__(16) int8_t g_warp[WARP_ROWS * 8];

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

__device__ __forceinline__ int ld(const WarpRunArgs& a, int narrow,
                                  long long i) {
    return narrow ? (int)a.desc16[i] : a.desc[i];
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

// a stage: each unit's descriptor row and its destination (entry, or -1
// for none; ys or base; xs)
struct Stage {
    int32_t win[WP_UNITS][WIN * WIN];
    int row[WP_UNITS][10];
    int dst[WP_UNITS][3];
};

// Read group g's descriptors into stage s: threads 0..11 of each unit
// find its entry in the table T (the last whose prefix is at most the
// unit) and read a field each.
__device__ __forceinline__ void load_group(const WarpRunArgs& a,
                                           const int* T, int g, Stage& s) {
    const int u = threadIdx.x >> 6, t = threadIdx.x & 63;
    if (t >= 12) return;
    const int unit = g * WP_UNITS + u;
    int e = -1, i = 0;
    if (unit < a.n_units) {
        int lo = 0, hi = a.n_entries - 1;
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (T[mid * WENTRY + W_START] <= unit) lo = mid; else hi = mid - 1;
        }
        const int* en = T + lo * WENTRY;
        const int pl = en[W_PLANE];
        i = unit - en[W_START];
        if (i < en[W_NREAL] && pl >= 0 && pl < WP_PLANES && a.ref_n[pl] > 0)
            e = lo;
    }
    if (t == 0) s.dst[u][0] = e;
    if (e < 0) return;
    const int* en = T + e * WENTRY;
    const int fl = en[W_FLAGS];
    if (t < 10)
        s.row[u][t] = a.desc[en[W_ROWS] + (long long)i * 10 + t];
    else if (t == 10)
        s.dst[u][1] = ld(a, fl & WF_YS16, en[W_YS] + (long long)i);
    else
        s.dst[u][2] = fl & WF_SLOT ? 0 : ld(a, fl & WF_XS16,
                                           en[W_XS] + (long long)i);
}

// Start the copies of stage s's windows (clamped into the reference) and
// commit them as one group.
__device__ __forceinline__ void issue_windows(const WarpRunArgs& a,
                                              const int* T, Stage& s) {
    const int u = threadIdx.x >> 6, t = threadIdx.x & 63;
    const int e = s.dst[u][0];
    if (e >= 0) {
        const int pl = T[e * WENTRY + W_PLANE];
        const int* r = s.row[u];
        const int n = min(max(r[0], 0), a.ref_n[pl] - 1);
        const int32_t* src = a.ref[pl] + n * a.ref_pstride[pl];
        const int H = a.ref_h[pl], W = a.ref_w[pl], rs = a.ref_rstride[pl];
        for (int i = t; i < WIN * WIN; i += 64) {
            const int wr = i / WIN, wc = i - wr * WIN;
            const int y = min(max(r[1] + wr, 0), H - 1);
            const int x = min(max(r[2] + wc, 0), W - 1);
            cp_async4(&s.win[u][i], src + (long long)y * rs + x);
        }
    }
    cp_async_commit();
}

// Stage s's outputs: the horizontal pass into `mid`, then each thread's
// output pixel, stored into the plane or the arena.
__device__ __forceinline__ void compute(const WarpRunArgs& a, const int* T,
                                        const int8_t* s_f, const Stage& s,
                                        int32_t (*mid)[WIN * 8]) {
    const int u = threadIdx.x >> 6, t = threadIdx.x & 63;
    const int e = s.dst[u][0];
    const int* r = s.row[u];
#ifdef WARP_SKIP_FILTER   // tools/tool_runs.py: staging and stores only
    if (e >= 0)
        for (int i = t; i < WIN * 8; i += 64)
            mid[u][i] = s.win[u][(i >> 3) * WIN + (i & 7) + 3];
#else
    if (e >= 0) {
        const int sh = 7 - a.ib, rnd = (1 << sh) >> 1;
        for (int i = t; i < WIN * 8; i += 64) {
            const int y = i >> 3, x = i & 7;
            const int f = warp_row(r[3] + x * r[5] + y * r[6]);
            mid[u][i] = (dot8(s_f + 8 * f, &s.win[u][y * WIN + x], 1) +
                         rnd) >> sh;
        }
    }
#endif
    __syncthreads();
    if (e < 0) return;
    const int y = t >> 3, x = t & 7;
#ifdef WARP_SKIP_FILTER
    const int sum = mid[u][(y + 3) * 8 + x] << 7;
#else
    const int f = warp_row(r[4] + x * r[7] + y * r[8]);
    const int sum = dot8(s_f + 8 * f, &mid[u][y * 8 + x], 8);
#endif
    const int* en = T + e * WENTRY;
    const int fl = en[W_FLAGS];
    int v;
    if (fl & WF_PREP) {
        v = ((sum + 64) >> 7) - a.bias;
    } else {
        const int sh = 7 + a.ib;
        v = min(max((sum + ((1 << sh) >> 1)) >> sh, 0), a.bd_max);
    }
    if (fl & WF_SLOT) {
        const long long o = (long long)s.dst[u][1] +
                            (long long)y * en[W_ROWW] + x;
        const long long d = en[W_DST] + o;
        if (o >= 0 && o < en[W_DSTN] && d >= 0 && d < a.arena_n)
            a.arena[d] = v;
    } else {
        const int pl = en[W_PLANE];
        const int py = s.dst[u][1] + y, px = s.dst[u][2] + x;
        if (py >= 0 && py < a.plane_h[pl] && px >= 0 && px < a.plane_w[pl])
            a.plane[pl][(long long)py * a.plane_rstride[pl] + px] = v;
    }
}

__global__ void __launch_bounds__(WP_THREADS)
    warp_run_kernel(const __grid_constant__ WarpRunArgs a) {
    extern __shared__ int32_t s_tab[];    // the table, if it fits
    __shared__ __align__(16) int8_t s_f[WARP_ROWS * 8];
    __shared__ __align__(16) Stage st[2];
    __shared__ int32_t s_mid[WP_UNITS][WIN * 8];
    const int n_groups = (a.n_units + WP_UNITS - 1) / WP_UNITS;
    int g = blockIdx.x, k = 0;
    if (g >= n_groups) return;
    const bool staged = a.n_entries <= WP_SMEM_ENTRIES;
    for (int i = threadIdx.x; i < WARP_ROWS; i += WP_THREADS)
        reinterpret_cast<int2*>(s_f)[i] =
            reinterpret_cast<const int2*>(g_warp)[i];
    if (staged)
        for (int i = threadIdx.x; i < a.n_entries * WENTRY; i += WP_THREADS)
            s_tab[i] = a.tab[i];
    __syncthreads();
    const int* T = staged ? s_tab : a.tab;
    load_group(a, T, g, st[0]);
    __syncthreads();
    issue_windows(a, T, st[0]);
    for (; g < n_groups; g += gridDim.x) {
        const int nx = g + gridDim.x;
        // the next group's descriptors, under this group's copies
        if (nx < n_groups) load_group(a, T, nx, st[k ^ 1]);
        __syncthreads();
        if (nx < n_groups)
            issue_windows(a, T, st[k ^ 1]);
        else
            cp_async_commit();   // an empty group: the wait below is one
        cp_async_wait<1>();      // this group's windows have landed
        __syncthreads();
        compute(a, T, s_f, st[k], s_mid);
        __syncthreads();         // the next load reuses this stage
        k ^= 1;
    }
}

extern "C" int warp_init(const void* table) {
    return (int)cudaMemcpyToSymbol(g_warp, table, sizeof(g_warp));
}

extern "C" int warp_args_size() { return (int)sizeof(WarpRunArgs); }

// One launch over a's units on `stream`: persistent CTAs, as many as fit
// on the card, at most one a group. Returns cudaGetLastError().
extern "C" int warp_launch(const WarpRunArgs* a, void* stream) {
    if (a->n_units <= 0) return 0;
    if (a->ib < 0 || a->ib > 6 || a->n_entries <= 0)
        return (int)cudaErrorInvalidValue;
    const size_t smem = a->n_entries <= WP_SMEM_ENTRIES
        ? sizeof(int32_t) * WENTRY * (size_t)a->n_entries : 0;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, warp_run_kernel, WP_THREADS, smem)) != cudaSuccess)
        return (int)e;
    if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    const int groups = (a->n_units + WP_UNITS - 1) / WP_UNITS;
    const int grid = min(groups, per_sm * sms);
    warp_run_kernel<<<grid, WP_THREADS, smem, (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" const char* warp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
