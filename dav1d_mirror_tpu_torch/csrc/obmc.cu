// The OBMC blend of one phase of a frame program, in one launch over the
// phase's work list (its `obmcrun` record: every `obmc` record of the
// phase, of every plane), in place on the planes: each lap prediction (a
// slot of the frame's slot arena) is blended into its plane under the
// OBMC mask. Phase 0 holds the top laps, phase 1 the left laps; a block's
// top and left laps share its corner, and phase 1 reads what phase 0
// wrote there, so a frame has two launches.
//
// Replaces, on the port's executor path, what XLA fused on the TPU:
// dav1d_mirror_tpu/ops/mc_tpu.py::obmc_blend_batch (:445) (gather_units,
// the blend, scatter_units); not a Pallas kernel. Its plain PyTorch
// version is dav1d_mirror_tpu_torch/ops/mc.py::obmc_run (one obmc_plane
// an entry, in order; dav1d mc_tmpl.c blend_v:655 / blend_h:668).
//
//   lap l of an entry at (ys[l], xs[l]), pixel (y, x) of its (lap_h,
//   lap_w):
//   m = masks[region + x] for x < 3 region / 4 (vert: left laps), or
//       masks[region + y] for y < 3 region / 4 (top laps; region, the
//       blended rows, may exceed lap_h), else 0
//   plane = (plane (64 - m) + lap m + 32) >> 6
// with masks the 64 OBMC mask values (ops/mc.obmc_mask_table, the one
// tensor the plain version slices). Where m = 0 the formula gives the
// plane's own value, so only the masked columns (rows) are visited: an
// entry's blended area (ops/mc.obmc_area) a real lap.
//
// The work list (ops/mc.obmc_build_table): OENTRY ints an entry (plane,
// the laps' arena offset and shape, region, vert, the origins' offsets in
// the int32 descriptor buffer, real laps, blended area, and the prefix
// sum of the blended pixels of the entries before it). Only real laps
// are in it: PAD_OOB pad laps are neither read nor blended.
//
// The plain version reads every lap's plane pixels of an entry before it
// writes any, and runs the entries in order; here each thread reads,
// blends and writes its own pixel. That is the same result because the
// laps of one phase are disjoint, across records and planes (each lies
// inside its own block; tested on the planner's output), and because a
// lap pixel outside the plane, whose read the plain version clamps onto
// another pixel, has its write dropped: the kernel skips it.
//
// Bound on the H100: bytes. A blended pixel reads the plane and the lap
// and writes the plane: 12 bytes for about six integer operations. What
// held the per-record design back was its launches (a grid of a few CTAs
// a record, near the empty-launch floor each), not its arithmetic.
//
// Design: a thread a blended pixel, over the prefix of the phase's
// entries, so all records of the phase share one grid (persistent CTAs,
// as many as fit on the card, at a stride of the grid); consecutive
// threads along a lap's rows (top laps) or its masked columns (left
// laps). Each CTA stages the mask values and the entry table into shared
// memory; a thread finds its entry by a binary search of the prefix
// column.
#include <cuda_runtime.h>
#include <stdint.h>

#define OB_THREADS 256
#define OB_MASKS 64
#define OB_PLANES 3
#define OB_SMEM_ENTRIES 512    // the table in shared memory up to this

// entry fields (ops/mc.py O_*)
enum { O_PLANE, O_LAPS, O_LH, O_LW, O_REGION, O_VERT, O_YS, O_XS, O_NREAL,
       O_ROWS, O_COLS, O_START, OENTRY };

typedef struct {
    const int32_t* tab;    // n_entries x OENTRY ints
    const int32_t* desc;   // the frame's int32 descriptor buffer
    const int32_t* arena;  // the frame's flat int32 slot arena
    const int32_t* masks;  // the OB_MASKS OBMC mask values
    int32_t* plane[OB_PLANES];
    long long arena_n;
    int plane_h[OB_PLANES], plane_w[OB_PLANES], plane_rstride[OB_PLANES];
    int n_entries, n_pixels;
} ObmcRunArgs;

__global__ void __launch_bounds__(OB_THREADS)
    obmc_run_kernel(const __grid_constant__ ObmcRunArgs a) {
    extern __shared__ int32_t s_tab[];    // the table, if it fits
    __shared__ int s_m[OB_MASKS];
    const bool staged = a.n_entries <= OB_SMEM_ENTRIES;
    if (threadIdx.x < OB_MASKS) s_m[threadIdx.x] = a.masks[threadIdx.x];
    if (staged)
        for (int i = threadIdx.x; i < a.n_entries * OENTRY; i += OB_THREADS)
            s_tab[i] = a.tab[i];
    __syncthreads();
    const int* T = staged ? s_tab : a.tab;
    for (int i = blockIdx.x * OB_THREADS + threadIdx.x; i < a.n_pixels;
         i += gridDim.x * OB_THREADS) {
        int lo = 0, hi = a.n_entries - 1;
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (T[mid * OENTRY + O_START] <= i) lo = mid; else hi = mid - 1;
        }
        const int* en = T + lo * OENTRY;
        const int rows = en[O_ROWS], cols = en[O_COLS];
        const int p = i - en[O_START], area = rows * cols;
        if (area <= 0) continue;
        const int l = p / area, q = p - l * area;
        const int y = q / cols, x = q - y * cols;
        const int pl = en[O_PLANE];
        if (l >= en[O_NREAL] || pl < 0 || pl >= OB_PLANES) continue;
        const int py = a.desc[en[O_YS] + l] + y;
        const int px = a.desc[en[O_XS] + l] + x;
        if (py < 0 || py >= a.plane_h[pl] || px < 0 || px >= a.plane_w[pl])
            continue;
        const long long lap = en[O_LAPS] +
                              ((long long)l * en[O_LH] + y) * en[O_LW] + x;
        const int mi = en[O_REGION] + (en[O_VERT] ? x : y);
        if (lap < 0 || lap >= a.arena_n || mi < 0 || mi >= OB_MASKS)
            continue;
        const int m = s_m[mi];
        int32_t* d = a.plane[pl] + (long long)py * a.plane_rstride[pl] + px;
        *d = (*d * (64 - m) + a.arena[lap] * m + 32) >> 6;
    }
}

extern "C" int obmc_args_size() { return (int)sizeof(ObmcRunArgs); }

// One launch over a's blended pixels on `stream`: persistent CTAs, as
// many as fit on the card, at most one a OB_THREADS pixels. Returns
// cudaGetLastError().
extern "C" int obmc_launch(const ObmcRunArgs* a, void* stream) {
    if (a->n_pixels <= 0) return 0;
    if (a->n_entries <= 0) return (int)cudaErrorInvalidValue;
    const size_t smem = a->n_entries <= OB_SMEM_ENTRIES
        ? sizeof(int32_t) * OENTRY * (size_t)a->n_entries : 0;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, obmc_run_kernel, OB_THREADS, smem)) != cudaSuccess)
        return (int)e;
    if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    const int blocks = (a->n_pixels + OB_THREADS - 1) / OB_THREADS;
    const int grid = min(blocks, per_sm * sms);
    obmc_run_kernel<<<grid, OB_THREADS, smem, (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" const char* obmc_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
