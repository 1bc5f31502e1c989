// The OBMC blend of one `obmc` record of a frame program, in one launch,
// in place on the plane: each lap prediction (a slot of the frame's slot
// arena) is blended into the plane under the OBMC mask.
//
// Replaces, on the port's executor path, what XLA fused on the TPU:
// dav1d_mirror_tpu/ops/mc_tpu.py::obmc_blend_batch (:445) (gather_units,
// the blend, scatter_units); not a Pallas kernel. Its plain PyTorch
// version is dav1d_mirror_tpu_torch/ops/mc.py::obmc_plane (dav1d
// mc_tmpl.c blend_v:655 / blend_h:668).
//
//   lap l at (ys[l], xs[l]), pixel (y, x) of its (lap_h, lap_w):
//   m = masks[region + x] for x < 3 region / 4 (vert: left laps), or
//       masks[region + y] for y < 3 region / 4 (top laps; region, the
//       blended rows, may exceed lap_h), else 0
//   plane = (plane (64 - m) + lap m + 32) >> 6
// with masks the 64 OBMC mask values (ops/mc.obmc_mask_table, the one
// tensor the plain version slices). Where m = 0 the formula gives the
// plane's own value, so only the masked columns (rows) are visited.
//
// The plain version reads every lap's plane pixels before it writes
// any; here each thread reads, blends and writes its own pixel. That is
// the same result because the laps of one record are disjoint (tested
// on the planner's output), and because a lap pixel outside the plane,
// whose read the plain version clamps onto another pixel, has its write
// dropped: the kernel skips it. PAD_OOB pad laps are dropped whole.
//
// Bound on the H100: bytes. A blended pixel reads the plane and the lap
// and writes the plane: 12 bytes for four integer operations.
//
// Design: a thread a blended pixel, consecutive threads along a lap's
// rows (top laps) or its masked columns (left laps).
#include <cuda_runtime.h>
#include <stdint.h>

#define OB_THREADS 256
#define OB_MASKS 64

typedef struct {
    int32_t* plane;
    const int32_t* laps;   // (n, lap_h, lap_w) slots of the arena
    const int32_t* ys;     // (n,) lap origins in the plane
    const int32_t* xs;
    const int32_t* masks;  // the OB_MASKS OBMC mask values
    int plane_h, plane_w, plane_rstride;
    int n, lap_h, lap_w, region, vert;
} ObmcArgs;

// rows x columns of a lap's blended area
__host__ __device__ __forceinline__ void blend_area(const ObmcArgs& a,
                                                    int* rows, int* cols) {
    const int k = (a.region * 3) >> 2;
    *rows = a.vert ? a.lap_h : (k < a.lap_h ? k : a.lap_h);
    *cols = a.vert ? (k < a.lap_w ? k : a.lap_w) : a.lap_w;
}

__global__ void __launch_bounds__(OB_THREADS)
    obmc_kernel(const __grid_constant__ ObmcArgs a) {
    int rows, cols;
    blend_area(a, &rows, &cols);
    const int area = rows * cols;
    const long long i = (long long)blockIdx.x * OB_THREADS + threadIdx.x;
    if (i >= (long long)a.n * area) return;
    const int l = (int)(i / area), p = (int)(i - (long long)l * area);
    const int y = p / cols, x = p - y * cols;
    const int py = a.ys[l] + y, px = a.xs[l] + x;
    if (py < 0 || py >= a.plane_h || px < 0 || px >= a.plane_w) return;
    const int m = a.masks[a.region + (a.vert ? x : y)];
    int32_t* d = a.plane + (long long)py * a.plane_rstride + px;
    const int lap = a.laps[((long long)l * a.lap_h + y) * a.lap_w + x];
    *d = (*d * (64 - m) + lap * m + 32) >> 6;
}

extern "C" int obmc_args_size() { return (int)sizeof(ObmcArgs); }

// One launch over a's n laps on `stream`. Returns cudaGetLastError().
extern "C" int obmc_launch(const ObmcArgs* a, void* stream) {
    int rows, cols;
    blend_area(*a, &rows, &cols);
    if (a->n <= 0 || rows <= 0 || cols <= 0) return 0;
    if (a->region < 0 || a->region + ((a->region * 3) >> 2) > OB_MASKS)
        return (int)cudaErrorInvalidValue;
    const long long total = (long long)a->n * rows * cols;
    const long long grid = (total + OB_THREADS - 1) / OB_THREADS;
    obmc_kernel<<<(unsigned)grid, OB_THREADS, 0, (cudaStream_t)stream>>>(
        *a);
    return (int)cudaGetLastError();
}

extern "C" const char* obmc_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
