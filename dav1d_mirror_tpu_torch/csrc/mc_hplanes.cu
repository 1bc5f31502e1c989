// MC horizontal 8-tap pass over whole reference planes, one plane per
// (ref, filter row, mx) combo of a has_h & has_v put bucket.
//
// Replaces the Pallas kernel dav1d_mirror_tpu/ops/mc_pallas.py::
// _make_hplanes (kernel :226, pallas_call :259); its plain PyTorch version
// is dav1d_mirror_tpu_torch/ops/mc.py::mc_hplanes.
//
//   out[c, y, xh] = int16((sum_k tap_k * ref[r, y, clamp(xh - 15 + k)]
//                          + rnd) >> (6 - ib)),   xh in [0, W + 22)
//
// with (r, filter row, mx) = combos[c], taps = subpel[row][mx - 1],
// ib = 4 at 8/10 bit and 2 at 12 bit, rnd = (1 << (6 - ib)) >> 1. The
// int16 store truncates like the reference's astype(int16).
//
// Bound on the H100: bytes. Each output is 8 multiply-adds against 2
// stored bytes, far below the card's operations-per-byte balance; the
// kernel must read each referenced plane row once per combo and write
// C x H x (W + 22) int16 values.
//
// Design: one block per (band of HP_ROWS rows, combo). The block stages
// one clamp-extended reference row in shared memory (coalesced 4-byte
// loads, the edge clamp done once per staged pixel), then each thread
// produces a strided run of output columns from shared memory, so the
// 8 overlapping taps cost no extra global reads, and stores coalesced
// int16. Reusing staged rows across the combos that share a reference
// is left for later (the TPU kernel's HGROUP did that for VMEM).
#include <cuda_runtime.h>
#include <stdint.h>

#define HP_THREADS 256
#define HP_ROWS 4
#define HPAD_L 15
#define HPAD_R 14

__global__ void __launch_bounds__(HP_THREADS)
mc_hplanes_kernel(const int32_t* __restrict__ refs,
                  const int32_t* __restrict__ combos,
                  const int32_t* __restrict__ subpel,
                  int16_t* __restrict__ out, int H, int W, int ib) {
    extern __shared__ int32_t row[];  // W + HPAD_L + HPAD_R entries
    const int c = blockIdx.y;
    const int ref = combos[c * 3 + 0];
    const int frow = combos[c * 3 + 1];
    const int mx = combos[c * 3 + 2];
    int taps[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) taps[k] = subpel[(frow * 15 + mx - 1) * 8 + k];
    const int sh = 6 - ib;
    const int rnd = (1 << sh) >> 1;
    const int w_in = W + HPAD_L + HPAD_R;
    const int w_out = W + 22;
    const int y0 = blockIdx.x * HP_ROWS;
    for (int dy = 0; dy < HP_ROWS; ++dy) {
        const int y = y0 + dy;
        if (y >= H) break;  // uniform across the block
        const int32_t* src = refs + ((size_t)ref * H + y) * W;
        __syncthreads();  // the previous row's readers are done
        for (int j = threadIdx.x; j < w_in; j += blockDim.x) {
            const int x = min(max(j - HPAD_L, 0), W - 1);
            row[j] = src[x];
        }
        __syncthreads();
        int16_t* dst = out + ((size_t)c * H + y) * w_out;
        for (int x = threadIdx.x; x < w_out; x += blockDim.x) {
            int acc = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) acc += taps[k] * row[x + k];
            dst[x] = (int16_t)((acc + rnd) >> sh);
        }
    }
}

extern "C" int mc_hplanes_launch(const void* refs, const void* combos,
                                 const void* subpel, void* out, int H, int W,
                                 int C, int ib, void* stream) {
    if (C == 0 || H == 0) return 0;
    dim3 grid((H + HP_ROWS - 1) / HP_ROWS, C);
    const size_t smem = (size_t)(W + HPAD_L + HPAD_R) * sizeof(int32_t);
    mc_hplanes_kernel<<<grid, HP_THREADS, smem, (cudaStream_t)stream>>>(
        (const int32_t*)refs, (const int32_t*)combos,
        (const int32_t*)subpel, (int16_t*)out, H, W, ib);
    return (int)cudaGetLastError();
}

extern "C" const char* mc_hplanes_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
