// MC vertical 8-tap pass of the has_h & has_v put buckets: each unit
// reads its (uh + 7) x uw mid window from its combo's H-filtered plane.
//
// Replaces the Pallas kernel dav1d_mirror_tpu/ops/mc_pallas.py::
// _make_vpass (kernel :41, pallas_call :102); its plain PyTorch version is
// dav1d_mirror_tpu_torch/ops/mc.py::mc_unit_batch_hv.
//
//   mid[r]   = hstack[slot, clamp(oy + r, 0, H - 1), ox + 15 + c]
//   acc      = sum_k tap_k * mid[r + k],  taps = subpel[row][my - 1],
//              row = uh <= 4 ? 3 + (tv & 1) : tv
//   put:  out = clamp((acc + (1 << (5 + ib))) >> (6 + ib), 0, 2^bd - 1)
//   prep: out = ((acc + 32) >> 6) - bias   (bias 8192 above 8 bit)
//
// ox arrives pre-clamped to [-15, W - 1] by the planner, so every column
// lies inside the W + 22 wide mid plane.
//
// Bound on the H100: bytes. Per unit it reads (uh + 7) x uw int16 mid
// values plus five int32 descriptors and writes uh x uw int32 outputs
// (uw, uh in {2, 4, 8}: 2 is the chroma of 4-pixel luma blocks);
// the 8 taps per output are cheap next to that.
//
// Design: one thread per (unit, column). The thread loads its uh + 7 mid
// values once into registers (UH is a template parameter, so the window
// and the tap loops unroll fully) and produces the uh outputs of its
// column. Neighbouring threads of a unit read neighbouring columns, so
// each window row is one coalesced segment. The TPU kernel's aligned
// 24 x 256 DMA blocks and lane rolls have no counterpart: a thread block
// gathers from anywhere in device memory directly.
#include <cuda_runtime.h>
#include <stdint.h>

#define VP_THREADS 256
#define HPAD_L 15

template <int UH>
__global__ void __launch_bounds__(VP_THREADS)
mc_vpass_kernel(const int16_t* __restrict__ hstack,
                const int32_t* __restrict__ slot,
                const int32_t* __restrict__ oy,
                const int32_t* __restrict__ ox,
                const int32_t* __restrict__ my,
                const int32_t* __restrict__ tv,
                const int32_t* __restrict__ subpel, int32_t* __restrict__ out,
                int B, int H, int w_mid, int uw, int ib, int bias, int bd_max,
                int prep) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= B * uw) return;
    const int b = t / uw;
    const int c = t - b * uw;
    const int v = tv[b];
    const int frow = UH <= 4 ? 3 + (v & 1) : v;
    const int32_t* f = subpel + (frow * 15 + my[b] - 1) * 8;
    int taps[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) taps[k] = f[k];
    const int16_t* plane = hstack + (size_t)slot[b] * H * w_mid;
    const int xh = ox[b] + HPAD_L + c;
    const int y0 = oy[b];
    int mid[UH + 7];
#pragma unroll
    for (int r = 0; r < UH + 7; ++r) {
        const int y = min(max(y0 + r, 0), H - 1);
        mid[r] = plane[(size_t)y * w_mid + xh];
    }
    const int rnd = (1 << (6 + ib)) >> 1;
    int32_t* dst = out + (size_t)b * UH * uw + c;
#pragma unroll
    for (int r = 0; r < UH; ++r) {
        int acc = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) acc += taps[k] * mid[r + k];
        dst[r * uw] = prep ? ((acc + 32) >> 6) - bias
                           : min(max((acc + rnd) >> (6 + ib), 0), bd_max);
    }
}

extern "C" int mc_vpass_launch(const void* hstack, const void* slot,
                               const void* oy, const void* ox, const void* my,
                               const void* tv, const void* subpel, void* out,
                               int B, int H, int w_mid, int uw, int uh, int ib,
                               int bias, int bd_max, int prep, void* stream) {
    if (B == 0) return 0;
    const int n = B * uw;
    const int blocks = (n + VP_THREADS - 1) / VP_THREADS;
    cudaStream_t s = (cudaStream_t)stream;
#define VP_ARGS                                                              \
    (const int16_t*)hstack, (const int32_t*)slot, (const int32_t*)oy,        \
        (const int32_t*)ox, (const int32_t*)my, (const int32_t*)tv,          \
        (const int32_t*)subpel, (int32_t*)out, B, H, w_mid, uw, ib, bias,    \
        bd_max, prep
    if (uh == 8)
        mc_vpass_kernel<8><<<blocks, VP_THREADS, 0, s>>>(VP_ARGS);
    else if (uh == 4)
        mc_vpass_kernel<4><<<blocks, VP_THREADS, 0, s>>>(VP_ARGS);
    else if (uh == 2)
        mc_vpass_kernel<2><<<blocks, VP_THREADS, 0, s>>>(VP_ARGS);
    else
        return (int)cudaErrorInvalidValue;
#undef VP_ARGS
    return (int)cudaGetLastError();
}

extern "C" const char* mc_vpass_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
