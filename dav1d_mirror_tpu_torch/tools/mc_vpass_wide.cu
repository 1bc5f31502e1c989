// A second design of the MC V-pass (csrc/mc_vpass.cu), kept only to be
// timed against it by tools/vpass_variants.py: the decoder never loads it.
// Same function, same arguments as mc_vpass_launch, plus the columns per
// thread (nc) and the threads per block (nt).
//
// Where csrc/mc_vpass.cu gives each (unit, column) a thread and loads one
// int16 per window row, this design gives a thread NC consecutive columns
// (4 or 8; 2 when uw = 2) of one unit:
// - each window row is read as the aligned 8-byte words that cover the
//   thread's NC values (one more word when the row is not aligned to
//   them) and the values are selected with 64-bit funnel shifts;
// - each output row of the thread is one 16-byte store (8 bytes at
//   uw = 2);
// - the unit's first lane loads the descriptors and shuffles them to the
//   unit's other lanes; the subpel table is in __constant__ memory.
// A load of an aligned word may touch bytes beside the plane, never
// beyond the aligned 8 bytes that hold one of its values.
#include <cuda_runtime.h>
#include <stdint.h>

#define HPAD_L 15

__constant__ int32_t c_subpel[6 * 15 * 8];

// 4 int16 values from element m (0..3) of the 8-byte word lo on, the
// rest from hi
__device__ __forceinline__ uint64_t funnel(uint64_t lo, uint64_t hi, int m) {
    return m ? (lo >> (16 * m)) | (hi << (64 - 16 * m)) : lo;
}

template <int UW, int UH, int NC, int NT>
__global__ void __launch_bounds__(NT)
vpass_wide_kernel(const int16_t* __restrict__ hstack,
                  const int32_t* __restrict__ slot,
                  const int32_t* __restrict__ oy,
                  const int32_t* __restrict__ ox,
                  const int32_t* __restrict__ my,
                  const int32_t* __restrict__ tv, int32_t* __restrict__ out,
                  int B, int H, int w_mid, int ib, int bias, int bd_max,
                  int prep) {
    constexpr int LPU = UW / NC;           // lanes per unit
    constexpr int NW = NC < 4 ? 1 : NC / 4;  // 8-byte words of values
    const int t = blockIdx.x * NT + threadIdx.x;
    const int b = t / LPU;
    const int j = t % LPU;
    const bool live = b < B;

    int d_slot = 0, d_oy = 0, d_ox = 0, d_my = 1, d_tv = 0;
    if (live && j == 0) {
        d_slot = slot[b];
        d_oy = oy[b];
        d_ox = ox[b];
        d_my = my[b];
        d_tv = tv[b];
    }
    if (LPU > 1) {
        const int src = (threadIdx.x & 31) - j;
        d_slot = __shfl_sync(0xffffffffu, d_slot, src);
        d_oy = __shfl_sync(0xffffffffu, d_oy, src);
        d_ox = __shfl_sync(0xffffffffu, d_ox, src);
        d_my = __shfl_sync(0xffffffffu, d_my, src);
        d_tv = __shfl_sync(0xffffffffu, d_tv, src);
    }
    if (!live) return;

    const int16_t* col =
        hstack + (size_t)d_slot * H * w_mid + d_ox + HPAD_L + NC * j;
    int mid[UH + 7][NC];
#pragma unroll
    for (int r = 0; r < UH + 7; ++r) {
        const uintptr_t a = (uintptr_t)(
            col + (size_t)min(max(d_oy + r, 0), H - 1) * w_mid);
        const uint64_t* w =
            reinterpret_cast<const uint64_t*>(a & ~(uintptr_t)7);
        const int m = (int)(a & 7) >> 1;   // first value's place in w[0]
        uint64_t wd[NW + 1];
#pragma unroll
        for (int q = 0; q < NW; ++q) wd[q] = __ldg(w + q);
        wd[NW] = m + NC > 4 * NW ? __ldg(w + NW) : 0;
#pragma unroll
        for (int q = 0; q < NW; ++q) {
            const uint64_t v = funnel(wd[q], wd[q + 1], m);
#pragma unroll
            for (int c = 0; c < (NC < 4 ? NC : 4); ++c)
                mid[r][4 * q + c] = (int16_t)(v >> (16 * c));
        }
    }
    const int frow = UH <= 4 ? 3 + (d_tv & 1) : d_tv;
    const int32_t* f = c_subpel + (frow * 15 + d_my - 1) * 8;
    int taps[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) taps[k] = f[k];

    const int rnd = (1 << (6 + ib)) >> 1;
    int32_t* dst = out + (size_t)b * UH * UW + NC * j;
#pragma unroll
    for (int r = 0; r < UH; ++r) {
        int o[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            int acc = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) acc += taps[k] * mid[r + k][c];
            o[c] = prep ? ((acc + 32) >> 6) - bias
                        : min(max((acc + rnd) >> (6 + ib), 0), bd_max);
        }
        if constexpr (NC == 2) {
            *reinterpret_cast<int2*>(dst + r * UW) = make_int2(o[0], o[1]);
        } else {
#pragma unroll
            for (int q = 0; q < NC / 4; ++q)
                *reinterpret_cast<int4*>(dst + r * UW + 4 * q) = make_int4(
                    o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
        }
    }
}

extern "C" int vpass_wide_init(const void* subpel) {
    return (int)cudaMemcpyToSymbol(c_subpel, subpel, sizeof(c_subpel));
}

template <int UW, int UH, int NC, int NT>
static int launch(const void* hstack, const void* slot, const void* oy,
                  const void* ox, const void* my, const void* tv, void* out,
                  int B, int H, int w_mid, int ib, int bias, int bd_max,
                  int prep, cudaStream_t s) {
    const int blocks = (int)(((long long)B * (UW / NC) + NT - 1) / NT);
    vpass_wide_kernel<UW, UH, NC, NT><<<blocks, NT, 0, s>>>(
        (const int16_t*)hstack, (const int32_t*)slot, (const int32_t*)oy,
        (const int32_t*)ox, (const int32_t*)my, (const int32_t*)tv,
        (int32_t*)out, B, H, w_mid, ib, bias, bd_max, prep);
    return (int)cudaGetLastError();
}

// nc: columns per thread, 4 or 8 (uw = 8), 4 (uw = 4) or 2 (uw = 2);
// nt: threads per block, 64 or 128.
extern "C" int vpass_wide_launch(const void* hstack, const void* slot,
                                 const void* oy, const void* ox,
                                 const void* my, const void* tv, void* out,
                                 int B, int H, int w_mid, int uw, int uh,
                                 int ib, int bias, int bd_max, int prep,
                                 int nc, int nt, void* stream) {
    if (B == 0) return 0;
    if (((uintptr_t)out & 15) != 0) return (int)cudaErrorMisalignedAddress;
    cudaStream_t s = (cudaStream_t)stream;
#define VW_CASE(W_, H_, C_, T_)                                              \
    if (uw == W_ && uh == H_ && nc == C_ && nt == T_)                        \
        return launch<W_, H_, C_, T_>(hstack, slot, oy, ox, my, tv, out, B, \
                                      H, w_mid, ib, bias, bd_max, prep, s);
#define VW_UNIT(W_, H_, C_) VW_CASE(W_, H_, C_, 64) VW_CASE(W_, H_, C_, 128)
    VW_UNIT(8, 8, 8) VW_UNIT(8, 4, 8) VW_UNIT(8, 2, 8)
    VW_UNIT(8, 8, 4) VW_UNIT(8, 4, 4) VW_UNIT(8, 2, 4)
    VW_UNIT(4, 8, 4) VW_UNIT(4, 4, 4) VW_UNIT(4, 2, 4)
    VW_UNIT(2, 8, 2) VW_UNIT(2, 4, 2) VW_UNIT(2, 2, 2)
#undef VW_UNIT
#undef VW_CASE
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* vpass_wide_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
