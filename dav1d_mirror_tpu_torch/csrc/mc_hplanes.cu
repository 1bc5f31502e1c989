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
// Bound on the H100: bytes, and mostly the stores. Each output is 8
// multiply-adds against 2 stored bytes; the C x H x (W + 22) int16 planes
// are over 90 % of the bytes the function must move, the distinct
// reference rows the rest.
//
// Design:
// - A block takes a band of HP_ROWS rows and a run of G = HP_GROUP
//   consecutive combos (the TPU kernel's HGROUP). It stages each row in
//   shared memory once for all the combos of the run that read that
//   reference, and restages when the run holds another reference, so
//   unsorted combos stay correct. The planner sorts combos by reference
//   (np.unique), so a run usually has one. The G combos' taps live in
//   registers (the subpel table is in __constant__ memory).
// - The staged rows are double-buffered with cp.async: the next row's
//   copy is in flight while this row is filtered. Interior quads of a
//   16-byte aligned source row go as 16-byte copies; the edge clamp is
//   paid once per staged pixel, on the quads that reach past an edge.
// - Each thread makes a chunk of 8 consecutive outputs from a register
//   window of 20 staged values (5 16-byte shared loads; 8 outputs need
//   15 inputs) and writes it with one 16-byte streaming store. Chunks
//   are aligned to 16 bytes in device memory, not to the row: w_out is
//   W + 22, so a row starts at any even byte. A row's first and last
//   chunk are masked and stored as single values.
// - Blocks of 128 threads over bands of 2 rows and runs of G = 4 combos:
//   1080p luma at C = 64 gives 8640 blocks, the 540-row chroma planes
//   4320, many waves on 132 SMs (band, block and G tuned on the H100;
//   G = 4 beat 2 and 8).
// combos stays on the device: each block reads its own run.
#include <cuda_runtime.h>
#include <stdint.h>

#define HP_THREADS 128
#define HP_ROWS 2
#define HP_GROUP 4   // combos per block (the TPU kernel's HGROUP)
// staged index j holds reference column clamp(j - HP_LEAD, 0, W - 1);
// output x reads staged x + 9 .. x + 16 (16-byte aligned quads of j map
// to 16-byte aligned quads of the source row)
#define HP_LEAD 24

__constant__ int32_t c_subpel[6 * 15 * 8];

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void cp_async16(int32_t* dst, const int32_t* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prev() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Issue the copies of one clamp-extended reference row into buf[0, n4*4).
__device__ __forceinline__ void stage_row(int32_t* buf, const int32_t* src,
                                          int W, int n4) {
    const bool aligned = ((uintptr_t)src & 15) == 0;
    for (int q = threadIdx.x; q < n4; q += HP_THREADS) {
        const int x = 4 * q - HP_LEAD;
        if (aligned && x >= 0 && x + 3 <= W - 1) {
            cp_async16(buf + 4 * q, src + x);
        } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
                cp_async4(buf + 4 * q + i, src + min(max(x + i, 0), W - 1));
        }
    }
}

// 8 outputs from the window v[S .. S + 14] with 8 taps.
template <int S>
__device__ __forceinline__ void filt8(const int (&v)[20], const int* taps,
                                      int rnd, int sh, int (&o)[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        int acc = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) acc += taps[k] * v[S + i + k];
        o[i] = (acc + rnd) >> sh;
    }
}

__device__ __forceinline__ uint32_t pack2(int lo, int hi) {
    return (uint32_t)(uint16_t)lo | ((uint32_t)(uint16_t)hi << 16);
}

// One combo's output row y from the staged row `buf`.
__device__ __forceinline__ void filter_row(const int32_t* buf,
                                           const int* taps, int16_t* out,
                                           size_t row, int w_out, int rnd,
                                           int sh) {
    const int off = (int)(row & 7);         // row start mod 8 elements
    const int n_ch = (off + w_out + 7) >> 3;
    const int s = (9 - off) & 3;            // window shift, block-uniform
    int16_t* dst_row = out + row;
    for (int k = threadIdx.x; k < n_ch; k += HP_THREADS) {
        const int x0 = 8 * k - off;          // first output of the chunk
        const int a = (x0 + 9) & ~3;
        const int4* p = reinterpret_cast<const int4*>(buf + a);
        int v[20];
#pragma unroll
        for (int i = 0; i < 5; ++i) {
            const int4 q = p[i];
            v[4 * i] = q.x;
            v[4 * i + 1] = q.y;
            v[4 * i + 2] = q.z;
            v[4 * i + 3] = q.w;
        }
        int o[8];
        switch (s) {
            case 0: filt8<0>(v, taps, rnd, sh, o); break;
            case 1: filt8<1>(v, taps, rnd, sh, o); break;
            case 2: filt8<2>(v, taps, rnd, sh, o); break;
            default: filt8<3>(v, taps, rnd, sh, o); break;
        }
        int16_t* dst = dst_row + x0;
        if (x0 >= 0 && x0 + 8 <= w_out) {
            __stcs(reinterpret_cast<int4*>(dst),
                   make_int4((int)pack2(o[0], o[1]), (int)pack2(o[2], o[3]),
                             (int)pack2(o[4], o[5]), (int)pack2(o[6], o[7])));
        } else {
#pragma unroll
            for (int i = 0; i < 8; ++i)
                if (x0 + i >= 0 && x0 + i < w_out) dst[i] = (int16_t)o[i];
        }
    }
}

__global__ void __launch_bounds__(HP_THREADS)
mc_hplanes_kernel(const int32_t* __restrict__ refs,
                  const int32_t* __restrict__ combos,
                  int16_t* __restrict__ out, int H, int W, int C, int ib) {
    extern __shared__ int4 smem4[];
    int32_t* bufs = reinterpret_cast<int32_t*>(smem4);
    __shared__ int s_combo[HP_GROUP * 3];
    const int c0 = blockIdx.y * HP_GROUP;
    const int ng = min(HP_GROUP, C - c0);
    if (threadIdx.x < ng * 3) s_combo[threadIdx.x] = combos[c0 * 3 + threadIdx.x];
    __syncthreads();

    int taps[HP_GROUP][8];
#pragma unroll
    for (int g = 0; g < HP_GROUP; ++g) {
        const int gi = min(g, ng - 1);
        const int* f =
            c_subpel + (s_combo[gi * 3 + 1] * 15 + s_combo[gi * 3 + 2] - 1) * 8;
#pragma unroll
        for (int k = 0; k < 8; ++k) taps[g][k] = f[k];
    }
    const int sh = 6 - ib;
    const int rnd = (1 << sh) >> 1;
    const int w_out = W + 22;
    const int n4 = (w_out + 31) >> 2;       // staged quads per row
    const int y0 = blockIdx.x * HP_ROWS;
    const int y1 = min(y0 + HP_ROWS, H);

    unsigned todo = (1u << ng) - 1;
    while (todo) {
        // the combos of the run that read the first pending reference
        const int ref = s_combo[(__ffs(todo) - 1) * 3];
        unsigned mask = 0;
#pragma unroll
        for (int g = 0; g < HP_GROUP; ++g)
            if (((todo >> g) & 1) && s_combo[g * 3] == ref) mask |= 1u << g;
        todo &= ~mask;
        const int32_t* plane = refs + (size_t)ref * H * W;

        stage_row(bufs, plane + (size_t)y0 * W, W, n4);
        cp_async_commit();
        for (int y = y0; y < y1; ++y) {
            const int cur = (y - y0) & 1;
            if (y + 1 < y1)
                stage_row(bufs + (cur ^ 1) * n4 * 4,
                          plane + (size_t)(y + 1) * W, W, n4);
            cp_async_commit();
            cp_async_wait_prev();
            __syncthreads();
            const int32_t* buf = bufs + cur * n4 * 4;
#pragma unroll
            for (int g = 0; g < HP_GROUP; ++g)
                if ((mask >> g) & 1)
                    filter_row(buf, taps[g], out,
                               ((size_t)(c0 + g) * H + y) * w_out, w_out, rnd,
                               sh);
            __syncthreads();  // readers done before the buffer is restaged
        }
    }
}

extern "C" int mc_hplanes_init(const void* subpel) {
    return (int)cudaMemcpyToSymbol(c_subpel, subpel, sizeof(c_subpel));
}

extern "C" int mc_hplanes_launch(const void* refs, const void* combos,
                                 void* out, int H, int W, int C, int ib,
                                 void* stream) {
    if (C == 0 || H == 0) return 0;
    if (((uintptr_t)out & 15) != 0) return (int)cudaErrorMisalignedAddress;
    cudaStream_t s = (cudaStream_t)stream;
    dim3 grid((H + HP_ROWS - 1) / HP_ROWS, (C + HP_GROUP - 1) / HP_GROUP);
    const int n4 = (W + 22 + 31) >> 2;
    const size_t smem = (size_t)2 * n4 * 4 * sizeof(int32_t);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            mc_hplanes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    mc_hplanes_kernel<<<grid, HP_THREADS, smem, s>>>(
        (const int32_t*)refs, (const int32_t*)combos, (int16_t*)out, H, W, C,
        ib);
    return (int)cudaGetLastError();
}

extern "C" const char* mc_hplanes_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
