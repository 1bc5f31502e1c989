// CDEF (constrained directional enhancement): the luma direction search
// of every 8x8 block, and the primary/secondary filter of every plane,
// out of place.
//
// Replaces no Pallas kernel: the JAX package computed CDEF in XLA
// (dav1d_mirror_tpu/ops/cdef_tpu.py:243 cdef_frame_tpu, with cdef_dir_tpu
// :104 and cdef_filter_plane_tpu :146). Its plain PyTorch versions are
// dav1d_mirror_tpu_torch/ops/cdef.py::cdef_dir, cdef_filter_plane and
// cdef_frame, and the kernels compute exactly what they compute.
//
// cdef_dir_kernel: one thread an 8x8 block of the luma plane. It sums the
// block's pixels ((v >> (bd - 8)) - 128) into the partial sums of the
// eight direction classes, in dav1d's cost order (diag0, alt0, hv0, alt1,
// diag1, alt2, hv1, alt3), squares and weighs them in uint32 (the plain
// version masks every weighted square, and the sum, to 32 bits), takes the
// first maximum as the direction and (best - cost[dir ^ 4]) >> 10 as the
// variance.
//
// cdef_filter_kernel: a CTA a tile of 8 x 4 blocks, blockIdx.z the plane
// (one launch for a frame's planes). Inside the filtered region (hb * bh x
// wb * bw) a
// pixel of an active block with a primary or secondary strength gets
// px + ((sum - (sum < 0) + 8) >> 4), clamped to its taps' min and max
// where both strengths are set; every other pixel of the plane is copied.
// The taps are read from `src` (the pre-CDEF plane); outside the region a
// tap is MISSING (-32768) and skipped, except in the rows a band's halo
// gives above and below it. A block's direction and strengths come either
// from maps (the plain cdef_filter_plane's arguments) or, for a frame
// (cdef_frame), from the frame's inputs: the 64x64 strength index map, the
// per-4x4 noskip map, the two strength tables and the direction and
// variance maps, derived per block as cdef_frame derives them.
//
// Bound on the H100: bytes. The filter reads each pixel once and writes
// it once; the direction search reads the luma plane once. Per pixel the
// filter does up to twelve constrained taps, a few dozen integer ops,
// below the integer rate but not by much if every tap paid for a bounds
// test and a load from L1. Design for that: a CTA first derives its 32
// blocks' parameters and shifts once into shared memory, and stages its
// tile's source pixels with a 2 px border (MISSING or halo rows already
// in place) with coalesced loads; then each thread filters pixels of
// consecutive columns, its taps at fixed offsets in the staged tile, the
// direction table in __constant__ memory.
#include <cuda_runtime.h>
#include <stdint.h>

#define MISSING (-32768)
#define MAX_PLANES 3

// cdef_directions (dav1d): (dy, dx) of tap k of direction d, 12 rows
// (d + 2 and d + 4 wrap past 7); then UV_DIRS_TBL's two rows (4:2:2's
// chroma direction remap in the second). Set by cdef_init.
__constant__ int c_dirs[12][2][2];
__constant__ int c_uv_dirs[2][8];

// Mirrored by ops/cdef_cuda.DirArgs.
struct DirArgs {
    const int32_t* src;
    int32_t* dir;
    int32_t* var;
    long long sr, sc;
    int h8, w8, bd;
};

// Mirrored by ops/cdef_cuda.PlaneArgs.
struct PlaneArgs {
    const int32_t* src;    // taps and centre pixel
    const int32_t* plane;  // copied where the filter does not write
    int32_t* out;
    const int32_t* top;    // (2, >= W) halo rows above the region, or null
    const int32_t* bot;    // (2, >= W) halo rows below it, or null
    long long src_sr, src_sc, pl_sr, pl_sc, out_sr, out_sc;
    long long top_sr, top_sc, bot_sr, bot_sc;
    int Hp, Wp;            // the plane written
    int bw, bh;            // block size in pixels
    int damping;
    int chroma;            // frame mode: the plane takes uv strengths
};

// Mirrored by ops/cdef_cuda.FilterArgs.
struct FilterArgs {
    PlaneArgs pl[MAX_PLANES];
    // maps mode: per-block (hb, wb) direction, strengths and activity
    const void* m_dir;
    const void* m_pri;
    const void* m_sec;
    const void* m_act;
    // frame mode
    const void* idx;     // (n64y, n64x) strength index, -1 skipped
    const void* ns;      // (bh4, bw4) noskip
    const void* ystr;    // (8,) luma strengths
    const void* uvstr;   // (8,) chroma strengths
    const int32_t* dirm; // (hb, wb) from cdef_dir_kernel
    const int32_t* varm;
    long long dir_s0, dir_s1, pri_s0, pri_s1, sec_s0, sec_s1, act_s0, act_s1;
    long long idx_s0, idx_s1, ns_s0, ns_s1, ystr_s0, uvstr_s0;
    int dir_es, pri_es, sec_es, act_es, idx_es, ns_es, ystr_es, uvstr_es;
    int frame;           // 1: frame mode, 0: maps mode
    int hb, wb;          // blocks of the region
    int bh4, bw4;        // noskip map
    int uv_row;          // UV_DIRS_TBL row (1 at 4:2:2)
    int bd;
};

__device__ __forceinline__ int ld(const void* p, int es, long long off) {
    if (es == 1) return ((const int8_t*)p)[off];
    if (es == 2) return ((const int16_t*)p)[off];
    return ((const int32_t*)p)[off];
}

// ops/cdef._ulog2: floor(log2(x)) in four steps (x >= 1)
__device__ __forceinline__ int ulog2(int x) {
    int r = 0;
    if (x >= 256) { r += 8; x >>= 8; }
    if (x >= 16) { r += 4; x >>= 4; }
    if (x >= 4) { r += 2; x >>= 2; }
    if (x >= 2) r += 1;
    return r;
}

// ops/cdef.adjust_strength_v
__device__ __forceinline__ int adjust_strength(int strength, int var) {
    const int vs = var >> 6;
    const int i = vs > 0 ? min(ulog2(max(vs, 1)), 12) : 0;
    return var > 0 ? (strength * (4 + i) + 8) >> 4 : 0;
}

// ops/cdef._constrain_v
__device__ __forceinline__ int constrain(int diff, int threshold, int shift) {
    const int adiff = abs(diff);
    const int v = min(adiff, max(threshold - (adiff >> shift), 0));
    return diff >= 0 ? v : -v;
}

// The weighted squared partial sums of one cost class, in uint32 (the
// plain version's & 0xFFFFFFFF after each product and after the sum);
// dav1d's div_table[n] = 840 / (n + 1) weighs a bin of n + 1 pixels.
#define CDEF_DIV(n) (840u / ((n) + 1u))

__device__ __forceinline__ unsigned hv_cost(const unsigned (&s)[8]) {
    unsigned c = 0;
#pragma unroll
    for (int n = 0; n < 8; ++n) c += s[n] * s[n] * 105u;
    return c;
}

__device__ __forceinline__ unsigned diag_cost(const unsigned (&s)[15]) {
    unsigned c = s[7] * s[7] * 105u;
#pragma unroll
    for (int n = 0; n < 7; ++n)
        c += s[n] * s[n] * CDEF_DIV(n) + s[14 - n] * s[14 - n] * CDEF_DIV(n);
    return c;
}

__device__ __forceinline__ unsigned alt_cost(const unsigned (&s)[11]) {
    unsigned c = 0;
#pragma unroll
    for (int n = 3; n < 8; ++n) c += s[n] * s[n] * 105u;
#pragma unroll
    for (int j = 0; j < 3; ++j)
        c += s[j] * s[j] * CDEF_DIV(2 * j + 1) +
             s[10 - j] * s[10 - j] * CDEF_DIV(2 * j + 1);
    return c;
}

__global__ void cdef_dir_kernel(const DirArgs a) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= a.h8 * a.w8) return;
    const int by = b / a.w8, bx = b - by * a.w8;
    const int sh = a.bd - 8;
    unsigned diag0[15] = {}, diag1[15] = {};
    unsigned alt0[11] = {}, alt1[11] = {}, alt2[11] = {}, alt3[11] = {};
    unsigned hv0[8] = {}, hv1[8] = {};
    const int32_t* blk =
        a.src + (long long)by * 8 * a.sr + (long long)bx * 8 * a.sc;
#pragma unroll
    for (int y = 0; y < 8; ++y) {
#pragma unroll
        for (int x = 0; x < 8; ++x) {
            const unsigned px =
                (unsigned)(blk[y * a.sr + x * a.sc] >> sh) - 128u;
            diag0[y + x] += px;
            alt0[y + (x >> 1)] += px;
            hv0[y] += px;
            alt1[3 + y - (x >> 1)] += px;
            diag1[7 + y - x] += px;
            alt2[3 - (y >> 1) + x] += px;
            hv1[x] += px;
            alt3[(y >> 1) + x] += px;
        }
    }
    unsigned cost[8];
    cost[0] = diag_cost(diag0);
    cost[1] = alt_cost(alt0);
    cost[2] = hv_cost(hv0);
    cost[3] = alt_cost(alt1);
    cost[4] = diag_cost(diag1);
    cost[5] = alt_cost(alt2);
    cost[6] = hv_cost(hv1);
    cost[7] = alt_cost(alt3);
    int best = 0;
    unsigned best_cost = cost[0];
#pragma unroll
    for (int d = 1; d < 8; ++d)
        if (cost[d] > best_cost) {
            best_cost = cost[d];
            best = d;
        }
    a.dir[b] = best;
    a.var[b] = (int)((best_cost - cost[best ^ 4]) >> 10);
}

struct Block {
    int dir, pri, sec, act;
};

// A block's direction, strengths and activity: from the maps, or derived
// from the frame's inputs as ops/cdef.cdef_frame derives them.
__device__ Block block_params(const FilterArgs& a, const PlaneArgs& p,
                              int by, int bx) {
    Block k;
    if (!a.frame) {
        k.dir = ld(a.m_dir, a.dir_es, by * a.dir_s0 + bx * a.dir_s1);
        k.pri = ld(a.m_pri, a.pri_es, by * a.pri_s0 + bx * a.pri_s1);
        k.sec = ld(a.m_sec, a.sec_es, by * a.sec_s0 + bx * a.sec_s1);
        k.act = ld(a.m_act, a.act_es, by * a.act_s0 + bx * a.act_s1) != 0;
        return k;
    }
    const int sh = a.bd - 8;
    const int idx = ld(a.idx, a.idx_es, (by >> 3) * a.idx_s0 +
                                            (bx >> 3) * a.idx_s1);
    bool noskip = false;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
            const int y4 = 2 * by + dy, x4 = 2 * bx + dx;
            if (y4 < a.bh4 && x4 < a.bw4)
                noskip |= ld(a.ns, a.ns_es, y4 * a.ns_s0 + x4 * a.ns_s1) != 0;
        }
    const int sel = max(idx, 0);
    const int ly = ld(a.ystr, a.ystr_es, sel * a.ystr_s0);
    const int luv = ld(a.uvstr, a.uvstr_es, sel * a.uvstr_s0);
    const bool valid = idx >= 0 && noskip && (ly > 0 || luv > 0);
    const int lvl = p.chroma ? luv : ly;
    const int pri = (lvl >> 2) << sh;
    const int s0 = lvl & 3;
    const int sec = (s0 + (s0 == 3)) << sh;
    const int d = a.dirm[by * a.wb + bx];
    k.act = valid && lvl > 0;
    k.sec = k.act ? sec : 0;
    if (p.chroma) {
        k.dir = pri > 0 ? c_uv_dirs[a.uv_row][d] : 0;
        k.pri = k.act ? pri : 0;
    } else {
        k.dir = pri > 0 ? d : 0;
        k.pri = pri > 0 ? adjust_strength(pri, a.varm[by * a.wb + bx]) : 0;
    }
    return k;
}

__device__ __forceinline__ int tap(const PlaneArgs& p, int H, int W, int y,
                                   int x) {
    if (x < 0 || x >= W) return MISSING;
    if (y >= 0 && y < H) return p.src[y * p.src_sr + x * p.src_sc];
    if (y < 0 && y >= -2 && p.top)
        return p.top[(y + 2) * p.top_sr + x * p.top_sc];
    if (y >= H && y < H + 2 && p.bot)
        return p.bot[(y - H) * p.bot_sr + x * p.bot_sc];
    return MISSING;
}

// A CTA's tile: CDEF_TBX x CDEF_TBY blocks of its plane (64 x 32 luma
// pixels, 32 x 16 at 4:2:0 chroma).
#define CDEF_TBX 8
#define CDEF_TBY 4
#define CDEF_THREADS 256

__global__ void __launch_bounds__(CDEF_THREADS)
cdef_filter_kernel(const FilterArgs a) {
    const PlaneArgs& p = a.pl[blockIdx.z];
    const int bwl = p.bw == 8 ? 3 : 2, bhl = p.bh == 8 ? 3 : 2;  // 4 or 8
    const int twl = bwl + 3;                    // log2 of the tile's width
    const int tw = 1 << twl, th = CDEF_TBY << bhl;
    const int x0 = blockIdx.x << twl, y0 = blockIdx.y * th;
    if (x0 >= p.Wp || y0 >= p.Hp) return;       // past this plane
    const int H = a.hb << bhl, W = a.wb << bwl;
    const int sw = tw + 4;                      // staged row: 2 px a side
    __shared__ int s_px[(CDEF_TBY * 8 + 4) * (CDEF_TBX * 8 + 4)];
    __shared__ int s_dir[CDEF_TBX * CDEF_TBY], s_pri[CDEF_TBX * CDEF_TBY];
    __shared__ int s_sec[CDEF_TBX * CDEF_TBY], s_shift[CDEF_TBX * CDEF_TBY];

    // the tile's blocks: direction, strengths and shifts; 0 strengths for
    // a block that is inactive or past the region
    const int t0 = threadIdx.x;
    if (t0 < CDEF_TBX * CDEF_TBY) {
        const int by = (y0 >> bhl) + t0 / CDEF_TBX;
        const int bx = (x0 >> bwl) + t0 % CDEF_TBX;
        Block k = {0, 0, 0, 0};
        if (by < a.hb && bx < a.wb) k = block_params(a, p, by, bx);
        if (!k.act) k.pri = k.sec = 0;
        s_dir[t0] = k.dir;
        s_pri[t0] = k.pri;
        s_sec[t0] = k.sec;
        s_shift[t0] = max(p.damping - ulog2(max(k.pri, 1)), 0) |
                      (p.damping - ulog2(max(k.sec, 1))) << 8;
    }
    // the tile's source pixels with a 2 px border, as the taps read them
    if (y0 < H && x0 < W)
        for (int t = t0; t < (th + 4) * sw; t += CDEF_THREADS) {
            const int ty = t / sw;
            s_px[t] = tap(p, H, W, y0 - 2 + ty, x0 - 2 + t - ty * sw);
        }
    __syncthreads();

    const int sh = a.bd - 8;
    for (int t = t0; t < th << twl; t += CDEF_THREADS) {
        const int ly = t >> twl, lx = t & (tw - 1);
        const int y = y0 + ly, x = x0 + lx;
        if (y >= p.Hp || x >= p.Wp) continue;
        const int b = (ly >> bhl) * CDEF_TBX + (lx >> bwl);
        const int pri = s_pri[b], sec = s_sec[b];
        int v;
        if (y < H && x < W && (pri > 0 || sec > 0)) {
            const int* c = s_px + (ly + 2) * sw + lx + 2;
            const int px = c[0];
            const int dir = s_dir[b];
            const int pri_tap0 = 4 - ((pri >> sh) & 1);
            const int pri_shift = s_shift[b] & 255;
            const int sec_shift = s_shift[b] >> 8;
            const bool minmax = pri > 0 && sec > 0;
            int sum = 0, mn = px, mx = px;
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                const int tapk = k == 0 ? pri_tap0 : ((pri_tap0 & 3) | 2);
                const int* pd = c_dirs[dir + 2][k];
                const int po = pd[0] * sw + pd[1];
#pragma unroll
                for (int sg = 0; sg < 2; ++sg) {
                    const int q = c[sg ? -po : po];
                    if (q != MISSING && pri > 0) {
                        sum += tapk * constrain(q - px, pri, pri_shift);
                        if (minmax) {
                            mn = min(mn, q);
                            mx = max(mx, q);
                        }
                    }
                }
#pragma unroll
                for (int ci = 0; ci < 2; ++ci) {
                    const int* sd = c_dirs[dir + (ci ? 0 : 4)][k];
                    const int so = sd[0] * sw + sd[1];
#pragma unroll
                    for (int sg = 0; sg < 2; ++sg) {
                        const int q = c[sg ? -so : so];
                        if (q != MISSING && sec > 0) {
                            sum += (2 - k) *
                                   constrain(q - px, sec, sec_shift);
                            if (minmax) {
                                mn = min(mn, q);
                                mx = max(mx, q);
                            }
                        }
                    }
                }
            }
            v = px + ((sum - (sum < 0) + 8) >> 4);
            if (minmax) v = min(max(v, mn), mx);
        } else {
            v = p.plane[y * (int)p.pl_sr + x * (int)p.pl_sc];
        }
        p.out[y * (int)p.out_sr + x * (int)p.out_sc] = v;
    }
}

extern "C" int cdef_init(const void* table) {
    const int* t = (const int*)table;
    cudaError_t e = cudaMemcpyToSymbol(c_dirs, t, sizeof(c_dirs));
    if (e != cudaSuccess) return (int)e;
    return (int)cudaMemcpyToSymbol(c_uv_dirs, t + 48, sizeof(c_uv_dirs));
}

extern "C" int cdef_dir_args_size() { return (int)sizeof(DirArgs); }
extern "C" int cdef_filter_args_size() { return (int)sizeof(FilterArgs); }

extern "C" int cdef_dir_launch(const DirArgs* args, void* stream) {
    const int n = args->h8 * args->w8;
    if (n <= 0) return 0;
    cdef_dir_kernel<<<(n + 127) / 128, 128, 0, (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}

extern "C" int cdef_filter_launch(const FilterArgs* args, int n_planes,
                                  void* stream) {
    // tiles of CDEF_TBX x CDEF_TBY blocks over the largest plane extent
    int gx = 0, gy = 0;
    for (int i = 0; i < n_planes; ++i) {
        const PlaneArgs& p = args->pl[i];
        gx = max(gx, (p.Wp + CDEF_TBX * p.bw - 1) / (CDEF_TBX * p.bw));
        gy = max(gy, (p.Hp + CDEF_TBY * p.bh - 1) / (CDEF_TBY * p.bh));
    }
    if (n_planes <= 0 || gx <= 0 || gy <= 0) return 0;
    cdef_filter_kernel<<<dim3(gx, gy, n_planes), CDEF_THREADS, 0,
                         (cudaStream_t)stream>>>(*args);
    return (int)cudaGetLastError();
}

extern "C" const char* cdef_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
