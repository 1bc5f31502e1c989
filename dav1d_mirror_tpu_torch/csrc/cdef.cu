// CDEF (constrained directional enhancement): the luma direction search
// of every 8x8 block, and the primary/secondary filter of every plane,
// out of place. Three kernels:
//  - cdef_frame_kernel: a frame, one launch (ops/cdef_cuda.cdef_frame; the
//    decode's cdef record): the direction search and every plane's
//    filter, each block's direction and strengths derived in the kernel
//    from the frame's inputs (the 64x64 strength index map, the per-4x4
//    noskip map, the two strength tables), as ops/cdef.cdef_frame derives
//    them;
//  - cdef_dir_kernel and cdef_filter_kernel: the direction search alone
//    and the filter of one plane from per-block maps (cdef_dir,
//    cdef_filter_plane), which only the tile-sharded decode's row bands
//    use (parallel/filter_shard.cdef_banded and band_cdef_plane).
//
// Replaces no Pallas kernel: the JAX package computed CDEF in XLA
// (dav1d_mirror_tpu/ops/cdef_tpu.py:243 cdef_frame_tpu, with cdef_dir_tpu
// :104 and cdef_filter_plane_tpu :146). Its plain PyTorch versions are
// dav1d_mirror_tpu_torch/ops/cdef.py::cdef_dir, cdef_filter_plane and
// cdef_frame, and the kernels compute exactly what they compute.
//
// The direction search sums a block's pixels ((v >> (bd - 8)) - 128) into
// the partial sums of the eight direction classes, in dav1d's cost order
// (diag0, alt0, hv0, alt1, diag1, alt2, hv1, alt3), squares and weighs
// them in uint32 (the plain version masks every weighted square, and the
// sum, to 32 bits), takes the first maximum as the direction and (best -
// cost[dir ^ 4]) >> 10 as the variance. The sums mod 2^32 do not depend
// on their order: cdef_dir_kernel gives a block one thread, the frame
// kernel a block eight, one a class.
//
// The filter: inside the filtered region (hb * bh x wb * bw) a pixel of
// an active block with a primary or secondary strength gets px + ((sum -
// (sum < 0) + 8) >> 4), clamped to its taps' min and max where both
// strengths are set; every other pixel of the plane is copied. The taps
// are read from `src` (the pre-CDEF plane); outside the region a tap is
// MISSING (-32768) and skipped, except in the rows a band's halo gives
// above and below it.
//
// Bound on the H100: bytes by the data sheet's rates, but the filter's
// dozen constrained taps a pixel are integer min, max, abs and shift
// operations, which issue at half the rate of the float units: at full
// strength a frame is close to bound by them. Design for that: a CTA
// stages its tiles' pixels (a 2 px border, MISSING or halo rows already
// in place) and its 32 blocks' parameters and tap offsets once in shared
// memory; a warp filters one block (two at 4:2:0 chroma), so its
// parameters and its case (primary only, secondary only, both, or a
// block at the region's border that tests for MISSING taps) are the
// warp's.
#include <cuda_runtime.h>
#include <stdint.h>

#define MISSING (-32768)
// CDEF_SKIP_DIR and CDEF_SKIP_FILTER are for the timing builds of
// tools/cdef_phases.py only, whose output is not the function's: no
// direction search (direction and variance 0), no filter (every pixel
// copied). The decoder's build defines neither.
#ifdef CDEF_SKIP_DIR
#define CDEF_DIR 0
#else
#define CDEF_DIR 1
#endif
#ifdef CDEF_SKIP_FILTER
#define CDEF_FILTER 0
#else
#define CDEF_FILTER 1
#endif
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
    int vec;               // src and src_sr are multiples of 4 ints, src_sc 1
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
    long long dir_s0, dir_s1, pri_s0, pri_s1, sec_s0, sec_s1, act_s0, act_s1;
    long long idx_s0, idx_s1, ns_s0, ns_s1, ystr_s0, uvstr_s0;
    int dir_es, pri_es, sec_es, act_es, idx_es, ns_es, ystr_es, uvstr_es;
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

// A block's direction, strengths and activity from the maps
// (cdef_filter_plane's arguments).
__device__ Block block_params(const FilterArgs& a, int by, int bx) {
    Block k;
    k.dir = ld(a.m_dir, a.dir_es, by * a.dir_s0 + bx * a.dir_s1);
    k.pri = ld(a.m_pri, a.pri_es, by * a.pri_s0 + bx * a.pri_s1);
    k.sec = ld(a.m_sec, a.sec_es, by * a.sec_s0 + bx * a.sec_s1);
    k.act = ld(a.m_act, a.act_es, by * a.act_s0 + bx * a.act_s1) != 0;
    return k;
}

// A block's luma and chroma strength levels from the frame's inputs, as
// ops/cdef.cdef_frame derives them: 0 where the block is not valid (a
// skipped 64x64 unit, every 4x4 skipped, or both levels 0).
__device__ void block_levels(const FilterArgs& a, int by, int bx, int& ly,
                             int& luv) {
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
    ly = ld(a.ystr, a.ystr_es, sel * a.ystr_s0);
    luv = ld(a.uvstr, a.uvstr_es, sel * a.uvstr_s0);
    if (!(idx >= 0 && noskip && (ly > 0 || luv > 0))) ly = luv = 0;
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

// The six tap offsets of direction dir in a tile of pitch sw: the
// primary tap k (k = 0, 1), then the secondary taps of direction dir + 4
// and dir + 0 for k = 0, then for k = 1 (each tap is read at +- its
// offset).
__device__ __forceinline__ void dir_offsets(int dir, int sw, int (&o)[6]) {
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        o[k] = c_dirs[dir + 2][k][0] * sw + c_dirs[dir + 2][k][1];
        o[2 + 2 * k] = c_dirs[dir + 4][k][0] * sw + c_dirs[dir + 4][k][1];
        o[3 + 2 * k] = c_dirs[dir][k][0] * sw + c_dirs[dir][k][1];
    }
}

// The filter at one pixel: c points at it in a staged tile (2 px border,
// MISSING where a tap is missing; CHECK false where none can be), o its
// block's tap offsets (dir_offsets); the block's strengths and packed
// shifts (primary | secondary << 8). MODE 1, 2 or 3: the block has only
// a primary, only a secondary or both strengths (0: either, tested at
// run time).
template <bool CHECK = true, int MODE = 0>
__device__ __forceinline__ int filter_px(const int* c, const int (&o)[6],
                                         int pri, int sec, int shift,
                                         int sh) {
    const int px = c[0];
    const bool use_pri = MODE ? (MODE & 1) != 0 : pri > 0;
    const bool use_sec = MODE ? (MODE & 2) != 0 : sec > 0;
    const bool minmax = use_pri && use_sec;
    const int pri_tap0 = 4 - ((pri >> sh) & 1);
    const int pri_shift = shift & 255;
    const int sec_shift = shift >> 8;
    int sum = 0, mn = px, mx = px;
    int tv[12];        // the taps, for a three-input min and max
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const int tapk = k == 0 ? pri_tap0 : ((pri_tap0 & 3) | 2);
#pragma unroll
        for (int sg = 0; sg < 2; ++sg) {
            const int q = c[sg ? -o[k] : o[k]];
            tv[2 * k + sg] = q;
            if ((!CHECK || q != MISSING) && use_pri) {
                sum += tapk * constrain(q - px, pri, pri_shift);
                if (CHECK && minmax) {
                    mn = min(mn, q);
                    mx = max(mx, q);
                }
            }
        }
#pragma unroll
        for (int ci = 0; ci < 2; ++ci) {
            const int so = o[2 + 2 * k + ci];
#pragma unroll
            for (int sg = 0; sg < 2; ++sg) {
                const int q = c[sg ? -so : so];
                tv[4 + 4 * k + 2 * ci + sg] = q;
                if ((!CHECK || q != MISSING) && use_sec) {
                    sum += (2 - k) * constrain(q - px, sec, sec_shift);
                    if (CHECK && minmax) {
                        mn = min(mn, q);
                        mx = max(mx, q);
                    }
                }
            }
        }
    }
    if (!CHECK && minmax) {
#pragma unroll
        for (int n = 0; n < 12; n += 2) {
            mn = __vimin3_s32(mn, tv[n], tv[n + 1]);
            mx = __vimax3_s32(mx, tv[n], tv[n + 1]);
        }
    }
    int v = px + ((sum - (sum < 0) + 8) >> 4);
    if (minmax) v = min(max(v, mn), mx);
    return v;
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
        if (by < a.hb && bx < a.wb) k = block_params(a, by, bx);
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
            int o[6];
            dir_offsets(s_dir[b], sw, o);
            v = filter_px(s_px + (ly + 2) * sw + lx + 2, o, pri, sec,
                          s_shift[b], sh);
        } else
            v = p.plane[y * (int)p.pl_sr + x * (int)p.pl_sc];
        p.out[y * (int)p.out_sr + x * (int)p.out_sc] = v;
    }
}

// ---- the frame kernel (cdef_frame): one launch a frame ----

#define CDEF_NB (CDEF_TBX * CDEF_TBY)

// The cost of direction class C of an 8x8 block (blk: its first pixel in
// a staged tile of pitch sw, 16-byte aligned rows): its bins over the
// block's pixels ((v >> sh) - 128) read a row at a time, in
// cdef_dir_kernel's bin order (diag0, alt0, hv0, alt1, diag1, alt2, hv1,
// alt3), squared and weighed in uint32.
template <int C>
__device__ __forceinline__ unsigned class_cost(const int* blk, int sw,
                                               int sh) {
    constexpr int NB = C == 0 || C == 4 ? 15 : C == 2 || C == 6 ? 8 : 11;
    unsigned bin[NB] = {};
    unsigned n[NB] = {};   // pixels a bin (constants after unrolling)
#pragma unroll
    for (int y = 0; y < 8; ++y) {
        const int4 l = *reinterpret_cast<const int4*>(blk + y * sw);
        const int4 h = *reinterpret_cast<const int4*>(blk + y * sw + 4);
        const int v[8] = {l.x, l.y, l.z, l.w, h.x, h.y, h.z, h.w};
#pragma unroll
        for (int x = 0; x < 8; ++x) {
            const int b = C == 0 ? y + x : C == 1 ? y + (x >> 1) : C == 2 ? y :
                          C == 3 ? 3 + y - (x >> 1) : C == 4 ? 7 + y - x :
                          C == 5 ? 3 - (y >> 1) + x : C == 6 ? x
                                                           : (y >> 1) + x;
            bin[b] += (unsigned)(v[x] >> sh);
            n[b] += 1;
        }
    }
    // each pixel enters as (v >> sh) - 128: the 128s once a bin
#pragma unroll
    for (int b = 0; b < NB; ++b) bin[b] -= 128u * n[b];
    if constexpr (NB == 15) return diag_cost(bin);
    else if constexpr (NB == 8) return hv_cost(bin);
    else return alt_cost(bin);
}

// A CTA's block parameters in shared memory, [luma, chroma] each: the
// tap offsets (dir_offsets), strengths and packed shifts; and whether no
// tap of the block can be missing.
struct TileParams {
    int off[2][6][CDEF_NB], pri[2][CDEF_NB], sec[2][CDEF_NB];
    int shift[2][CDEF_NB];
    bool inner[CDEF_NB];
};

// One plane's pixels of a CTA's tile, blocks of (1 << BWL) x (1 << BHL):
// a warp one block at a time (two 4x4 blocks), a lane one column of it
// and every (LPB / BW)th row, so that a warp's lanes share their block's
// parameters and case (copied, primary only, secondary only, both, or a
// block at the region's border that tests for MISSING taps), and a
// thread's pixels lie at fixed offsets from its first.
template <int BWL, int BHL>
__device__ __forceinline__ void filter_tile(const PlaneArgs& p, const int* s,
                                            const TileParams& tp, int c,
                                            int x0, int y0, int H, int W,
                                            int sh) {
    constexpr int BW = 1 << BWL, BH = 1 << BHL, P = BW * BH;
    constexpr int SW = CDEF_TBX * BW + 8;      // the staged tile's pitch
    constexpr int LPB = P >= 32 ? 32 : P;      // lanes a block
    constexpr int PER = P / LPB;               // pixels a lane a block
    constexpr int BPW = 32 / LPB;              // blocks a warp at a time
    constexpr int RS = LPB / BW;               // rows between them
    constexpr int WARPS = CDEF_THREADS / 32;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll 1
    for (int pass = 0; pass < CDEF_NB / (WARPS * BPW); ++pass) {
        const int b = (pass * WARPS + warp) * BPW + lane / LPB;
        const int l = lane % LPB;
        const int lx = (b % CDEF_TBX) * BW + l % BW;
        const int ly = (b / CDEF_TBX) * BH + l / BW;
        const int* cp = s + (ly + 2) * SW + lx + 4;
        const int pri = tp.pri[c][b], sec = tp.sec[c][b];
        const int sf = tp.shift[c][b];
        int o[6];
#pragma unroll
        for (int n = 0; n < 6; ++n) o[n] = tp.off[c][n][b];
        const int mode = !CDEF_FILTER || (pri <= 0 && sec <= 0) ? 0
                         : !tp.inner[b] ? 4 : (pri > 0) | (sec > 0) << 1;
        int v[PER];
        switch (mode) {
            case 0:
#pragma unroll
                for (int k = 0; k < PER; ++k) v[k] = cp[k * RS * SW];
                break;
            case 1:
#pragma unroll
                for (int k = 0; k < PER; ++k)
                    v[k] = filter_px<false, 1>(cp + k * RS * SW, o, pri, sec,
                                               sf, sh);
                break;
            case 2:
#pragma unroll
                for (int k = 0; k < PER; ++k)
                    v[k] = filter_px<false, 2>(cp + k * RS * SW, o, pri, sec,
                                               sf, sh);
                break;
            case 3:
#pragma unroll
                for (int k = 0; k < PER; ++k)
                    v[k] = filter_px<false, 3>(cp + k * RS * SW, o, pri, sec,
                                               sf, sh);
                break;
            default:
#pragma unroll
                for (int k = 0; k < PER; ++k)
                    v[k] = filter_px(cp + k * RS * SW, o, pri, sec, sf, sh);
        }
        const int x = x0 + lx;
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const int y = y0 + ly + k * RS;
            if (y >= p.Hp || x >= p.Wp) continue;
            p.out[y * (int)p.out_sr + x * (int)p.out_sc] =
                y < H && x < W ? v[k]
                               : p.plane[y * (int)p.pl_sr + x * (int)p.pl_sc];
        }
    }
}

// One CTA: a tile of CDEF_TBX x CDEF_TBY blocks (64 x 32 luma pixels) and
// its co-located tile of every chroma plane. It stages each plane's
// pixels once (2 rows and 4 columns a side, MISSING outside the region;
// 16-byte loads inside it) into dynamic shared memory; warp w computes
// direction class w of the tile's blocks that a primary strength needs,
// a lane a block, so the eight classes of a block are eight threads'
// (uint32 sums are independent of order: the costs are
// ops/cdef.cdef_dir's); a thread a block derives its direction (the
// first maximum), variance and strengths as ops/cdef.cdef_frame does;
// then every plane's pixels are filtered from the staged tiles.
__global__ void __launch_bounds__(CDEF_THREADS)
cdef_frame_kernel(const FilterArgs a, int n_planes) {
    extern __shared__ int4 s_px4[];
    int* s_px = reinterpret_cast<int*>(s_px4);
    __shared__ unsigned s_cost[8][CDEF_NB];
    __shared__ int s_ly[CDEF_NB], s_luv[CDEF_NB];
    __shared__ TileParams tp;
    const int t0 = threadIdx.x;
    const int bx0 = blockIdx.x * CDEF_TBX, by0 = blockIdx.y * CDEF_TBY;
    const int sh = a.bd - 8;

    // 1. the blocks' strength levels; each plane's pixels
    if (t0 < CDEF_NB) {
        const int by = by0 + t0 / CDEF_TBX, bx = bx0 + t0 % CDEF_TBX;
        int ly = 0, luv = 0;
        if (by < a.hb && bx < a.wb) block_levels(a, by, bx, ly, luv);
        s_ly[t0] = ly;
        s_luv[t0] = n_planes > 1 ? luv : 0;
    }
    int base = 0;
    for (int i = 0; i < n_planes; ++i) {
        const PlaneArgs& p = a.pl[i];
        const int bwl = p.bw == 8 ? 3 : 2, bhl = p.bh == 8 ? 3 : 2;
        const int tw = CDEF_TBX << bwl, th = CDEF_TBY << bhl;
        const int x0 = bx0 << bwl, y0 = by0 << bhl;
        const int H = a.hb << bhl, W = a.wb << bwl;
        const int sw = tw + 8;
        int* s = s_px + base;
        base += (th + 4) * sw;
        if (p.vec && y0 >= 2 && x0 >= 4 && y0 + th + 2 <= H &&
            x0 + tw + 4 <= W) {
            // inside the region: rows of 16-byte loads
            const int32_t* src = p.src + (y0 - 2) * (int)p.src_sr + x0 - 4;
            const int V = sw >> 2;
#pragma unroll 4
            for (int t = t0; t < (th + 4) * V; t += CDEF_THREADS) {
                const int ty = t / V, v = t - ty * V;
                *reinterpret_cast<int4*>(s + ty * sw + 4 * v) =
                    *reinterpret_cast<const int4*>(src + ty * (int)p.src_sr +
                                                   4 * v);
            }
        } else if (y0 < H && x0 < W) {
#pragma unroll 4
            for (int t = t0; t < (th + 4) * sw; t += CDEF_THREADS) {
                const int ty = t / sw;
                s[t] = tap(p, H, W, y0 - 2 + ty, x0 - 4 + t - ty * sw);
            }
        }
    }
    __syncthreads();

    // 2. the direction search: warp w, class w; lane b, block b
    {
        const int b = t0 & 31;
        if (CDEF_DIR && ((s_ly[b] >> 2) > 0 || (s_luv[b] >> 2) > 0)) {
            constexpr int sw = CDEF_TBX * 8 + 8;
            const int* blk = s_px + (2 + 8 * (b / CDEF_TBX)) * sw + 4 +
                             8 * (b % CDEF_TBX);
            unsigned c;
            switch (t0 >> 5) {
                case 0: c = class_cost<0>(blk, sw, sh); break;
                case 1: c = class_cost<1>(blk, sw, sh); break;
                case 2: c = class_cost<2>(blk, sw, sh); break;
                case 3: c = class_cost<3>(blk, sw, sh); break;
                case 4: c = class_cost<4>(blk, sw, sh); break;
                case 5: c = class_cost<5>(blk, sw, sh); break;
                case 6: c = class_cost<6>(blk, sw, sh); break;
                default: c = class_cost<7>(blk, sw, sh); break;
            }
            s_cost[t0 >> 5][b] = c;
        }
    }
    __syncthreads();

    // 3. each block's direction (the first maximum) and variance, then its
    // luma and chroma parameters (cdef_frame's maps)
    if (t0 < CDEF_NB) {
        const int by = by0 + t0 / CDEF_TBX, bx = bx0 + t0 % CDEF_TBX;
        tp.inner[t0] = by >= 1 && by + 1 < a.hb && bx >= 1 && bx + 1 < a.wb;
        int d = 0, var = 0;
        if (CDEF_DIR && ((s_ly[t0] >> 2) > 0 || (s_luv[t0] >> 2) > 0)) {
            unsigned best_cost = s_cost[0][t0];
#pragma unroll
            for (int k = 1; k < 8; ++k)
                if (s_cost[k][t0] > best_cost) {
                    best_cost = s_cost[k][t0];
                    d = k;
                }
            var = (int)((best_cost - s_cost[d ^ 4][t0]) >> 10);
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
            const int lvl = c ? s_luv[t0] : s_ly[t0];
            const int pri = (lvl >> 2) << sh;
            const int s0 = lvl & 3;
            const int sec = lvl > 0 ? (s0 + (s0 == 3)) << sh : 0;
            int kpri = c ? pri : (pri > 0 ? adjust_strength(pri, var) : 0);
            if (lvl == 0) kpri = 0;
            const PlaneArgs& p = a.pl[c && n_planes > 1 ? 1 : 0];
            int o[6];
            dir_offsets(pri > 0 ? (c ? c_uv_dirs[a.uv_row][d] : d) : 0,
                        (CDEF_TBX << (p.bw == 8 ? 3 : 2)) + 8, o);
#pragma unroll
            for (int n = 0; n < 6; ++n) tp.off[c][n][t0] = o[n];
            tp.pri[c][t0] = kpri;
            tp.sec[c][t0] = sec;
            tp.shift[c][t0] = max(p.damping - ulog2(max(kpri, 1)), 0) |
                              (p.damping - ulog2(max(sec, 1))) << 8;
        }
    }
    __syncthreads();

    // 4. every plane's pixels of the tile
    base = 0;
    for (int i = 0; i < n_planes; ++i) {
        const PlaneArgs& p = a.pl[i];
        const int bwl = p.bw == 8 ? 3 : 2, bhl = p.bh == 8 ? 3 : 2;
        const int x0 = bx0 << bwl, y0 = by0 << bhl;
        const int H = a.hb << bhl, W = a.wb << bwl;
        const int* s = s_px + base;
        base += ((CDEF_TBY << bhl) + 4) * ((CDEF_TBX << bwl) + 8);
        if (bwl == 3 && bhl == 3)
            filter_tile<3, 3>(p, s, tp, i > 0, x0, y0, H, W, sh);
        else if (bhl == 3)
            filter_tile<2, 3>(p, s, tp, i > 0, x0, y0, H, W, sh);
        else if (bwl == 3)
            filter_tile<3, 2>(p, s, tp, i > 0, x0, y0, H, W, sh);
        else
            filter_tile<2, 2>(p, s, tp, i > 0, x0, y0, H, W, sh);
    }
}

// Dynamic shared memory of the frame kernel: each plane's staged tile.
static int frame_smem(const FilterArgs* a, int n_planes) {
    int n = 0;
    for (int i = 0; i < n_planes; ++i)
        n += (CDEF_TBY * a->pl[i].bh + 4) * (CDEF_TBX * a->pl[i].bw + 8);
    return n * (int)sizeof(int);
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

extern "C" int cdef_frame_launch(const FilterArgs* args, int n_planes,
                                 void* stream) {
    // tiles of CDEF_TBX x CDEF_TBY blocks over the largest plane extent,
    // every plane's co-located tile in one CTA
    int gx = 0, gy = 0;
    for (int i = 0; i < n_planes; ++i) {
        const PlaneArgs& p = args->pl[i];
        gx = max(gx, (p.Wp + CDEF_TBX * p.bw - 1) / (CDEF_TBX * p.bw));
        gy = max(gy, (p.Hp + CDEF_TBY * p.bh - 1) / (CDEF_TBY * p.bh));
    }
    if (n_planes <= 0 || gx <= 0 || gy <= 0) return 0;
    const int smem = frame_smem(args, n_planes);
    cudaError_t e = cudaFuncSetAttribute(
        cdef_frame_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    cdef_frame_kernel<<<dim3(gx, gy), CDEF_THREADS, smem,
                        (cudaStream_t)stream>>>(*args, n_planes);
    return (int)cudaGetLastError();
}

extern "C" const char* cdef_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
