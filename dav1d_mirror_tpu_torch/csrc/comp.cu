// Every compound join of a frame program in one launch over the frame's
// work list (its `comprun` record: every `comp` record, of every plane),
// each result stored straight into its plane: the average and
// distance-weighted average, the wedge mask, and the difference-weighted
// ("seg") mask, whose chroma joins derive their mask from the luma
// join's two sides.
//
// Replaces, on the port's executor path, what XLA fused on the TPU:
// dav1d_mirror_tpu/ops/mc_tpu.py::comp_join_wavg (:328), comp_join_wmask
// (:335) and comp_join_mask (:347), with w_avg_batch, w_mask_batch and
// mask_batch (:246, :414, :256), then scatter_units (:266) of the joined
// slots; not Pallas kernels. Its plain PyTorch version is
// dav1d_mirror_tpu_torch/ops/mc.py::comp_run (one comp_record an entry;
// dav1d mc_tmpl.c avg:589, w_avg:604, mask:620, w_mask:683).
//
// The work list (ops/mc.comp_build_table): CENTRY ints an entry (plane,
// slot shape, the seg chroma mask's cell, the arena offsets of the two
// sides' slot buffers, the origins' offsets in the int32 descriptor
// buffer, real slots, first row, and the prefix sum of the work items of
// the entries before it), then CROW ints a row, one row a real slot
// (kind, par, moff, and for a seg chroma row its luma slot's sides,
// shape and sign). Slot s of an entry has the sides t0, t1 (its (bh, bw)
// prep-domain int32 slots) and its row (kind, par, moff):
//   WAVG  par = weight w:  clamp((t0 w + t1 (16 - w) + rnd16) >> (ib + 4))
//   else  par = sign: (a, b) = sign ? (t1, t0) : (t0, t1), and
//         clamp((a m + b (64 - m) + rnd64) >> (ib + 6)) with
//   SEGL  m = min(38 + ((|a - b| + mrnd) >> msh), 64)
//   SEGC  m = the luma slot's chroma mask at flat offset y bw + x: its
//         cell (1 << cv rows, 1 << ch columns) of luma m summed, then
//         (sum + 2 - lsign) >> 2 (4:2:0), (sum + 1 - lsign) >> 1 (4:2:2)
//         or the sum (4:4:4)
//   WEDGE m = desc[moff + y bw + x]
// rnd16 = (8 << ib) + 16 bias, rnd64 = (32 << ib) + 64 bias,
// msh = bd + ib - 4, mrnd = 1 << (msh - 5), bias 8192 above 8 bit.
// Each pixel goes to plane[dy[s] + y][dx[s] + x], dropped outside the
// plane; a slot whose mask or sides lie outside their buffer is dropped
// whole.
//
// The plain version runs the entries in order and keeps each seg luma
// slot's chroma mask in an arena, where a later chroma entry reads it.
// Here a seg chroma pixel derives its mask value from the luma sides
// again (they stay in the frame's arena), so no kernel writes a mask and
// the launch has no order between entries. The planner's blocks are
// disjoint and the table has a row a real slot (the PAD_OOB pad slots
// are not in it), so no two threads store to one pixel.
//
// Bound on the H100: bytes. A joined pixel reads its two sides (and a
// wedge mask value, or a seg chroma cell's 2 to 8 luma side values) and
// writes one plane pixel: a few integer operations a byte. What held the
// per-record design back was its launches (a grid of a few CTAs a
// record, near the empty-launch floor each), not its arithmetic.
//
// Design: a thread a work item, over the prefix of the frame's entries,
// so all records share one grid (persistent CTAs, as many as fit on the
// card, at a stride of the grid). An item is CP_ITEM consecutive pixels
// of a slot's row (a compound block is 8x8 luma or larger, so every slot
// is 4 or more wide; ops/mc.comp_build_table refuses a width that is
// not a multiple of CP_ITEM), so the entry search, the divisions, the
// slot's row and origins are paid once for four pixels. Consecutive
// threads take consecutive items of a slot's rows, so the side reads and
// the plane stores coalesce. Each CTA stages the entry table into
// shared memory; a thread finds its entry by a binary search of the
// prefix column and reads its slot's row through the read-only cache
// (the threads of a slot share it). -DCOMP_SKIP_SEGC (a seg chroma mask
// of 32, no luma reads: computes something else) is a timing build only
// (tools/tool_runs.py).
#include <cuda_runtime.h>
#include <stdint.h>

#define CP_THREADS 256
#define CP_PLANES 3
#define CP_SMEM_ENTRIES 512    // the entries in shared memory up to this
enum { CJ_WAVG, CJ_SEGL, CJ_SEGC, CJ_WEDGE };

// entry fields (ops/mc.py C_*) and row fields (R_*)
enum { C_PLANE, C_BH, C_BW, C_CH, C_CV, C_S0, C_S1, C_DY, C_DX, C_NREAL,
       C_FIRST, C_START, CENTRY };
#define CP_ITEM 4              // the pixels of a work item (ops/mc.py)
enum { R_KIND, R_PAR, R_MOFF, R_L0, R_L1, R_LH, R_LW, R_LSGN, CROW };

typedef struct {
    const int32_t* tab;    // n_entries x CENTRY ints, then n_rows x CROW
    const int32_t* desc;   // the frame's int32 descriptor buffer
    const int32_t* arena;  // the frame's flat int32 slot arena
    int32_t* plane[CP_PLANES];
    long long arena_n, desc_n;
    int plane_h[CP_PLANES], plane_w[CP_PLANES], plane_rstride[CP_PLANES];
    int n_entries, n_rows, n_items;
    int bd, ib, bias, bd_max;
} CompRunArgs;

__device__ __forceinline__ int seg_m(int t0, int t1, int msh, int mrnd) {
    return min(38 + ((abs(t0 - t1) + mrnd) >> msh), 64);
}

__device__ __forceinline__ bool span_in(long long off, long long n,
                                        long long lim) {
    return off >= 0 && off + n <= lim;
}

__global__ void __launch_bounds__(CP_THREADS)
    comp_run_kernel(const __grid_constant__ CompRunArgs a) {
    extern __shared__ int32_t s_tab[];    // the entries, if they fit
    const bool staged = a.n_entries <= CP_SMEM_ENTRIES;
    if (staged)
        for (int i = threadIdx.x; i < a.n_entries * CENTRY; i += CP_THREADS)
            s_tab[i] = a.tab[i];
    __syncthreads();
    const int* T = staged ? s_tab : a.tab;
    const int32_t* rows = a.tab + (long long)a.n_entries * CENTRY;
    const int rnd16 = (8 << a.ib) + a.bias * 16;
    const int rnd64 = (32 << a.ib) + a.bias * 64;
    const int msh = a.bd + a.ib - 4;
    const int mrnd = 1 << (msh - 5);
    for (int i = blockIdx.x * CP_THREADS + threadIdx.x; i < a.n_items;
         i += gridDim.x * CP_THREADS) {
        int lo = 0, hi = a.n_entries - 1;
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (T[mid * CENTRY + C_START] <= i) lo = mid; else hi = mid - 1;
        }
        const int* en = T + lo * CENTRY;
        const int bh = en[C_BH], bw = en[C_BW];
        const int pl = en[C_PLANE], area = bh * bw;
        if (area <= 0 || bw % CP_ITEM || pl < 0 || pl >= CP_PLANES)
            continue;
        const int per = area / CP_ITEM;            // items a slot
        const int p = i - en[C_START];
        const int s = p / per, o = (p - s * per) * CP_ITEM;
        if (s >= en[C_NREAL] || en[C_FIRST] + s >= a.n_rows) continue;
        const int y = o / bw, x = o - y * bw;
        const int Y = a.desc[en[C_DY] + s] + y;
        const int X0 = a.desc[en[C_DX] + s] + x;
        if (Y < 0 || Y >= a.plane_h[pl] || X0 + CP_ITEM <= 0 ||
            X0 >= a.plane_w[pl])
            continue;
        const int32_t* row = rows + (long long)(en[C_FIRST] + s) * CROW;
        const int kind = __ldg(row + R_KIND), par = __ldg(row + R_PAR);
        const long long so = (long long)s * area;
        const long long i0 = en[C_S0] + so, i1 = en[C_S1] + so;
        if (!span_in(i0, area, a.arena_n) || !span_in(i1, area, a.arena_n))
            continue;
        int t0[CP_ITEM], t1[CP_ITEM];
#pragma unroll
        for (int k = 0; k < CP_ITEM; k++) {
            t0[k] = a.arena[i0 + o + k];
            t1[k] = a.arena[i1 + o + k];
        }
        // a slot whose mask lies outside its buffer is dropped whole
        const int32_t* mask = nullptr;
        int ch = 0, cv = 0, lw = 0, mw = 1, ls = 0;
        long long l0 = 0, l1 = 0;
        if (kind == CJ_WEDGE) {
            const long long moff = __ldg(row + R_MOFF);
            if (!span_in(moff, area, a.desc_n)) continue;
            mask = a.desc + moff;
        } else if (kind == CJ_SEGC) {
            ch = en[C_CH];
            cv = en[C_CV];
            const int lh = __ldg(row + R_LH);
            lw = __ldg(row + R_LW);
            mw = lw >> ch;
            l0 = __ldg(row + R_L0);
            l1 = __ldg(row + R_L1);
            ls = __ldg(row + R_LSGN);
            if (mw <= 0 || area > (lh >> cv) * mw ||
                !span_in(l0, (long long)lh * lw, a.arena_n) ||
                !span_in(l1, (long long)lh * lw, a.arena_n))
                continue;
        } else if (kind != CJ_WAVG && kind != CJ_SEGL) {
            continue;
        }
        int32_t* dst = a.plane[pl] + (long long)Y * a.plane_rstride[pl];
#pragma unroll
        for (int k = 0; k < CP_ITEM; k++) {
            const int X = X0 + k;
            if (X < 0 || X >= a.plane_w[pl]) continue;
            int v;
            if (kind == CJ_WAVG) {
                v = (t0[k] * par + t1[k] * (16 - par) + rnd16) >> (a.ib + 4);
            } else {
                int m;
                if (kind == CJ_SEGL) {
                    m = seg_m(t0[k], t1[k], msh, mrnd);
                } else if (kind == CJ_WEDGE) {
                    m = mask[o + k];
                } else {
#ifdef COMP_SKIP_SEGC
                    m = 32;
#else
                    // the luma slot's chroma mask at flat offset o + k:
                    // its cell (r, c) of (1 << cv) x (1 << ch) luma pixels
                    const int r = (o + k) / mw, c = (o + k) - r * mw;
                    const long long l = (long long)(r << cv) * lw + (c << ch);
                    int sum = 0;
                    for (int py = 0; py < (1 << cv); py++)
                        for (int px = 0; px < (1 << ch); px++) {
                            const long long q = l + (long long)py * lw + px;
                            sum += seg_m(a.arena[l0 + q], a.arena[l1 + q],
                                         msh, mrnd);
                        }
                    m = !ch ? sum : cv ? (sum + 2 - ls) >> 2
                                       : (sum + 1 - ls) >> 1;
#endif
                }
                const int pa = par == 0 ? t0[k] : t1[k];
                const int pb = par == 0 ? t1[k] : t0[k];
                v = (pa * m + pb * (64 - m) + rnd64) >> (a.ib + 6);
            }
            dst[X] = min(max(v, 0), a.bd_max);
        }
    }
}

extern "C" int comp_args_size() { return (int)sizeof(CompRunArgs); }

// One launch over a's work items on `stream`: persistent CTAs, as many as
// fit on the card, at most one a CP_THREADS items. Returns
// cudaGetLastError().
extern "C" int comp_launch(const CompRunArgs* a, void* stream) {
    if (a->n_items <= 0) return 0;
    if (a->n_entries <= 0 || a->ib < 0 || a->ib > 6 || a->bd < 8 ||
        a->bd > 12)
        return (int)cudaErrorInvalidValue;
    const size_t smem = a->n_entries <= CP_SMEM_ENTRIES
        ? sizeof(int32_t) * CENTRY * (size_t)a->n_entries : 0;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, comp_run_kernel, CP_THREADS, smem)) != cudaSuccess)
        return (int)e;
    if (per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    const int blocks = (a->n_items + CP_THREADS - 1) / CP_THREADS;
    const int grid = min(blocks, per_sm * sms);
    comp_run_kernel<<<grid, CP_THREADS, smem, (cudaStream_t)stream>>>(*a);
    return (int)cudaGetLastError();
}

extern "C" const char* comp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
