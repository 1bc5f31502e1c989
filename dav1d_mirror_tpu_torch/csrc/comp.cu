// Every compound join of one `comp` record of a frame program, in one
// launch, each result stored straight into the plane: the average and
// distance-weighted average, the wedge mask, and the difference-weighted
// ("seg") mask, whose luma joins derive the chroma mask that the chroma
// joins of the same blocks read later.
//
// Replaces, on the port's executor path, what XLA fused on the TPU:
// dav1d_mirror_tpu/ops/mc_tpu.py::comp_join_wavg (:328), comp_join_wmask
// (:335) and comp_join_mask (:347), with w_avg_batch, w_mask_batch and
// mask_batch (:246, :414, :256), then scatter_units (:266) of the joined
// slots; not Pallas kernels. Its plain PyTorch version is
// dav1d_mirror_tpu_torch/ops/mc.py::comp_record (dav1d mc_tmpl.c
// avg:589, w_avg:604, mask:620, w_mask:683).
//
// A record's slot s (0 <= s < n, its real slots) has the sides
// t0 = tmp0[s], t1 = tmp1[s] ((bhp, bwp) prep-domain int32) and a table
// row (kind, par, moff) (ops/mc.py CJ_*; models/frame_exec.McRun
// comp_table):
//   WAVG  par = weight w:  clamp((t0 w + t1 (16 - w) + rnd16) >> (ib + 4))
//   else  par = sign: (a, b) = sign ? (t1, t0) : (t0, t1), and
//         clamp((a m + b (64 - m) + rnd64) >> (ib + 6)) with
//   SEGL  m = min(38 + ((|a - b| + mrnd) >> msh), 64), and the chroma
//         mask written at masks[moff]: per 2x2 (4:2:0), 1x2 (4:2:2) or
//         1x1 (4:4:4) cell of m, (sum + 2 - sign) >> 2,
//         (sum + 1 - sign) >> 1 or m
//   SEGC  m = masks[moff + y bwp + x] (a luma SEGL launch wrote it)
//   WEDGE m = desc[moff + y bwp + x]
// rnd16 = (8 << ib) + 16 bias, rnd64 = (32 << ib) + 64 bias,
// msh = bd + ib - 4, mrnd = 1 << (msh - 5), bias 8192 above 8 bit.
// Each pixel goes to plane[dy[s] + y][dx[s] + x], dropped outside the
// plane.
//
// The planner's blocks are disjoint and the table has one row a real
// slot (the pad slots, whose destinations are PAD_OOB, are not in it), so
// no two threads store to one pixel or mask element. A slot whose mask
// span lies outside its buffer is dropped whole.
//
// Bound on the H100: bytes. A slot's pixel reads its two sides (and a
// mask value for SEGC and WEDGE) and writes one plane pixel (and SEGL a
// quarter of a mask value at 4:2:0): a few integer operations a byte.
//
// Design: a thread a cell of the chroma mask's subsampling (ch, cv): it
// computes the cell's 1, 2 or 4 pixels, stores them, and for a SEGL slot
// sums their m into its mask element, so the mask needs no second pass.
// Consecutive threads take consecutive cells of a slot's rows.
#include <cuda_runtime.h>
#include <stdint.h>

#define CP_THREADS 256
enum { CJ_WAVG, CJ_SEGL, CJ_SEGC, CJ_WEDGE };
#define CJ_COLS 3

typedef struct {
    const int32_t* tmp0;   // (N, bhp, bwp) side 0 slots
    const int32_t* tmp1;   // (N, bhp, bwp) side 1 slots
    const int32_t* tab;    // (n, CJ_COLS): kind, weight or sign, moff
    const int32_t* dy;     // (>= n,) slot origins in the plane
    const int32_t* dx;
    int32_t* masks;        // the frame's seg-mask arena (may be null)
    const int32_t* desc;   // the frame's int32 descriptor buffer
    int32_t* plane;
    long long masks_n, desc_n;
    int plane_h, plane_w, plane_rstride;
    int n, bhp, bwp, ch, cv;   // cells of (1 << cv) x (1 << ch) pixels
    int bd, ib, bias, bd_max;
} CompArgs;

__global__ void __launch_bounds__(CP_THREADS)
    comp_kernel(const __grid_constant__ CompArgs a) {
    const int cw = a.bwp >> a.ch, cells = (a.bhp >> a.cv) * cw;
    const long long i = (long long)blockIdx.x * CP_THREADS + threadIdx.x;
    if (i >= (long long)a.n * cells) return;
    const int s = (int)(i / cells), c = (int)(i - (long long)s * cells);
    const int cy = c / cw, cx = c - cy * cw;
    const int kind = a.tab[s * CJ_COLS], par = a.tab[s * CJ_COLS + 1];
    const long long moff = a.tab[s * CJ_COLS + 2];
    const int32_t* msrc = kind == CJ_SEGC ? a.masks
                          : kind == CJ_WEDGE ? a.desc : nullptr;
    if (msrc) {
        const long long lim = kind == CJ_SEGC ? a.masks_n : a.desc_n;
        if (moff < 0 || moff + (long long)a.bhp * a.bwp > lim) return;
    } else if (kind == CJ_SEGL) {
        if (!a.masks || moff < 0 || moff + cells > a.masks_n) return;
    } else if (kind != CJ_WAVG) {
        return;
    }
    const long long sb = (long long)s * a.bhp * a.bwp;
    const int oy = a.dy[s], ox = a.dx[s];
    const int rnd16 = (8 << a.ib) + a.bias * 16;
    const int rnd64 = (32 << a.ib) + a.bias * 64;
    const int msh = a.bd + a.ib - 4;
    const int mrnd = 1 << (msh - 5);
    int msum = 0;
    for (int py = 0; py < (1 << a.cv); py++) {
        const int y = (cy << a.cv) + py;
        for (int px = 0; px < (1 << a.ch); px++) {
            const int x = (cx << a.ch) + px;
            const long long o = (long long)y * a.bwp + x;
            const int t0 = a.tmp0[sb + o], t1 = a.tmp1[sb + o];
            int v;
            if (kind == CJ_WAVG) {
                v = (t0 * par + t1 * (16 - par) + rnd16) >> (a.ib + 4);
            } else {
                const int p = par == 0 ? t0 : t1, q = par == 0 ? t1 : t0;
                int m;
                if (kind == CJ_SEGL) {
                    m = min(38 + ((abs(p - q) + mrnd) >> msh), 64);
                    msum += m;
                } else {
                    m = msrc[moff + o];
                }
                v = (p * m + q * (64 - m) + rnd64) >> (a.ib + 6);
            }
            v = min(max(v, 0), a.bd_max);
            const int Y = oy + y, X = ox + x;
            if (Y >= 0 && Y < a.plane_h && X >= 0 && X < a.plane_w)
                a.plane[(long long)Y * a.plane_rstride + X] = v;
        }
    }
    if (kind == CJ_SEGL)
        a.masks[moff + c] = !a.ch ? msum
                            : a.cv ? (msum + 2 - par) >> 2
                                   : (msum + 1 - par) >> 1;
}

extern "C" int comp_args_size() { return (int)sizeof(CompArgs); }

// One launch over a's n slots on `stream`. Returns cudaGetLastError().
extern "C" int comp_launch(const CompArgs* a, void* stream) {
    if (a->n <= 0) return 0;
    if (a->ib < 0 || a->ib > 6 || a->ch < 0 || a->ch > 1 || a->cv < 0 ||
        a->cv > 1 || (a->bhp >> a->cv) <= 0 || (a->bwp >> a->ch) <= 0)
        return (int)cudaErrorInvalidValue;
    const long long total =
        (long long)a->n * (a->bhp >> a->cv) * (a->bwp >> a->ch);
    const long long grid = (total + CP_THREADS - 1) / CP_THREADS;
    comp_kernel<<<(unsigned)grid, CP_THREADS, 0, (cudaStream_t)stream>>>(
        *a);
    return (int)cudaGetLastError();
}

extern "C" const char* comp_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
