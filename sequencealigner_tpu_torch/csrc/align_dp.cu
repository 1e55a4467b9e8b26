// Hand-written Hopper (sm_90a) kernels of the all-vs-all aligner's DP.
//
// Replaces the three Pallas TPU kernels, the modes of
// sequencealigner_tpu/ops/pallas_dp.py:_make_kernel:
//   align_tiles  <- pallas_dp.align_outer (outer-product tile mode)
//   align_pairs  <- pallas_dp.align_prebuilt_inline via align_packed
//                   (per-pair mode: the engine's diagonal remainder and the
//                   linear-v1 schedule)
//   align_grid   <- pallas_dp.align_prebuilt (grid mode: per-pair sweep over
//                   a prebuilt int8 score grid, ops/superblock.build_stream)
// All compute NW (linear gap), Gotoh GA and Smith-Waterman (affine) scores,
// bit-exact to the reference recurrences (ops/oracle.py); the plain PyTorch
// versions with the same contracts are in ops/torch_dp.py.
//
// What bounds them on the card: integer max-plus work.  A DP cell is about
// eight int32 add/max operations and one shared-memory substitution lookup,
// with no reuse a tensor core could exploit; device-memory traffic is one
// code byte per row per band, one code word per four columns, and the band
// crossing stream below.  The design keeps the DP out of device memory:
//   - one thread scores one pair; a block is 128 pairs.  In the tile kernel
//     the block is the 128 k-lanes of one (tile, c-row), so the c-row's
//     codes are a warp-wide broadcast and kmatT rows load coalesced;
//   - a band of KB = 32 DP rows (H, and X for the affine algorithms) lives
//     in registers while the thread sweeps the columns left to right; the
//     vertical gap (Y) is a scalar carried down the band;
//   - the band's bottom row (H, and Y for GA/SW) reaches the next band
//     through a scratch stream in device memory laid out [column][lane], so
//     the 128 threads of a block touch 512 consecutive bytes per column; it
//     is updated in place (column c is read just before it is rewritten),
//     so a block needs one row of columns per stream, reused across items;
//   - the substitution matrix lives in shared memory as int32, transposed so
//     one column's lookups index a single 25-entry row, chosen once per
//     column (CodeScore); grid mode instead reads its int8 grid laid out
//     [s][column][row][lane], so a warp's reads of one cell are 32
//     consecutive bytes (GridScore).  The sweep itself (dp_pair) is one
//     piece of code for all three, templated on the score source;
//   - a thread stops at its own pair's lengths, so pad rows, pad columns and
//     dummy descriptor rows cost nothing, and max(a + b, c) maps onto the
//     Hopper DPX instruction __viaddmax_s32.
// Blocks loop over work items (a grid no larger than the scratch the wrapper
// allocated), launch on the caller's stream, allocate nothing and do not
// synchronise.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KB = 32;        // DP rows per register band
constexpr int LANES = 128;    // threads (pairs) per block
constexpr int S_TILE = 128;   // c-rows per tile
constexpr int ALPHA = 25;     // 24 letters + PAD
constexpr int PAD = 24;
constexpr int SCORE_MIN = -(1 << 30);

enum { NW = 0, GA = 1, SW = 2 };

// max(a + b, c) in one DPX instruction.
__device__ __forceinline__ int addmax(int a, int b, int c) {
  return __viaddmax_s32(a, b, c);
}

template <int ALGO>
__device__ __forceinline__ int border(int k, int gap, int opn, int slope) {
  if (ALGO == NW) return k * gap;
  if (ALGO == GA) return k == 0 ? 0 : opn + (k - 1) * slope;
  return 0;
}

// Score sources of dp_pair: band(r0, l2) is called once per band of KB DP
// rows (rows r0+1 .. r0+KB), column(c) once per column c (1-based), and
// at(i) gives the substitution score of band row i in that column.

// From letter codes and the substitution matrix in shared memory (tile and
// per-pair modes): subT[c * ALPHA + k] = sub[k][c].  The band's row letters
// stay in registers; the column's letter picks its subT row once per column.
template <class CCode, class KCode>
struct CodeScore {
  CCode ccode;
  KCode kcode;
  const int* subT;
  int kc[KB];
  const int* srow;

  __device__ __forceinline__ void band(int r0, int l2) {
#pragma unroll
    for (int i = 0; i < KB; ++i) kc[i] = r0 + i < l2 ? kcode(r0 + i) : PAD;
  }
  __device__ __forceinline__ void column(int c) {
    srow = subT + ccode(c - 1) * ALPHA;
  }
  __device__ __forceinline__ int at(int i) const { return srow[kc[i]]; }
};

template <class CCode, class KCode>
__device__ __forceinline__ CodeScore<CCode, KCode> code_score(
    CCode ccode, KCode kcode, const int* subT) {
  return CodeScore<CCode, KCode>{ccode, kcode, subT, {}, nullptr};
}

// From a prebuilt int8 grid (grid mode).  lane points at this pair's byte
// of (column 0, row 0); columns are col_stride bytes apart, rows B.  Rows
// at or beyond the pair's l2 are never read (their score is 0 and reaches
// no result), so the grid's PAD_MARK cells cannot affect a score.
struct GridScore {
  const int8_t* lane;
  size_t col_stride;  // Kpad * B
  int row_stride;     // B
  int r0 = 0, nrows = 0;
  const int8_t* col = nullptr;

  __device__ __forceinline__ void band(int r0_, int l2) {
    r0 = r0_;
    nrows = l2 - r0_;
  }
  __device__ __forceinline__ void column(int c) {
    col = lane + (size_t)(c - 1) * col_stride + (size_t)r0 * row_stride;
  }
  __device__ __forceinline__ int at(int i) const {
    return i < nrows ? (int)__ldg(col + i * row_stride) : 0;
  }
};

// Score of one pair: l1 columns, l2 rows, substitution scores from sc.
// hs / ys: this lane's band crossing streams, element stride LANES.  A pair
// with a zero length scores 0, as in the reference kernels.
template <int ALGO, class Score>
__device__ __forceinline__ int dp_pair(int l1, int l2, Score& sc, int gap, int opn, int ext,
                       int* __restrict__ hs, int* __restrict__ ys) {
  if (l1 <= 0 || l2 <= 0) return 0;
  const int slope = ALGO == NW ? gap : max(opn, ext);
  int best = 0;    // SW: running max over valid cells
  int result = 0;  // NW/GA: H[l2][l1]
  const int nbands = (l2 + KB - 1) / KB;
  for (int band = 0; band < nbands; ++band) {
    const int r0 = band * KB;  // this band holds DP rows r0+1 .. r0+KB
    const bool last = band == nbands - 1;
    int H[KB], X[KB];
    sc.band(r0, l2);
#pragma unroll
    for (int i = 0; i < KB; ++i) {
      H[i] = border<ALGO>(r0 + i + 1, gap, opn, slope);  // column 0
      X[i] = SCORE_MIN;
    }
    int diag_top = border<ALGO>(r0, gap, opn, slope);  // H[r0][c-1]
    for (int c = 1; c <= l1; ++c) {
      int up_h, up_y;  // H[r0][c], Y[r0][c]
      if (band == 0) {
        up_h = border<ALGO>(c, gap, opn, slope);
        up_y = SCORE_MIN;
      } else {
        up_h = hs[(c - 1) * LANES];
        up_y = ys[(c - 1) * LANES];
      }
      sc.column(c);
      int d = diag_top;
      diag_top = up_h;
      int hu = up_h, y = up_y;
#pragma unroll
      for (int i = 0; i < KB; ++i) {
        const int left = H[i];
        const int dm = d + sc.at(i);
        int h;
        if (ALGO == NW) {
          h = addmax(left, gap, addmax(hu, gap, dm));
        } else {
          const int x = addmax(left, opn, X[i] + ext);
          y = addmax(hu, opn, y + ext);
          h = max(dm, max(x, y));
          if (ALGO == SW) {
            h = max(h, 0);
            if (r0 + i < l2) best = max(best, h);
          }
          X[i] = x;
        }
        d = left;
        H[i] = h;
        hu = h;
      }
      if (!last) {
        hs[(c - 1) * LANES] = H[KB - 1];
        if (ALGO != NW) ys[(c - 1) * LANES] = y;
      }
    }
    if (ALGO != SW && last) {
      const int idx = l2 - 1 - r0;
#pragma unroll
      for (int i = 0; i < KB; ++i)
        if (i == idx) result = H[i];
    }
  }
  return ALGO == SW ? best : result;
}

__device__ __forceinline__ void load_subT(const int* __restrict__ sub,
                                          int* subT) {
  for (int i = threadIdx.x; i < ALPHA * ALPHA; i += blockDim.x)
    subT[(i % ALPHA) * ALPHA + i / ALPHA] = sub[i];
  __syncthreads();
}

// Tile mode: item = (tile t, c-row s); lane = k-lane of the tile.
template <int ALGO>
__global__ void __launch_bounds__(LANES)
tiles_kernel(const int* __restrict__ desc, int T,
             const int* __restrict__ cwords, int cw_stride,
             const int8_t* __restrict__ kmatT, int kcols,
             const int* __restrict__ klens, const int* __restrict__ sub,
             const int* __restrict__ gaps, int* __restrict__ out,
             int* __restrict__ scratch, int wmax) {
  __shared__ int subT[ALPHA * ALPHA];
  load_subT(sub, subT);
  const int gap = gaps[0], opn = gaps[1], ext = gaps[2];
  const int lane = threadIdx.x;
  int* hs = scratch + (size_t)blockIdx.x * 2 * wmax * LANES + lane;
  int* ys = hs + (size_t)wmax * LANES;
  const int items = T * S_TILE;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int t = item / S_TILE;
    const int crow = desc[2 * t] + item % S_TILE;
    const int kl = desc[2 * t + 1] * LANES + lane;
    const int* cw = cwords + (size_t)crow * cw_stride;
    auto ccode = [cw](int w) {
      return (__ldg(cw + 1 + (w >> 2)) >> ((w & 3) * 8)) & 0xFF;
    };
    auto kcode = [kmatT, kcols, kl](int k) {
      return (int)kmatT[(size_t)k * kcols + kl];
    };
    auto sc = code_score(ccode, kcode, subT);
    out[(size_t)item * LANES + lane] = dp_pair<ALGO>(
        __ldg(cw), klens[kl], sc, gap, opn, ext, hs, ys);
  }
}

// Per-pair mode: item = 128 consecutive pairs; the kernel gathers each
// pair's code rows from the bucket matrices itself.
template <int ALGO>
__global__ void __launch_bounds__(LANES)
pairs_kernel(const int8_t* __restrict__ mat_c, int wc,
             const int8_t* __restrict__ mat_k, int wk,
             const int* __restrict__ rc, const int* __restrict__ rk,
             const int* __restrict__ lens_c, const int* __restrict__ lens_k,
             int n, const int* __restrict__ sub, const int* __restrict__ gaps,
             int* __restrict__ out, int* __restrict__ scratch, int wmax) {
  __shared__ int subT[ALPHA * ALPHA];
  load_subT(sub, subT);
  const int gap = gaps[0], opn = gaps[1], ext = gaps[2];
  const int lane = threadIdx.x;
  int* hs = scratch + (size_t)blockIdx.x * 2 * wmax * LANES + lane;
  int* ys = hs + (size_t)wmax * LANES;
  const int items = (n + LANES - 1) / LANES;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int p = item * LANES + lane;
    if (p >= n) continue;
    const int8_t* cs = mat_c + (size_t)rc[p] * wc;
    const int8_t* ks = mat_k + (size_t)rk[p] * wk;
    auto ccode = [cs](int w) { return (int)cs[w]; };
    auto kcode = [ks](int k) { return (int)ks[k]; };
    auto sc = code_score(ccode, kcode, subT);
    out[p] = dp_pair<ALGO>(lens_c[rc[p]], lens_k[rk[p]], sc, gap, opn, ext,
                           hs, ys);
  }
}

// Grid mode: item = (superblock row s, 128-lane chunk of its B pairs); lane
// b of row s is pair s*B + b and reads sk[s][c-1][r][b].  Lengths are
// clamped to the grid (l1 <= W, l2 <= Kpad is the caller's contract), so no
// length can send a read outside it.
template <int ALGO>
__global__ void __launch_bounds__(LANES)
grid_kernel(const int8_t* __restrict__ sk, int S, int W, int Kpad, int B,
            const int* __restrict__ l1, const int* __restrict__ l2,
            const int* __restrict__ gaps, int* __restrict__ out,
            int* __restrict__ scratch, int wmax) {
  const int gap = gaps[0], opn = gaps[1], ext = gaps[2];
  const int lane = threadIdx.x;
  int* hs = scratch + (size_t)blockIdx.x * 2 * wmax * LANES + lane;
  int* ys = hs + (size_t)wmax * LANES;
  const int chunks = (B + LANES - 1) / LANES;
  const int items = S * chunks;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int s = item / chunks;
    const int b = item % chunks * LANES + lane;
    if (b >= B) continue;
    const size_t p = (size_t)s * B + b;
    GridScore sc{sk + (size_t)s * W * Kpad * B + b, (size_t)Kpad * B, B};
    out[p] = dp_pair<ALGO>(min(l1[p], W), min(l2[p], Kpad), sc, gap, opn,
                           ext, hs, ys);
  }
}

}  // namespace

extern "C" {

int align_dp_tiles(const int* desc, int T, const int* cwords, int cw_stride,
                   const int8_t* kmatT, int kcols, const int* klens,
                   const int* sub, const int* gaps, int algo, int* out,
                   int* scratch, int wmax, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (algo) {
    case NW:
      tiles_kernel<NW><<<grid, LANES, 0, st>>>(desc, T, cwords, cw_stride,
                                               kmatT, kcols, klens, sub, gaps,
                                               out, scratch, wmax);
      break;
    case GA:
      tiles_kernel<GA><<<grid, LANES, 0, st>>>(desc, T, cwords, cw_stride,
                                               kmatT, kcols, klens, sub, gaps,
                                               out, scratch, wmax);
      break;
    case SW:
      tiles_kernel<SW><<<grid, LANES, 0, st>>>(desc, T, cwords, cw_stride,
                                               kmatT, kcols, klens, sub, gaps,
                                               out, scratch, wmax);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int align_dp_pairs(const int8_t* mat_c, int wc, const int8_t* mat_k, int wk,
                   const int* rc, const int* rk, const int* lens_c,
                   const int* lens_k, int n, const int* sub, const int* gaps,
                   int algo, int* out, int* scratch, int wmax, int grid,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (algo) {
    case NW:
      pairs_kernel<NW><<<grid, LANES, 0, st>>>(mat_c, wc, mat_k, wk, rc, rk,
                                               lens_c, lens_k, n, sub, gaps,
                                               out, scratch, wmax);
      break;
    case GA:
      pairs_kernel<GA><<<grid, LANES, 0, st>>>(mat_c, wc, mat_k, wk, rc, rk,
                                               lens_c, lens_k, n, sub, gaps,
                                               out, scratch, wmax);
      break;
    case SW:
      pairs_kernel<SW><<<grid, LANES, 0, st>>>(mat_c, wc, mat_k, wk, rc, rk,
                                               lens_c, lens_k, n, sub, gaps,
                                               out, scratch, wmax);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int align_dp_grid(const int8_t* sk, int S, int W, int Kpad, int B,
                  const int* l1, const int* l2, const int* gaps, int algo,
                  int* out, int* scratch, int wmax, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (algo) {
    case NW:
      grid_kernel<NW><<<grid, LANES, 0, st>>>(sk, S, W, Kpad, B, l1, l2, gaps,
                                              out, scratch, wmax);
      break;
    case GA:
      grid_kernel<GA><<<grid, LANES, 0, st>>>(sk, S, W, Kpad, B, l1, l2, gaps,
                                              out, scratch, wmax);
      break;
    case SW:
      grid_kernel<SW><<<grid, LANES, 0, st>>>(sk, S, W, Kpad, B, l1, l2, gaps,
                                              out, scratch, wmax);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* align_dp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
