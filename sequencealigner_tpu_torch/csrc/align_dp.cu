// Hand-written Hopper (sm_90a) kernels of the all-vs-all aligner's DP.
//
// Replaces the three Pallas TPU kernels, the modes of
// sequencealigner_tpu/ops/pallas_dp.py:_make_kernel:
//   align_tiles  <- pallas_dp.align_outer (outer-product tile mode)
//   align_pairs  <- pallas_dp.align_prebuilt_inline via align_packed
//                   (per-pair mode: the engine's diagonal remainder and the
//                   linear-v1 schedule)
//   align_grid   <- pallas_dp.align_prebuilt (grid mode: per-pair sweep over
//                   a prebuilt int8 score grid, ops/superblock.build_stream,
//                   staged through shared memory by asynchronous copies)
// All compute NW (linear gap), Gotoh GA and Smith-Waterman (affine) scores,
// bit-exact to the reference recurrences (ops/oracle.py); the plain PyTorch
// versions with the same contracts are in ops/torch_dp.py.
//
// What bounds them on the card: instruction issue and the ALU pipe.  A DP
// cell is integer max-plus work with no reuse a tensor core could exploit:
// the fewest instructions per cell are NW 3 (the diagonal add, two
// add+max), GA 6 (three adds, two add+max, one three-way max) and SW 6.5
// (GA's with the zero floor folded in, and one three-way max of the running
// best per two cells).  The DPX and min/max ones run on the ALU pipe at 64
// a clock per SM, the adds can issue beside them on the FMA pipe, and an SM
// issues 128 a clock (tools/dpx_rate.py measures the rates on the card);
// each lookup of the substitution score is a shared-memory load beside
// them.  Device-memory traffic is one code byte per row per band, one code
// word per four columns and the band crossing stream below.  The design
// keeps the DP out of device memory:
//   - one thread scores one pair; a block is 128 pairs.  In the tile kernel
//     the block is the 128 k-lanes of one (tile, c-row), so the c-row's
//     codes are a warp-wide broadcast and kmatT rows load coalesced.  The
//     per-pair kernel may instead split a pair across a group of G lanes of
//     one warp (below);
//   - a band of KB = 32 DP rows (H, and X for the affine algorithms) lives
//     in registers while the thread sweeps the columns left to right; the
//     vertical gap (Y) is a scalar carried down the band.  One column of a
//     band (dp_column) is the same code in every kernel: h = max(diag, x,
//     y) is one DPX instruction (__vimax3_s32, and __vimax3_s32_relu for
//     SW's zero floor), max(a + b, c) another (__viaddmax_s32);
//   - the band's bottom row (H, and Y for GA/SW) reaches the next band
//     through a scratch stream in device memory, updated in place (a column
//     is read before it is rewritten, by the same thread), so a block needs
//     one row of columns per stream, reused across its items.  It is laid
//     out [column / 4][lane][4], so that one 16-byte load brings a thread
//     four columns and the next group's load is issued a group ahead, off
//     the column's critical path;
//   - the substitution matrix lives in shared memory as int32, transposed so
//     one column's lookups index a single 25-entry row, chosen once per
//     column from the column's letter (CodeScore: in tile mode the block's
//     c-row code word, one per four columns; in per-pair mode the pair's own
//     code bytes); grid mode instead reads its int8 grid, laid out
//     [s][column][row][lane], from a ring of stages in shared memory that
//     a producer warp fills by asynchronous copies (RingScore, grid_kernel);
//   - a thread stops at its own pair's lengths, so pad rows, pad columns and
//     dummy descriptor rows cost nothing.
// All three kernels run one sweep (dp_sweep, sweep_band, band_group),
// parameterised by the score source: columns in groups of four, the last
// band split from the full ones, so that only there SW tests which rows lie
// past l2.  The tile and per-pair kernels' grids are persistent: SMs x
// resident blocks (align_dp_tiles_resident, align_dp_pairs_resident: the
// occupancy query), taking items from a device counter, highest index
// first (a launch's longest c-rows, or its longest pairs: bucket rows are
// in ascending length order), so uneven lengths balance and a launch ends
// with one short tail; the wrapper zeroes the counter on the launch's
// stream.  A tile block takes (tile, c-row) items; a per-pair warp takes 32
// consecutive pairs, one to a lane, or 32 / G, one to a group of G lanes.
// At 167 registers (GA, SW) three tile blocks fit an SM (NW, at 128, four);
// a fourth would need 128 registers, which with __launch_bounds__(128, 4)
// spill and measured slower.
// The per-pair kernel's split form (G = 2..32 lanes a pair, chosen per
// launch by the wrapper where the pairs are too few to fill the card: long
// DNA, the diagonal remainder, a schedule's small tail launches) sweeps a
// pair in stripes of G bands, lane t holding band t, t column groups
// behind lane t-1, from which it takes its band's top row by a warp
// shuffle; only lane 0 reads and lane G-1 writes the crossing stream, one
// row per group (split_sweep, sweep_stripe).
// Grid mode reads a byte per cell where the other modes read a code byte
// per row and column, so it is bound by the bytes of its grid: 2 GiB for
// 32,768 pairs of 256 x 256 (0.64 ms at 3.35 TB/s), where GA's true cells
// need about 0.1 ms of arithmetic.  Its block is 128 consumer threads and one
// producer warp that keeps a ring of stages (a group of four columns of
// one band, 16 KB) in dynamic shared memory filled ahead of the sweep, by
// one 1-D bulk copy a column where a column's rows are contiguous (B =
// 128), else cp.async or byte loads as B's alignment allows; an mbarrier
// per stage says when it is full, another when every consumer has released
// it.  It copies no column past the block's longest l1 and no band past
// its longest l2, and its grid is persistent too (align_dp_grid_resident).
// The tile kernel has a second, 16-bit form (tiles_kernel16) for the combos
// whose every value provably fits int16 (Engine._dp16_ok: (Lc + Lk + KB +
// 1) x max(max|sub|, |gap|, |open|, |extend|) <= 32767; the margin covers
// the last band's pad rows and SCORE_MIN's stand-in, -32768 + |extend|).
// What bounds it is the same pipe, but Hopper's DPX instructions have
// s16x2 forms (__viaddmax_s16x2, __vimax3_s16x2[_relu], and __vadd2 for
// the adds, VIADD.16) that issue at the s32 forms' rate, about 62 a clock
// per SM, and do two cells' work: the GA cell mix runs 26.1 cells a clock
// per SM against the int32 form's 15.1 (tools/dpx_rate.py).  Its design:
//   - pairing: a thread scores k-lanes 2u and 2u+1 of the tile, one in each
//     halfword of every band register; a block's two halves (two warps
//     each) take two c-rows of the tile, so an item is (tile, c-row pair)
//     and the column letter stays warp-uniform.  Bucket rows are in length
//     order, so the two lanes' lengths nearly agree; the thread sweeps to
//     the longer, and each lane's score comes from its own row l2 (NW/GA:
//     captured from the band that holds it) or, for SW, its own rows only
//     (the bands past the shorter length mask the other halfword off the
//     running best);
//   - lookup: a table of row-letter pairs, 25 x 625 packed int16x2 (62.5 KB
//     of dynamic shared memory; three blocks an SM hold 187.5 KB), so one
//     shared-memory load gives both lanes' substitution scores of a row:
//     half a load a cell.  PAD entries are 0, so pad rows stay within the
//     predicate's bound and never reach a score;
//   - the crossing stream carries packed H and Y, half the bytes a cell;
//   - output: the int32 form's layout and dtype, each halfword widened.
// All kernels launch on the caller's stream, allocate nothing and do not
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

// Score sources of the sweep: band(r0, l2) is called once per band of KB
// DP rows (rows r0+1 .. r0+KB), group(g) once per group of four columns
// (4g+1 .. 4g+4), column(j) once per swept column 4g+j+1 of that group, and
// at(i) gives the substitution score of band row i in that column.

// From letter codes and the substitution matrix in shared memory (tile and
// per-pair modes): subT[c * ALPHA + k] = sub[k][c].  The band's row letters
// are byte offsets into a subT row, four to a register; cword(g) gives the
// letters of a group's four columns, a byte each (in tile mode the block's
// c-row code word, in per-pair mode this pair's own code bytes), and
// column(j) sets the shared-window address of the subT row of column j's
// letter.  That address is kept opaque, so that the compiler does not fold
// the row into every lookup's address arithmetic; as built for sm_90a a
// tile-mode lookup is then one LDS [R + UR] and nothing else.
template <class KCode, class CWord>
struct CodeScore {
  KCode kcode;
  CWord cword;
  unsigned subT;  // shared-window address of subT
  unsigned kw[KB / 4];
  unsigned word = 0;
  unsigned srow = 0;

  __device__ __forceinline__ void band(int r0, int l2) {
#pragma unroll
    for (int w = 0; w < KB / 4; ++w) {
      unsigned x = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 4 * w + j;
        const int code = r0 + i < l2 ? kcode(r0 + i) : PAD;
        x |= (unsigned)(code * (int)sizeof(int)) << (8 * j);
      }
      kw[w] = x;
    }
  }
  __device__ __forceinline__ void group(int g) { word = cword(g); }
  __device__ __forceinline__ void column(int j) {
    srow = subT + ((word >> (8 * j)) & 0xFF) * ALPHA * (unsigned)sizeof(int);
    asm("" : "+r"(srow));
  }
  __device__ __forceinline__ int at(int i) const {
    int v;
    asm("ld.shared.b32 %0, [%1];"
        : "=r"(v)
        : "r"(srow + __byte_perm(kw[i >> 2], 0, 0x4440 | (i & 3))));
    return v;
  }
};

template <class KCode, class CWord>
__device__ __forceinline__ CodeScore<KCode, CWord> code_score(
    KCode kcode, CWord cword, const int* subT) {
  return CodeScore<KCode, CWord>{
      kcode, cword, (unsigned)__cvta_generic_to_shared(subT), {}};
}

// mbarrier, bulk-copy and cp.async forms of the grid kernel's ring.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}
// Blocks until the phase of parity `parity` of bar has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n"
      "DONE:\n\t}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, int count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// One 1-D bulk copy (the TMA unit, no descriptor) of `bytes` (a multiple of
// 16; both addresses 16-byte aligned) that completes its bytes on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(N)
               : "memory");
}
// Arrives on bar once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// The grid kernel's ring of stages in shared memory: a stage holds one
// group of four columns of one band, KB rows x LANES lanes of int8 scores,
// [column][row][lane].  Stage q of an item (q = band * groups + group, the
// block's own band and group counts) is stage base + q of the block, in
// ring slot (base + q) % STAGES; full[slot] completes when its copy has
// landed, empty[slot] when its users have released it (the producer
// arrives for the other consumer threads), and tag[slot] names the stage
// the slot holds or is being filled with.  Four stages, 64 KB, leave room
// for two blocks per SM; two stages ran slower, and eight fit one block.
constexpr int STAGES = 4;
constexpr int STAGE_BYTES = 4 * KB * LANES;
// Dynamic shared memory: the 2 x STAGES barriers, then the ring.
constexpr int RING_OFFSET = 2 * STAGES * (int)sizeof(uint64_t);
constexpr int GRID_SMEM = RING_OFFSET + STAGES * STAGE_BYTES;
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  volatile unsigned* tag;  // the stage each slot holds or is filling
  int8_t* data;

  static __device__ __forceinline__ int slot(unsigned idx) {
    return idx % STAGES;
  }
  static __device__ __forceinline__ unsigned parity(unsigned idx) {
    return (idx / STAGES) & 1;
  }
};

// From the ring (grid mode): a thread's consumer side.  A thread takes
// only the stages its own lengths reach (the producer arrives on empty for
// the others): group(g) releases the stage it swept last, then waits for
// stage band * groups + g; band() and finish() release it too.  A wait on
// a slot's full barrier goes by its phase parity, which tells only
// neighbouring phases apart, and a thread may skip stages, so it first
// waits for the slot's tag to name its stage: the producer sets it once
// the slot's stage before has been released by all its users, so the slot
// is then at most one phase behind.  The lanes of a warp meet at a
// __syncwarp at the start of each band of the item (in finish() for the
// bands a lane has not), so that a lane done with a band waits there
// instead of spinning on the next band's stages beside the lanes still
// sweeping.  Each user arrives on a stage's empty barrier once, by itself
// (lanes of a warp release a stage at different sites, so no warp-wide
// arrive could count on them being converged).  Rows at or past the pair's
// l2 do not reach its score, so the grid's PAD_MARK cells and rows not
// loaded cannot affect it.  A lookup is one
// shared-memory byte load; a warp's 32 are consecutive bytes.
struct RingScore {
  Ring ring;
  unsigned base;  // stages of the block's earlier items
  int groups;     // column groups per band of this item
  int lane;
  int bnd = 0, held = -1, synced = 0;
  const int8_t* stage = nullptr;
  const int8_t* col = nullptr;

  __device__ __forceinline__ void drop() {
    if (held < 0) return;
    mbar_arrive(&ring.empty[ring.slot(base + held)]);
    held = -1;
  }
  __device__ __forceinline__ void band(int r0, int) {
    drop();
    bnd = r0 / KB;
    for (; synced <= bnd; ++synced) __syncwarp();
  }
  __device__ __forceinline__ void group(int g) {
    drop();
    held = bnd * groups + g;
    const unsigned idx = base + held;
    const int sl = ring.slot(idx);
    while (ring.tag[sl] != idx) __nanosleep(20);
    mbar_wait(&ring.full[sl], ring.parity(idx));
    stage = ring.data + sl * STAGE_BYTES + lane;
  }
  __device__ __forceinline__ void column(int j) {
    col = stage + j * KB * LANES;
  }
  __device__ __forceinline__ int at(int i) const { return col[i * LANES]; }
  __device__ __forceinline__ void finish(int bands) {
    drop();
    for (; synced < bands; ++synced) __syncwarp();
  }
};

// One DP column of a band: rows r0+1 .. r0+KB of column c.  On entry H and
// X hold column c-1, d = H[r0][c-1], hu = H[r0][c] and y = Y[r0][c]; on exit
// H and X hold column c and y = Y[r0+KB][c].  SW keeps the running maximum
// in best; with TAIL, rows at or past nrows = l2 - r0 may lie in the band
// and do not count.  h = max(diag, x, y) is one DPX instruction (with SW's
// zero floor folded in).
template <int ALGO, bool TAIL, class Score>
__device__ __forceinline__ void dp_column(int (&H)[KB], int (&X)[KB], int d,
                                          int hu, int& y, const Score& sc,
                                          int gap, int opn, int ext,
                                          int& best, int nrows) {
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
      if (ALGO == SW) {
        h = __vimax3_s32_relu(dm, x, y);
        if (!TAIL || i < nrows) best = max(best, h);
      } else {
        h = __vimax3_s32(dm, x, y);
      }
      X[i] = x;
    }
    d = left;
    H[i] = h;
    hu = h;
  }
}

template <int ALGO>
__device__ __forceinline__ void band_start(int r0, int gap, int opn,
                                           int slope, int (&H)[KB],
                                           int (&X)[KB]) {
#pragma unroll
  for (int i = 0; i < KB; ++i) {
    H[i] = border<ALGO>(r0 + i + 1, gap, opn, slope);  // column 0
    X[i] = SCORE_MIN;
  }
}

// H[l2][l1] from the last band's column l1 (NW/GA).
__device__ __forceinline__ int band_row(const int (&H)[KB], int idx) {
  int r = 0;
#pragma unroll
  for (int i = 0; i < KB; ++i)
    if (i == idx) r = H[i];
  return r;
}

// One group of four columns (4g+1 .. 4g+4) of a band, after sc.group(g):
// DP rows r0+1 .. r0+KB.  On entry hv, yv hold H and Y of row r0 in these
// columns (unread in the top band, whose row r0 is the border) and diag_top
// = H[r0][4g]; on exit they hold the band's bottom row in them and diag_top
// = H[r0][4g+4].
// Column j takes its row-r0 values from .x and leaves the bottom in .w, so
// after four steps hv, yv are in order.
template <int ALGO, bool TAIL, class Score>
__device__ __forceinline__ void band_group(int g, int l1, bool top,
                                           Score& sc, int gap, int opn,
                                           int ext, int slope, int (&H)[KB],
                                           int (&X)[KB], int& diag_top,
                                           int& best, int nrows, int4& hv,
                                           int4& yv) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = 4 * g + j + 1;
    int bottom = 0, y = SCORE_MIN;
    if (c <= l1) {  // in tile mode l1 is the block's: a uniform branch
      const int up_h = top ? border<ALGO>(c, gap, opn, slope) : hv.x;
      if (!top) y = yv.x;  // Y[r0][c]
      sc.column(j);
      dp_column<ALGO, TAIL>(H, X, diag_top, up_h, y, sc, gap, opn, ext,
                            best, nrows);
      diag_top = up_h;
      bottom = H[KB - 1];
    }
    hv = make_int4(hv.y, hv.z, hv.w, bottom);
    yv = make_int4(yv.y, yv.z, yv.w, y);
  }
}

// One band of the sweep (see dp_sweep): DP rows r0+1 .. r0+KB, columns
// 1 .. l1 in groups of four.  hs / ys: this lane's crossing streams as int4
// groups of four columns, element stride LANES; the next group is loaded
// while this one is swept, and a group is rewritten only after it was read.
// top: the first band (its row r0 is the border); last: no band follows, so
// nothing is written.
template <int ALGO, bool TAIL, class Score>
__device__ __forceinline__ void sweep_band(int l1, int r0, int nrows,
                                           bool top, bool last, Score& sc,
                                           int gap, int opn, int ext,
                                           int slope, int (&H)[KB],
                                           int& best,
                                           int4* __restrict__ hs,
                                           int4* __restrict__ ys) {
  int X[KB];
  band_start<ALGO>(r0, gap, opn, slope, H, X);
  int diag_top = border<ALGO>(r0, gap, opn, slope);  // H[r0][c-1]
  int4 hn = make_int4(0, 0, 0, 0), yn = hn;  // H, Y of row r0, next group
  if (!top) {
    hn = hs[0];
    if (ALGO != NW) yn = ys[0];
  }
  for (int g = 0; 4 * g < l1; ++g) {
    sc.group(g);
    int4 hv = hn, yv = yn;
    if (!top && 4 * (g + 1) < l1) {
      hn = hs[(g + 1) * LANES];
      if (ALGO != NW) yn = ys[(g + 1) * LANES];
    }
    band_group<ALGO, TAIL>(g, l1, top, sc, gap, opn, ext, slope, H, X,
                           diag_top, best, nrows, hv, yv);
    if (!last) {
      hs[g * LANES] = hv;
      if (ALGO != NW) ys[g * LANES] = yv;
    }
  }
}

// Score of one pair: l1 columns, l2 rows, substitution scores from sc; the
// one sweep of every kernel.  A pair with a zero length scores 0, as in the
// reference kernels.  The last band is split from the full ones, so that
// only there SW tests which rows lie past l2.
template <int ALGO, class Score>
__device__ __forceinline__ int dp_sweep(int l1, int l2, Score& sc, int gap,
                                        int opn, int ext,
                                        int4* __restrict__ hs,
                                        int4* __restrict__ ys) {
  if (l1 <= 0 || l2 <= 0) return 0;
  const int slope = ALGO == NW ? gap : max(opn, ext);
  int best = 0;
  int H[KB];
  const int nbands = (l2 + KB - 1) / KB;
  for (int band = 0; band < nbands; ++band) {
    const int r0 = band * KB;
    const bool last = band == nbands - 1;
    sc.band(r0, l2);
    if (ALGO == SW && last)
      sweep_band<ALGO, true>(l1, r0, l2 - r0, band == 0, true, sc, gap, opn,
                             ext, slope, H, best, hs, ys);
    else
      sweep_band<ALGO, false>(l1, r0, l2 - r0, band == 0, last, sc, gap, opn,
                              ext, slope, H, best, hs, ys);
  }
  return ALGO == SW ? best : band_row(H, l2 - 1 - (nbands - 1) * KB);
}

__device__ __forceinline__ void load_subT(const int* __restrict__ sub,
                                          int* subT) {
  for (int i = threadIdx.x; i < ALPHA * ALPHA; i += blockDim.x)
    subT[(i % ALPHA) * ALPHA + i / ALPHA] = sub[i];
  __syncthreads();
}

// This block's and lane's band-crossing stream of H (Y follows it): laid
// out [column / 4][lane][4] (wmax % 4 == 0), so that a warp's 16-byte loads
// of one group of columns are 512 contiguous bytes.
__device__ __forceinline__ int4* crossing(int* scratch, int wmax) {
  return reinterpret_cast<int4*>(scratch +
                                 (size_t)blockIdx.x * 2 * wmax * LANES) +
         threadIdx.x;
}

// Tile mode: item = (tile t, c-row s); lane = k-lane of the tile.
template <int ALGO>
__global__ void __launch_bounds__(LANES)
tiles_kernel(const int* __restrict__ desc, int T,
             const int* __restrict__ cwords, int cw_stride,
             const int8_t* __restrict__ kmatT, int kcols,
             const int* __restrict__ klens, const int* __restrict__ sub,
             const int* __restrict__ gaps, int* __restrict__ out,
             int* __restrict__ scratch, int wmax, int* __restrict__ next) {
  __shared__ int subT[ALPHA * ALPHA];
  __shared__ int claimed[2];
  load_subT(sub, subT);
  const int gap = gaps[0], opn = gaps[1], ext = gaps[2];
  const int lane = threadIdx.x;
  int4* hs = crossing(scratch, wmax);
  int4* ys = hs + (size_t)(wmax / 4) * LANES;
  const int items = T * S_TILE;
  // Items go longest first: the last tiles and rows of a combo have the
  // longest c-rows.  Two slots for the claimed index, so that one barrier
  // per item suffices: a slot is rewritten only after every thread has
  // passed the barrier that follows its read.
  for (int k = 0;; k ^= 1) {
    if (lane == 0) claimed[k] = atomicAdd(next, 1);
    __syncthreads();
    const int item = items - 1 - claimed[k];
    if (item < 0) break;
    const int t = item / S_TILE;
    const int crow = desc[2 * t] + item % S_TILE;
    const int kl = desc[2 * t + 1] * LANES + lane;
    const int* cw = cwords + (size_t)crow * cw_stride;
    auto kcode = [kmatT, kcols, kl](int k) {
      return (int)kmatT[(size_t)k * kcols + kl];
    };
    auto cword = [cw](int g) { return (unsigned)__ldg(cw + 1 + g); };
    auto sc = code_score(kcode, cword, subT);
    out[(size_t)item * LANES + lane] = dp_sweep<ALGO>(
        __ldg(cw), klens[kl], sc, gap, opn, ext, hs, ys);
  }
}

// Split per-pair mode: a pair is swept by a group of G lanes of one warp (G
// a power of two, 2..32), in stripes of G bands.  Lane t of the group holds
// band t of the stripe, DP rows r0+1 .. r0+KB, and sweeps its column groups
// t steps behind lane t-1: at step q it sweeps group q - t, whose row r0
// (H, and Y for GA/SW) lane t-1 left in its int4 bottoms at step q-1, and
// takes them with one shuffle each (width G, the group's own mask: the
// groups of a warp hold different pairs and need not step together).  The
// diagonal H[r0][4g] is the last column of the group before, already held.
// Lane 0 takes row r0 from the crossing stream instead (group g+1 loaded at
// step g) and lane G-1 writes its bottoms there for the next stripe; lane
// G-1 rewrites group g at step g + G - 1, after lane 0's read of it reached
// it through the shuffles.  Every lane of the group runs every step and
// every shuffle.  hs / ys: the group's stream, element stride `stride`.
template <int ALGO, bool TAIL, class Score>
__device__ __forceinline__ void sweep_stripe(
    int l1, int r0, int nrows, int t, int G, unsigned gmask, int steps,
    bool top, bool last, Score& sc, int gap, int opn, int ext, int slope,
    int (&H)[KB], int& best, int4* __restrict__ hs, int4* __restrict__ ys,
    int stride) {
  int X[KB];
  band_start<ALGO>(r0, gap, opn, slope, H, X);
  int diag_top = border<ALGO>(r0, gap, opn, slope);  // H[r0][c-1]
  const bool reads = !top && t == 0, writes = !last && t == G - 1;
  const bool active = nrows > 0;
  int4 hn = make_int4(0, 0, 0, 0), yn = hn;  // lane 0: next group's row r0
  int4 hv = hn, yv = hn;  // this lane's bottoms of its last swept group
  if (reads) {
    hn = hs[0];
    if (ALGO != NW) yn = ys[0];
  }
  for (int q = 0; q < steps; ++q) {
    // Every lane runs the same code each step, without branches around the
    // sweep: a lane with no group to sweep (before its first, after its last,
    // or with no rows) sweeps no column of a clamped one.  Branches there
    // cost the split form 40-80 registers (a resident block) as built for
    // sm_90a.
    const int g = q - t;
    const bool on = active && g >= 0 && 4 * g < l1;
    const int gc = min(max(g, 0), (l1 - 1) / 4);
    sc.group(gc);
    hv.x = __shfl_up_sync(gmask, hv.x, 1, G);
    hv.y = __shfl_up_sync(gmask, hv.y, 1, G);
    hv.z = __shfl_up_sync(gmask, hv.z, 1, G);
    hv.w = __shfl_up_sync(gmask, hv.w, 1, G);
    if (ALGO != NW) {
      yv.x = __shfl_up_sync(gmask, yv.x, 1, G);
      yv.y = __shfl_up_sync(gmask, yv.y, 1, G);
      yv.z = __shfl_up_sync(gmask, yv.z, 1, G);
      yv.w = __shfl_up_sync(gmask, yv.w, 1, G);
    }
    if (t == 0) hv = hn;
    if (t == 0) yv = yn;
    if (reads && 4 * (g + 1) < l1) hn = hs[(g + 1) * stride];
    if (ALGO != NW && reads && 4 * (g + 1) < l1) yn = ys[(g + 1) * stride];
    band_group<ALGO, TAIL>(gc, on ? l1 : 0, top && t == 0, sc, gap, opn,
                           ext, slope, H, X, diag_top, best, nrows, hv, yv);
    if (writes && on) hs[g * stride] = hv;
    if (ALGO != NW && writes && on) ys[g * stride] = yv;
  }
}

// Score of one pair in split mode (see sweep_stripe), called by all G lanes
// of its group with the same pair.  Returns, in lane (l2 - 1) % (G * KB) /
// KB for NW/GA, H[l2][l1] (the lane whose band holds row l2 in the last
// stripe), and in every lane for SW the best over the group's lanes and
// stripes; the other lanes' values are not the score.  A pair with a zero
// length scores 0.  Only the last stripe's SW lanes test which rows lie past
// l2.
template <int ALGO, class Score>
__device__ __forceinline__ int split_sweep(int l1, int l2, int t, int G,
                                           unsigned gmask, Score& sc,
                                           int gap, int opn, int ext,
                                           int4* __restrict__ hs,
                                           int4* __restrict__ ys,
                                           int stride) {
  if (l1 <= 0 || l2 <= 0) return 0;
  const int slope = ALGO == NW ? gap : max(opn, ext);
  int best = 0;
  int H[KB];
  const int rows = G * KB;
  const int nstripes = (l2 + rows - 1) / rows;
  const int ngroups = (l1 + 3) / 4;
  for (int s = 0; s < nstripes; ++s) {
    const int r0 = s * rows + t * KB;
    const bool last = s == nstripes - 1;
    // The stripe's last lane with rows; the group steps until it is done.
    const int tlast = last ? (l2 - 1 - s * rows) / KB : G - 1;
    const int steps = ngroups + tlast;
    const int nrows = t <= tlast ? l2 - r0 : 0;
    if (nrows > 0) sc.band(r0, l2);
    if (ALGO == SW && last)
      sweep_stripe<ALGO, true>(l1, r0, nrows, t, G, gmask, steps, s == 0,
                               true, sc, gap, opn, ext, slope, H, best, hs,
                               ys, stride);
    else
      sweep_stripe<ALGO, false>(l1, r0, nrows, t, G, gmask, steps, s == 0,
                                last, sc, gap, opn, ext, slope, H, best, hs,
                                ys, stride);
    // Lane G-1's stream writes reach lane 0's reads of the next stripe.
    __syncwarp(gmask);
  }
  if (ALGO == SW) {
    for (int o = 1; o < G; o <<= 1)
      best = max(best, __shfl_xor_sync(gmask, best, o, G));
    return best;
  }
  return band_row(H, (l2 - 1) % KB);
}

// Per-pair mode.  The grid is persistent (SMs x resident blocks); each
// warp takes items of consecutive pairs from the device counter `next`,
// highest index first (a launch's higher pair ids are its longer pairs), 32
// pairs to an item with one lane a pair (SPLIT false, dp_sweep) or 32 / G
// with a group of G lanes a pair (SPLIT true, split_sweep).  A warp claims
// with one atomic and a shuffle, so no block barrier is needed per item.
// Each group (a lane when G = 1) owns stream slot threadIdx.x / G of its
// block's scratch, laid out [column / 4][slot][4] (LANES / G slots).  The
// kernel gathers each pair's code rows from the bucket matrices itself.
// Launch bounds: three blocks per SM hold the one-lane form without a
// spill (NW 167, GA 165, SW 168 registers; with no minimum ptxas puts NW at
// 128 registers with an 8-byte spill); the split form takes what it needs
// (NW 167 registers, three blocks; GA 199 and SW 189, two blocks: bounded
// to three, they spill).
template <int ALGO, bool SPLIT>
__global__ void __launch_bounds__(LANES, SPLIT ? 1 : 3)
pairs_kernel(const int8_t* __restrict__ mat_c, int wc,
             const int8_t* __restrict__ mat_k, int wk,
             const int* __restrict__ rc, const int* __restrict__ rk,
             const int* __restrict__ lens_c, const int* __restrict__ lens_k,
             int n, const int* __restrict__ sub, const int* __restrict__ gaps,
             int* __restrict__ out, int* __restrict__ scratch, int wmax,
             int G, int* __restrict__ next) {
  __shared__ int subT[ALPHA * ALPHA];
  load_subT(sub, subT);
  const int gap = gaps[0], opn = gaps[1], ext = gaps[2];
  if (!SPLIT) G = 1;
  const int wl = threadIdx.x & 31;  // lane in the warp
  const int t = wl & (G - 1);       // lane in the group
  const int per_item = 32 / G;      // pairs per warp item
  const int stride = LANES / G;     // stream slots per block
  const unsigned gmask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1) << (wl & ~(G - 1));
  int4* hs = reinterpret_cast<int4*>(scratch +
                                     (size_t)blockIdx.x * 2 * wmax * stride) +
             threadIdx.x / G;
  int4* ys = hs + (size_t)(wmax / 4) * stride;
  const int items = (n + per_item - 1) / per_item;
  for (;;) {
    int claimed = 0;
    if (wl == 0) claimed = atomicAdd(next, 1);
    const int item = items - 1 - __shfl_sync(0xffffffffu, claimed, 0);
    if (item < 0) break;
    const int p = item * per_item + wl / G;
    if (p >= n) continue;
    const int8_t* cs = mat_c + (size_t)rc[p] * wc;
    const int8_t* ks = mat_k + (size_t)rk[p] * wk;
    const int l1 = lens_c[rc[p]], l2 = lens_k[rk[p]];
    auto kcode = [ks](int k) { return (int)ks[k]; };
    // This pair's four column letters of group g, a byte load each (none
    // past l1, so no read leaves the row).  One 32-bit load of the four,
    // where rows are 4-byte aligned, measured 13% slower on the main set's
    // linear-v1 launches and 9% on its diagonal remainder (PERF.md §6).
    auto cword = [cs, l1](int g) {
      unsigned w = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * g + j < l1) w |= (unsigned)(uint8_t)cs[4 * g + j] << (8 * j);
      return w;
    };
    auto sc = code_score(kcode, cword, subT);
    if (!SPLIT) {
      out[p] = dp_sweep<ALGO>(l1, l2, sc, gap, opn, ext, hs, ys);
    } else {
      const int v = split_sweep<ALGO>(l1, l2, t, G, gmask, sc, gap, opn, ext,
                                      hs, ys, stride);
      const int owner = ALGO == SW || l1 <= 0 || l2 <= 0
                            ? 0
                            : (l2 - 1) % (G * KB) / KB;
      if (t == owner) out[p] = v;
    }
  }
}

// How the grid kernel's producer warp copies a stage (chosen by the wrapper
// from B and the grid's base alignment, cuda_dp.grid_form): a piece is the
// chunk's part of one row of one column, min(LANES, B - b0) bytes.
enum {
  FORM_BULK = 0,   // B == LANES: a column's rows are one contiguous run,
                   // one bulk copy per column
  FORM_ASYNC = 1,  // B % 4 == 0: cp.async of `unit` (16, 8 or 4) bytes,
                   // the widest that B and the base allow
  FORM_BYTES = 2,  // otherwise: plain byte loads and shared stores
};

// Stage q of an item, filled by the 32 lanes of the producer warp into
// dst: columns 4g .. 4g+3 (none at or past L1) of band b, rows r0 ..
// min(r0 + KB, Kpad) - 1.  item points at sk[s][0][0][b0].
__device__ __forceinline__ void fill_stage(int form, int unit,
                                           const int8_t* item, int Kpad,
                                           int B, int width, int q,
                                           int groups, int L1, int8_t* dst,
                                           uint64_t* full, int wl) {
  const int r0 = q / groups * KB, c0 = q % groups * 4;
  const int rows = min(KB, Kpad - r0), ncols = min(4, L1 - c0);
  const int pieces = ncols * rows;
  auto src = [&](int j, int r) {
    return item + ((size_t)(c0 + j) * Kpad + r0 + r) * B;
  };
  auto to = [&](int j, int r) { return dst + (j * KB + r) * LANES; };
  if (form == FORM_BULK) {
    if (wl == 0) {
      mbar_expect_tx(full, pieces * LANES);
      for (int j = 0; j < ncols; ++j)
        bulk_copy(to(j, 0), src(j, 0), rows * LANES, full);
    }
  } else if (form == FORM_ASYNC) {
    // The warp's lanes take the stage's copies in turn, piece by piece.
    const int per = width / unit;
    for (int t = wl; t < pieces * per; t += 32) {
      const int pc = t / per, o = t % per * unit;
      const int8_t* s = src(pc / rows, pc % rows) + o;
      int8_t* d = to(pc / rows, pc % rows) + o;
      if (unit == 16)
        cp_async<16>(d, s);
      else if (unit == 8)
        cp_async<8>(d, s);
      else
        cp_async<4>(d, s);
    }
    cp_async_arrive(full);
  } else {
    for (int t = 0; t < pieces; ++t) {
      const int8_t* s = src(t / rows, t % rows);
      int8_t* d = to(t / rows, t % rows);
      for (int o = wl; o < width; o += 32) d[o] = __ldg(s + o);
    }
    mbar_arrive(full);
  }
}

// Grid mode: item = (superblock row s, 128-lane chunk b0 of its B pairs);
// consumer thread b (threads 0..LANES-1) scores pair s*B + b0 + b, whose
// scores of column c-1, row r are sk[s][c-1][r][b0 + b].  The block's last
// warp is the producer: it walks the item's stages, as far as the block's
// longest l1 and l2 reach, STAGES ahead of the consumers; once a
// slot's stage before has been released, it tags the slot, copies the
// stage if some consumer's lengths reach it, and arrives on empty for the
// consumers they do not.  Lengths are clamped to the grid (l1 <= W, l2 <=
// Kpad is the caller's contract), so no copy leaves it.  The grid is
// persistent (SMs x resident blocks: two of 160 threads an SM for GA and
// SW, three for NW); a block takes items from the device counter `next`.
template <int ALGO>
__global__ void __launch_bounds__(LANES + 32, 2)
grid_kernel(const int8_t* __restrict__ sk, int S, int W, int Kpad, int B,
            const int* __restrict__ l1, const int* __restrict__ l2,
            const int* __restrict__ gaps, int* __restrict__ out,
            int* __restrict__ scratch, int wmax, int form, int unit,
            int* __restrict__ next) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int claimed[2], longest[2][2];
  // Bands and column groups each consumer's lengths reach, per item slot.
  __shared__ int reach_b[2][LANES], reach_g[2][LANES];
  __shared__ unsigned tags[STAGES];
  Ring ring{reinterpret_cast<uint64_t*>(smem),
            reinterpret_cast<uint64_t*>(smem) + STAGES, tags,
            reinterpret_cast<int8_t*>(smem + RING_OFFSET)};
  const int tid = threadIdx.x, wl = tid & 31;
  const bool producer = tid >= LANES;
  if (tid == 0) {
    for (int k = 0; k < STAGES; ++k) {
      mbar_init(&ring.full[k], form >= FORM_ASYNC ? 32 : 1);
      mbar_init(&ring.empty[k], LANES);
      tags[k] = ~0u;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const int gap = gaps[0], opn = gaps[1], ext = gaps[2];
  int4* hs = crossing(scratch, wmax);
  int4* ys = hs + (size_t)(wmax / 4) * LANES;
  const int chunks = (B + LANES - 1) / LANES;
  const int items = S * chunks;
  unsigned base = 0;
  // Two slots for the claimed item and its longest lengths: a slot is
  // rewritten only after every thread has passed the barriers that follow
  // its reads.
  for (int k = 0;; k ^= 1) {
    if (tid == 0) {
      claimed[k] = atomicAdd(next, 1);
      longest[k][0] = longest[k][1] = 0;
    }
    __syncthreads();
    const int item = items - 1 - claimed[k];
    if (item < 0) break;
    const int s = item / chunks, b0 = item % chunks * LANES;
    const size_t p = (size_t)s * B + b0 + tid;
    int a1 = 0, a2 = 0;
    if (!producer && b0 + tid < B) {
      a1 = max(0, min(l1[p], W));
      a2 = max(0, min(l2[p], Kpad));
    }
    int m1 = a1 > 0 && a2 > 0 ? a1 : 0, m2 = m1 ? a2 : 0;
    if (!producer) {
      reach_b[k][tid] = m1 ? (a2 + KB - 1) / KB : 0;
      reach_g[k][tid] = m1 ? (a1 + 3) / 4 : 0;
    }
    for (int o = 16; o; o >>= 1) {
      m1 = max(m1, __shfl_xor_sync(0xffffffffu, m1, o));
      m2 = max(m2, __shfl_xor_sync(0xffffffffu, m2, o));
    }
    if (wl == 0 && m1) {
      atomicMax(&longest[k][0], m1);
      atomicMax(&longest[k][1], m2);
    }
    __syncthreads();
    const int L1 = longest[k][0], L2 = longest[k][1];
    const int groups = (L1 + 3) / 4;
    const int Q = groups * ((L2 + KB - 1) / KB);
    if (producer) {
      const int8_t* src = sk + (size_t)s * W * Kpad * B + b0;
      const int width = min(LANES, B - b0);
      int rb[LANES / 32], rg[LANES / 32];
      for (int m = 0; m < LANES / 32; ++m) {
        rb[m] = reach_b[k][wl + 32 * m];
        rg[m] = reach_g[k][wl + 32 * m];
      }
      for (int q = 0; q < Q; ++q) {
        const unsigned idx = base + q;
        const int sl = ring.slot(idx);
        if (idx >= (unsigned)STAGES)
          mbar_wait(&ring.empty[sl], ring.parity(idx) ^ 1);
        if (wl == 0) ring.tag[sl] = idx;
        // The consumers whose lengths reach this stage: the warp arrives on
        // empty for the others, and where none does, marks the stage full
        // with nothing copied.
        int c = 0;
        for (int m = 0; m < LANES / 32; ++m)
          c += rb[m] > q / groups && rg[m] > q % groups;
        const int users = __reduce_add_sync(0xffffffffu, c);
        if (users)
          fill_stage(form, unit, src, Kpad, B, width, q, groups, L1,
                     ring.data + sl * STAGE_BYTES, &ring.full[sl], wl);
        else if (form >= FORM_ASYNC || wl == 0)
          mbar_arrive(&ring.full[sl]);
        if (wl == 0 && users < LANES)
          mbar_arrive(&ring.empty[sl], LANES - users);
      }
    } else {
      RingScore sc{ring, base, groups, tid};
      const int v = dp_sweep<ALGO>(a1, a2, sc, gap, opn, ext, hs, ys);
      sc.finish((L2 + KB - 1) / KB);
      if (b0 + tid < B) out[p] = v;
    }
    base += Q;
  }
}

// ---------------------------------------------------------------------------
// The tile kernel's 16-bit form (tiles_kernel16): two k-lanes a thread, one
// in each halfword of every band register, so that each DPX instruction
// does two cells' work (the s16x2 forms of the int32 sweep's instructions,
// in the same order).  Halfwords never carry into each other: every add
// and add-max wraps within its halfword, and the engine runs this form only
// where no value it forms leaves int16 (Engine._dp16_ok), so none wraps.

// v in both halfwords.
__device__ __forceinline__ unsigned splat2(int v) {
  return (unsigned)(v & 0xffff) * 0x10001u;
}

// From the block's table of row-letter pairs (tile mode, 16-bit form):
// tab[c * ALPHA * ALPHA + ka * ALPHA + kb] holds sub[ka][c] in its low
// halfword and sub[kb][c] in its high one, 0 where ka, kb or c is PAD (rows
// past a lane's length never reach its score).  A band row's offset into a
// table row, (ka * ALPHA + kb) * 4 bytes, takes a halfword, two to a
// register; column(j) sets the table row of column j's letter; at(i) is
// one shared-memory load for both lanes' cells of row i.
struct PairScore {
  const uint16_t* kpair;  // kmatT at this thread's two lanes
  int kcols;
  const int* cw;          // the block half's c-row
  unsigned tab;           // shared-window address of the table
  unsigned kw[KB / 2];
  unsigned word = 0;
  unsigned srow = 0;

  __device__ __forceinline__ void band(int r0, int l2a, int l2b) {
#pragma unroll
    for (int w = 0; w < KB / 2; ++w) {
      unsigned x = 0;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = r0 + 2 * w + j;
        const unsigned codes =
            r < max(l2a, l2b) ? __ldg(kpair + (size_t)r * (kcols / 2)) : 0;
        const int ka = r < l2a ? (int)(codes & 0xff) : PAD;
        const int kb = r < l2b ? (int)(codes >> 8) : PAD;
        x |= (unsigned)((ka * ALPHA + kb) * (int)sizeof(unsigned)) << (16 * j);
      }
      kw[w] = x;
    }
  }
  __device__ __forceinline__ void group(int g) {
    word = (unsigned)__ldg(cw + 1 + g);
  }
  __device__ __forceinline__ void column(int j) {
    srow = tab + ((word >> (8 * j)) & 0xFF) * ALPHA * ALPHA *
                     (unsigned)sizeof(unsigned);
    asm("" : "+r"(srow));
  }
  __device__ __forceinline__ unsigned at(int i) const {
    unsigned v;
    asm("ld.shared.b32 %0, [%1];"
        : "=r"(v)
        : "r"(srow + __byte_perm(kw[i >> 1], 0, i & 1 ? 0x4432 : 0x4410)));
    return v;
  }
};

// Rows of a band that count for each halfword, as a mask of its row: SW's
// last bands hold rows past one lane's length, or both.
__device__ __forceinline__ unsigned keep2(int i, int na, int nb) {
  return (i < na ? 0xffffu : 0u) | (i < nb ? 0xffff0000u : 0u);
}

// dp_column in 16x2: the same recurrences, instruction for instruction, on
// two lanes' cells.  With TAIL (SW), row i counts for lane a only below na
// rows and for lane b below nb; SW takes the running best per two rows.
template <int ALGO, bool TAIL>
__device__ __forceinline__ void dp_column16(
    unsigned (&H)[KB], unsigned (&X)[KB], unsigned d, unsigned hu,
    unsigned& y, const PairScore& sc, unsigned gap, unsigned opn,
    unsigned ext, unsigned& best, int na, int nb) {
  unsigned prev = 0;
#pragma unroll
  for (int i = 0; i < KB; ++i) {
    const unsigned left = H[i];
    const unsigned dm = __vadd2(d, sc.at(i));
    unsigned h;
    if (ALGO == NW) {
      h = __viaddmax_s16x2(left, gap, __viaddmax_s16x2(hu, gap, dm));
    } else {
      const unsigned x = __viaddmax_s16x2(left, opn, __vadd2(X[i], ext));
      y = __viaddmax_s16x2(hu, opn, __vadd2(y, ext));
      if (ALGO == SW) {
        h = __vimax3_s16x2_relu(dm, x, y);
        const unsigned c = TAIL ? h & keep2(i, na, nb) : h;  // h >= 0
        if (i & 1)
          best = __vimax3_s16x2(best, prev, c);
        else
          prev = c;
      } else {
        h = __vimax3_s16x2(dm, x, y);
      }
      X[i] = x;
    }
    d = left;
    H[i] = h;
    hu = h;
  }
}

// band_group and sweep_band in 16x2 (see them): the streams hold packed
// pairs, so a group of four columns is one int4 of H and one of Y.
template <int ALGO, bool TAIL>
__device__ __forceinline__ void sweep_band16(
    int l1, int r0, int na, int nb, bool top, bool last, PairScore& sc,
    int gap_s, int opn_s, int slope, unsigned gap, unsigned opn,
    unsigned ext, unsigned sent, unsigned (&H)[KB], unsigned& best,
    uint4* __restrict__ hs, uint4* __restrict__ ys) {
  unsigned X[KB];
#pragma unroll
  for (int i = 0; i < KB; ++i) {
    H[i] = splat2(border<ALGO>(r0 + i + 1, gap_s, opn_s, slope));
    X[i] = sent;
  }
  unsigned diag_top = splat2(border<ALGO>(r0, gap_s, opn_s, slope));
  uint4 hn = make_uint4(0, 0, 0, 0), yn = hn;
  if (!top) {
    hn = hs[0];
    if (ALGO != NW) yn = ys[0];
  }
  for (int g = 0; 4 * g < l1; ++g) {
    sc.group(g);
    uint4 hv = hn, yv = yn;
    if (!top && 4 * (g + 1) < l1) {
      hn = hs[(g + 1) * LANES];
      if (ALGO != NW) yn = ys[(g + 1) * LANES];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * g + j + 1;
      unsigned bottom = 0, y = sent;
      if (c <= l1) {  // l1 is the block half's: uniform in a warp
        const unsigned up_h =
            top ? splat2(border<ALGO>(c, gap_s, opn_s, slope)) : hv.x;
        if (!top) y = yv.x;
        sc.column(j);
        dp_column16<ALGO, TAIL>(H, X, diag_top, up_h, y, sc, gap, opn, ext,
                                best, na, nb);
        diag_top = up_h;
        bottom = H[KB - 1];
      }
      hv = make_uint4(hv.y, hv.z, hv.w, bottom);
      yv = make_uint4(yv.y, yv.z, yv.w, y);
    }
    if (!last) {
      hs[g * LANES] = hv;
      if (ALGO != NW) ys[g * LANES] = yv;
    }
  }
}

__device__ __forceinline__ unsigned band_row16(const unsigned (&H)[KB],
                                               int idx) {
  unsigned r = 0;
#pragma unroll
  for (int i = 0; i < KB; ++i)
    if (i == idx) r = H[i];
  return r;
}

// Scores of two pairs that share their columns (l1) and differ in rows (l2a
// in the low halfword, l2b in the high one), packed the same way: the
// thread sweeps to the longer of the two; NW/GA take each lane's H at its
// own row l2 and column l1 (from the band that holds that row), SW the best
// over each lane's own rows.  A pair with a zero length scores 0.
template <int ALGO>
__device__ __forceinline__ unsigned dp_sweep16(int l1, int l2a, int l2b,
                                               PairScore& sc, int gap_s,
                                               int opn_s, int ext_s,
                                               uint4* __restrict__ hs,
                                               uint4* __restrict__ ys) {
  const int l2 = max(l2a, l2b);
  if (l1 <= 0 || l2 <= 0) return 0;
  const int slope = ALGO == NW ? gap_s : max(opn_s, ext_s);
  const unsigned gap = splat2(gap_s), opn = splat2(opn_s),
                 ext = splat2(ext_s);
  // SCORE_MIN's stand-in: one extend above -32768, so that the one
  // extension it takes before a real value replaces it does not wrap.
  const unsigned sent = splat2(-32768 + abs(ext_s));
  unsigned best = 0, res = 0;
  unsigned H[KB];
  const int nbands = (l2 + KB - 1) / KB;
  for (int band = 0; band < nbands; ++band) {
    const int r0 = band * KB;
    const bool last = band == nbands - 1;
    const int na = l2a - r0, nb = l2b - r0;  // rows of this band that count
    sc.band(r0, l2a, l2b);
    if (ALGO == SW && min(na, nb) < KB)
      sweep_band16<ALGO, true>(l1, r0, na, nb, band == 0, last, sc, gap_s,
                               opn_s, slope, gap, opn, ext, sent, H, best,
                               hs, ys);
    else
      sweep_band16<ALGO, false>(l1, r0, na, nb, band == 0, last, sc, gap_s,
                                opn_s, slope, gap, opn, ext, sent, H, best,
                                hs, ys);
    if (ALGO != SW) {
      if (na > 0 && na <= KB)
        res = (res & 0xffff0000u) | (band_row16(H, na - 1) & 0xffffu);
      if (nb > 0 && nb <= KB)
        res = (res & 0xffffu) | (band_row16(H, nb - 1) & 0xffff0000u);
    }
  }
  return ALGO == SW ? best : res;
}

// The table of row-letter pairs (PairScore) from sub (25 x 25, rows the
// k letters), into dynamic shared memory.
constexpr int PAIR_TAB = ALPHA * ALPHA * ALPHA;
constexpr int TILES16_SMEM = PAIR_TAB * (int)sizeof(unsigned);
__device__ __forceinline__ void load_pair_table(const int* __restrict__ sub,
                                                unsigned* tab) {
  for (int i = threadIdx.x; i < PAIR_TAB; i += blockDim.x) {
    const int c = i / (ALPHA * ALPHA), ka = i / ALPHA % ALPHA,
              kb = i % ALPHA;
    const int a = ka == PAD || c == PAD ? 0 : __ldg(sub + ka * ALPHA + c);
    const int b = kb == PAD || c == PAD ? 0 : __ldg(sub + kb * ALPHA + c);
    tab[i] = (unsigned)(a & 0xffff) | (unsigned)b << 16;
  }
  __syncthreads();
}

// Tile mode, 16-bit form: item = (tile t, c-rows 2p and 2p+1); each half
// of the block (64 threads, two warps) takes one of the two c-rows, and
// its thread u the k-lanes 2u and 2u+1 of the tile.  Same persistent grid,
// work counter and longest-first order as tiles_kernel; output, layout and
// int32 dtype as tiles_kernel's.  Each thread keeps one crossing slot of
// the block's scratch (two int32 streams of packed pairs).
template <int ALGO>
__global__ void __launch_bounds__(LANES, 3)
tiles_kernel16(const int* __restrict__ desc, int T,
               const int* __restrict__ cwords, int cw_stride,
               const int8_t* __restrict__ kmatT, int kcols,
               const int* __restrict__ klens, const int* __restrict__ sub,
               const int* __restrict__ gaps, int* __restrict__ out,
               int* __restrict__ scratch, int wmax, int* __restrict__ next) {
  extern __shared__ unsigned tab[];
  __shared__ int claimed[2];
  load_pair_table(sub, tab);
  const int gap = gaps[0], opn = gaps[1], ext = gaps[2];
  const int half = threadIdx.x / (LANES / 2), u = threadIdx.x % (LANES / 2);
  uint4* hs = reinterpret_cast<uint4*>(crossing(scratch, wmax));
  uint4* ys = hs + (size_t)(wmax / 4) * LANES;
  const int items = T * (S_TILE / 2);
  for (int k = 0;; k ^= 1) {
    if (threadIdx.x == 0) claimed[k] = atomicAdd(next, 1);
    __syncthreads();
    const int item = items - 1 - claimed[k];
    if (item < 0) break;
    const int t = item / (S_TILE / 2);
    const int s = item % (S_TILE / 2) * 2 + half;
    const int crow = desc[2 * t] + s;
    const int kl = desc[2 * t + 1] * LANES + 2 * u;
    const int* cw = cwords + (size_t)crow * cw_stride;
    PairScore sc{reinterpret_cast<const uint16_t*>(kmatT + kl), kcols, cw,
                 (unsigned)__cvta_generic_to_shared(tab), {}};
    const unsigned v = dp_sweep16<ALGO>(__ldg(cw), klens[kl], klens[kl + 1],
                                        sc, gap, opn, ext, hs, ys);
    reinterpret_cast<int2*>(out + ((size_t)t * S_TILE + s) * LANES)[u] =
        make_int2((int)(short)(v & 0xffff), (int)(short)(v >> 16));
  }
}

// tiles_kernel16<algo> with its dynamic shared memory limit raised to the
// pair table's (above the default 48 KB), or nullptr.
const void* tiles16_function(int algo, int* err) {
  const void* f = algo == NW   ? (const void*)tiles_kernel16<NW>
                  : algo == GA ? (const void*)tiles_kernel16<GA>
                  : algo == SW ? (const void*)tiles_kernel16<SW>
                               : nullptr;
  *err = (int)cudaErrorInvalidValue;
  if (!f) return nullptr;
  *err = (int)cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize, TILES16_SMEM);
  return *err ? nullptr : f;
}

}  // namespace

extern "C" {

int align_dp_tiles(const int* desc, int T, const int* cwords, int cw_stride,
                   const int8_t* kmatT, int kcols, const int* klens,
                   const int* sub, const int* gaps, int algo, int* out,
                   int* scratch, int wmax, int* next, int grid,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (algo) {
    case NW:
      tiles_kernel<NW><<<grid, LANES, 0, st>>>(desc, T, cwords, cw_stride,
                                               kmatT, kcols, klens, sub, gaps,
                                               out, scratch, wmax, next);
      break;
    case GA:
      tiles_kernel<GA><<<grid, LANES, 0, st>>>(desc, T, cwords, cw_stride,
                                               kmatT, kcols, klens, sub, gaps,
                                               out, scratch, wmax, next);
      break;
    case SW:
      tiles_kernel<SW><<<grid, LANES, 0, st>>>(desc, T, cwords, cw_stride,
                                               kmatT, kcols, klens, sub, gaps,
                                               out, scratch, wmax, next);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Resident blocks per SM of tiles_kernel<algo> (the persistent grid is SMs
// times this).
int align_dp_tiles_resident(int algo, int* blocks) {
  switch (algo) {
    case NW:
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, tiles_kernel<NW>, LANES, 0);
    case GA:
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, tiles_kernel<GA>, LANES, 0);
    case SW:
      return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, tiles_kernel<SW>, LANES, 0);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The 16-bit form of align_dp_tiles (same arguments and output); grid is
// SMs x align_dp_tiles16_resident(algo) blocks, at most one per two
// c-rows of the launch.
int align_dp_tiles16(const int* desc, int T, const int* cwords,
                     int cw_stride, const int8_t* kmatT, int kcols,
                     const int* klens, const int* sub, const int* gaps,
                     int algo, int* out, int* scratch, int wmax, int* next,
                     int grid, void* stream) {
  int err;
  const void* f = tiles16_function(algo, &err);
  if (!f) return err;
  void* args[] = {&desc, &T, &cwords, &cw_stride, &kmatT, &kcols, &klens,
                  &sub, &gaps, &out, &scratch, &wmax, &next};
  return (int)cudaLaunchKernel(f, dim3(grid), dim3(LANES), args, TILES16_SMEM,
                               static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM of tiles_kernel16<algo>.
int align_dp_tiles16_resident(int algo, int* blocks) {
  int err;
  const void* f = tiles16_function(algo, &err);
  if (!f) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, f, LANES, TILES16_SMEM);
}

// G = 1 launches the one-lane form, G = 2..32 (a power of two) the split
// form; grid is SMs x align_dp_pairs_resident(algo, G > 1) blocks, at most
// one per item, and `next` an int32 zeroed on the stream.
int align_dp_pairs(const int8_t* mat_c, int wc, const int8_t* mat_k, int wk,
                   const int* rc, const int* rk, const int* lens_c,
                   const int* lens_k, int n, const int* sub, const int* gaps,
                   int algo, int* out, int* scratch, int wmax, int G,
                   int* next, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > 32 || (G & (G - 1))) return (int)cudaErrorInvalidValue;
#define PAIRS_LAUNCH(A, S)                                                  \
  pairs_kernel<A, S><<<grid, LANES, 0, st>>>(                              \
      mat_c, wc, mat_k, wk, rc, rk, lens_c, lens_k, n, sub, gaps, out,     \
      scratch, wmax, G, next)
  const bool split = G > 1;
  switch (algo) {
    case NW:
      if (split) PAIRS_LAUNCH(NW, true); else PAIRS_LAUNCH(NW, false);
      break;
    case GA:
      if (split) PAIRS_LAUNCH(GA, true); else PAIRS_LAUNCH(GA, false);
      break;
    case SW:
      if (split) PAIRS_LAUNCH(SW, true); else PAIRS_LAUNCH(SW, false);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PAIRS_LAUNCH
  return (int)cudaGetLastError();
}

// Resident blocks per SM of pairs_kernel<algo, split>.
int align_dp_pairs_resident(int algo, int split, int* blocks) {
#define PAIRS_OCC(A)                                                        \
  (int)(split ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(             \
                    blocks, pairs_kernel<A, true>, LANES, 0)               \
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(             \
                    blocks, pairs_kernel<A, false>, LANES, 0))
  switch (algo) {
    case NW: return PAIRS_OCC(NW);
    case GA: return PAIRS_OCC(GA);
    case SW: return PAIRS_OCC(SW);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PAIRS_OCC
}

// The grid kernel for algo, with its dynamic shared memory limit raised to
// the ring's (above the default 48 KB), or nullptr.
static const void* grid_function(int algo, int* err) {
  const void* f = algo == NW   ? (const void*)grid_kernel<NW>
                  : algo == GA ? (const void*)grid_kernel<GA>
                  : algo == SW ? (const void*)grid_kernel<SW>
                               : nullptr;
  *err = (int)cudaErrorInvalidValue;
  if (!f) return nullptr;
  *err = (int)cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize, GRID_SMEM);
  return *err ? nullptr : f;
}

// form and unit as cuda_dp.grid_form picks them; grid is SMs x
// align_dp_grid_resident(algo) blocks, at most one per item, of LANES + 32
// threads, and `next` an int32 zeroed on the stream.
int align_dp_grid(const int8_t* sk, int S, int W, int Kpad, int B,
                  const int* l1, const int* l2, const int* gaps, int algo,
                  int* out, int* scratch, int wmax, int form, int unit,
                  int* next, int grid, void* stream) {
  int err;
  const void* f = grid_function(algo, &err);
  if (!f) return err;
  if (form < FORM_BULK || form > FORM_BYTES) return (int)cudaErrorInvalidValue;
  void* args[] = {&sk, &S, &W, &Kpad, &B, &l1, &l2, &gaps, &out,
                  &scratch, &wmax, &form, &unit, &next};
  return (int)cudaLaunchKernel(f, dim3(grid), dim3(LANES + 32), args,
                               GRID_SMEM, static_cast<cudaStream_t>(stream));
}

// Resident blocks per SM of grid_kernel<algo>.
int align_dp_grid_resident(int algo, int* blocks) {
  int err;
  const void* f = grid_function(algo, &err);
  if (!f) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, f, LANES + 32, GRID_SMEM);
}

const char* align_dp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
