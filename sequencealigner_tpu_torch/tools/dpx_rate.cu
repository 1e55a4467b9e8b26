// Issue-rate microbenchmark of the DP sweep's integer instructions on one
// SM (tools/dpx_rate.py builds and runs it).
//
// Every kernel runs `iters` steps of CHAINS independent dependency chains per
// thread at full occupancy, and thread 0 of each block records its SM and
// that SM's clock64 before and after (between barriers).  An SM's span is
// its first block's start to its last block's end, so a rate comes out in
// operations (or cells) per SM clock, whatever the clock.  Kinds:
//   IADD    a = a + b           (ptxas picks IADD3 or IMAD.IADD)
//   ADDMAX  a = max(a + b, c)   (__viaddmax_s32)
//   MAX3    a = max(a, b, c)    (__vimax3_s32)
//   NW, GA, SW: one DP cell's arithmetic per chain and step, as dp_column in
//   csrc/align_dp.cu computes it (NW 3 operations, GA 6, SW 7), with the
//   substitution score a register, so no load is timed.
//   ADD2, ADDMAX2, MAX3_2: the 16x2 forms (__vadd2, __viaddmax_s16x2,
//   __vimax3_s16x2), two halfword operations each.
//   NW2, GA2, SW2: the same cells in the 16-bit tile form, two cells (one in
//   each halfword) per chain and step; GA2S: GA's in a domain shifted by
//   (r + c) * extend, where only the diagonal takes an add (a form the
//   kernels do not use: what it would gain).
// The operands depend on earlier steps and on runtime inputs, so no step
// can be folded away; cuobjdump -sass of the library shows what ran.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CHAINS = 8;
enum {
  IADD, ADDMAX, MAX3, NW, GA, SW,
  ADD2, ADDMAX2, MAX3_2, NW2, GA2, SW2, GA2S
};

template <int KIND>
__global__ void rate_kernel(const int* __restrict__ in, int iters,
                            int* __restrict__ out,
                            long long* __restrict__ stamps) {
  int a[CHAINS], x[CHAINS], y[CHAINS], z[CHAINS], b[CHAINS];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) {
    a[k] = in[(threadIdx.x + k) & 63];
    x[k] = in[(threadIdx.x + 3 * k) & 63];
    y[k] = in[(threadIdx.x + 5 * k) & 63];
    z[k] = in[(threadIdx.x + 7 * k) & 63];
    b[k] = in[64 + k];
  }
  const bool pairs = KIND >= ADD2;  // 16x2 kinds: both halfwords
  auto wide = [pairs](int v) {
    return pairs ? (int)((unsigned)(v & 0xffff) * 0x10001u) : v;
  };
  const int gap = wide(in[72]), opn = wide(in[73]), ext = wide(in[74]);
  int best = 0;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) {
      const int n = a[(k + 1) % CHAINS];  // the neighbour chain's value
      if (KIND == IADD) {
        a[k] = (int)((unsigned)a[k] + (unsigned)n);  // wraps
      } else if (KIND == ADDMAX) {
        a[k] = __viaddmax_s32(a[k], b[k], n);
      } else if (KIND == MAX3) {
        a[k] = __vimax3_s32(a[k], x[k], n);
        x[k] = __vimax3_s32(x[k], y[k], a[k]);
      } else if (KIND == ADD2) {
        a[k] = __vadd2(a[k], n);
      } else if (KIND == ADDMAX2) {
        a[k] = __viaddmax_s16x2(a[k], b[k], n);
      } else if (KIND == MAX3_2) {
        a[k] = __vimax3_s16x2(a[k], x[k], n);
        x[k] = __vimax3_s16x2(x[k], y[k], a[k]);
      } else if (KIND == NW2) {
        const int dm = __vadd2(x[k], b[k]);
        x[k] = a[k];
        a[k] = __viaddmax_s16x2(a[k], gap, __viaddmax_s16x2(n, gap, dm));
      } else if (KIND == GA2 || KIND == SW2) {
        const int dm = __vadd2(x[k], b[k]);
        x[k] = a[k];
        y[k] = __viaddmax_s16x2(a[k], opn, __vadd2(y[k], ext));
        z[k] = __viaddmax_s16x2(n, opn, __vadd2(z[k], ext));
        if (KIND == SW2) {
          a[k] = __vimax3_s16x2_relu(dm, y[k], z[k]);
          best = __vmaxs2(best, a[k]);
        } else {
          a[k] = __vimax3_s16x2(dm, y[k], z[k]);
        }
      } else if (KIND == GA2S) {
        // GA in the (r + c) * ext shifted domain: no adds but the diagonal.
        y[k] = __viaddmax_s16x2(a[k], opn, y[k]);
        z[k] = __viaddmax_s16x2(n, opn, z[k]);
        const int d = x[k];
        x[k] = a[k];
        a[k] = __viaddmax_s16x2(d, b[k], __vmaxs2(y[k], z[k]));
      } else if (KIND == NW) {
        // left = a, up = n, diagonal = x
        const int dm = x[k] + b[k];
        x[k] = a[k];
        a[k] = __viaddmax_s32(a[k], gap, __viaddmax_s32(n, gap, dm));
      } else {
        // left = a, up = n, diagonal = x, horizontal gap y, vertical gap z
        const int dm = x[k] + b[k];
        x[k] = a[k];
        y[k] = __viaddmax_s32(a[k], opn, y[k] + ext);
        z[k] = __viaddmax_s32(n, opn, z[k] + ext);
        if (KIND == SW) {
          a[k] = __vimax3_s32_relu(dm, y[k], z[k]);
          best = max(best, a[k]);
        } else {
          a[k] = __vimax3_s32(dm, y[k], z[k]);
        }
      }
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  int r = best;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) r ^= a[k] ^ x[k] ^ y[k] ^ z[k];
  out[(size_t)blockIdx.x * blockDim.x + threadIdx.x] = r;
  if (threadIdx.x == 0) {
    unsigned sm;
    asm("mov.u32 %0, %%smid;" : "=r"(sm));
    stamps[3 * blockIdx.x] = sm;
    stamps[3 * blockIdx.x + 1] = t0;
    stamps[3 * blockIdx.x + 2] = t1;
  }
}

// Per SM: its blocks and the clocks from its first block's start to its
// last block's end; cyc[0] / cyc[1] / cyc[2]: the mean / shortest / longest
// span over the SMs, in SM clocks per block of work (span / blocks).
template <int KIND>
int run(int iters, int threads, double* cyc, int* per_sm, int* sms) {
  cudaError_t e;
  if ((e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, 0)))
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           per_sm, rate_kernel<KIND>, threads, 0)))
    return (int)e;
  const int grid = *sms * *per_sm;
  int host_in[80];
  for (int i = 0; i < 80; ++i) host_in[i] = (i * 7919) % 23 - 11;
  host_in[72] = -4, host_in[73] = -10, host_in[74] = -1;
  int *in = nullptr, *out = nullptr;
  long long* stamps = nullptr;
  long long* host = new long long[3 * grid];
  if (!(e = cudaMalloc(&in, sizeof host_in)) &&
      !(e = cudaMalloc(&out, sizeof(int) * grid * threads)) &&
      !(e = cudaMalloc(&stamps, sizeof(long long) * 3 * grid)) &&
      !(e = cudaMemcpy(in, host_in, sizeof host_in, cudaMemcpyHostToDevice))) {
    rate_kernel<KIND><<<grid, threads>>>(in, iters, out, stamps);
    if (!(e = cudaGetLastError()) && !(e = cudaDeviceSynchronize()) &&
        !(e = cudaMemcpy(host, stamps, sizeof(long long) * 3 * grid,
                         cudaMemcpyDeviceToHost))) {
      const int nsm = 1024;  // more than any card's SM ids
      long long lo[nsm], hi[nsm];
      int count[nsm] = {};
      for (int i = 0; i < grid; ++i) {
        const int sm = (int)host[3 * i];
        if (sm < 0 || sm >= nsm) continue;
        lo[sm] = count[sm] ? (host[3 * i + 1] < lo[sm] ? host[3 * i + 1]
                                                       : lo[sm])
                           : host[3 * i + 1];
        hi[sm] = count[sm] ? (host[3 * i + 2] > hi[sm] ? host[3 * i + 2]
                                                       : hi[sm])
                           : host[3 * i + 2];
        ++count[sm];
      }
      double sum = 0, least = 1e300, most = 0;
      int used = 0;
      for (int sm = 0; sm < nsm; ++sm) {
        if (!count[sm]) continue;
        const double per = (double)(hi[sm] - lo[sm]) / count[sm];
        sum += per;
        least = per < least ? per : least;
        most = per > most ? per : most;
        ++used;
      }
      cyc[0] = sum / used;
      cyc[1] = least;
      cyc[2] = most;
    }
  }
  cudaFree(in);
  cudaFree(out);
  cudaFree(stamps);
  delete[] host;
  return (int)e;
}

}  // namespace

extern "C" {

// One run of kind `kind`: SMs x resident blocks of `threads` threads, each
// `iters` steps; cyc as run() above.
int dpx_rate_run(int kind, int iters, int threads, double* cyc, int* per_sm,
                 int* sms) {
  switch (kind) {
    case IADD: return run<IADD>(iters, threads, cyc, per_sm, sms);
    case ADDMAX: return run<ADDMAX>(iters, threads, cyc, per_sm, sms);
    case MAX3: return run<MAX3>(iters, threads, cyc, per_sm, sms);
    case NW: return run<NW>(iters, threads, cyc, per_sm, sms);
    case GA: return run<GA>(iters, threads, cyc, per_sm, sms);
    case SW: return run<SW>(iters, threads, cyc, per_sm, sms);
    case ADD2: return run<ADD2>(iters, threads, cyc, per_sm, sms);
    case ADDMAX2: return run<ADDMAX2>(iters, threads, cyc, per_sm, sms);
    case MAX3_2: return run<MAX3_2>(iters, threads, cyc, per_sm, sms);
    case NW2: return run<NW2>(iters, threads, cyc, per_sm, sms);
    case GA2: return run<GA2>(iters, threads, cyc, per_sm, sms);
    case SW2: return run<SW2>(iters, threads, cyc, per_sm, sms);
    case GA2S: return run<GA2S>(iters, threads, cyc, per_sm, sms);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* dpx_rate_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
