// Phase stamps of the RBF Gram kernels (gram.cu and the first version in
// baseline_kernels.cu).  Built with -DGRAM_PROFILE every warp stamps
// clock64() at the end of each phase and adds its totals to a __device__
// array of GP_COUNT + 1 counters, the last one the warps counted; without
// it the macros cost nothing and GPROF_SYNC is a plain barrier.
//
//   GPROF_DECL           at the kernel's start
//   GPROF_MARK(ph)       ends phase ph
//   GPROF_SYNC(ph)       a barrier that ends phase ph, its wait counted in
//                        GP_BARRIER (the stamp feeds the barrier's
//                        predicate, so that it is read before the wait)
//   GPROF_FLUSH(cycles)  lane 0 of each warp adds its totals to `cycles`

#pragma once

enum GramPhase {
  GP_STAGE, GP_NORMS, GP_CROSS, GP_STORE, GP_BARRIER, GP_COPY, GP_COUNT
};

#ifdef GRAM_PROFILE
#define GPROF_DECL                  \
  long long gp_last = clock64();    \
  long long gp_acc[GP_COUNT] = {};
#define GPROF_MARK(ph)                 \
  do {                                 \
    const long long now_ = clock64();  \
    gp_acc[ph] += now_ - gp_last;      \
    gp_last = now_;                    \
  } while (0)
#define GPROF_SYNC(ph)                         \
  do {                                         \
    const long long at_ = clock64();           \
    gp_acc[ph] += at_ - gp_last;               \
    __syncthreads_or(at_ == 0);                \
    gp_last = clock64();                       \
    gp_acc[GP_BARRIER] += gp_last - at_;       \
  } while (0)
#define GPROF_FLUSH(cycles)                                             \
  do {                                                                  \
    if ((threadIdx.x & 31) == 0) {                                      \
      for (int p_ = 0; p_ < GP_COUNT; ++p_)                             \
        atomicAdd(&(cycles)[p_],                                        \
                  static_cast<unsigned long long>(gp_acc[p_]));         \
      atomicAdd(&(cycles)[GP_COUNT], 1ull);                             \
    }                                                                   \
  } while (0)
#else
#define GPROF_DECL
#define GPROF_MARK(ph) \
  do {                 \
  } while (0)
#define GPROF_SYNC(ph) __syncthreads()
#define GPROF_FLUSH(cycles) \
  do {                      \
  } while (0)
#endif
