// What fused_step.cu and exact_fallback.cu share: the block's threads, the
// blocks of a thread-block cluster (both overridable with -D), and the prefix's
// branch rule, tau at or above which (or not finite) the exact fallback runs.
#pragma once

#ifndef NTHREADS
#define NTHREADS 512
#endif
#define NWARPS (NTHREADS / 32)
#ifndef VJF_CLUSTER
#define VJF_CLUSTER 8
#endif
#define NS_TAU_THRESHOLD 0.25f
