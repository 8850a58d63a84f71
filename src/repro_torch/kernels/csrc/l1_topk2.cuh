// L1 top-2 against a set of centroids, shared by the l1_topk2 kernel and the
// fused serve kernel (serve_fused.cu).
//
// Summation order.  Every L1 distance is summed in ONE fixed order, the order
// the reference (XLA on the CPU) uses for a float sum over an axis longer
// than 32: the axis is padded with zeros to a multiple of 32 (half the pad in
// front, the rest behind), each window of 32 is summed sequentially, and the
// window sums are summed the same way again until at most 32 remain, which
// are summed sequentially.  Adding a padding zero is exact, so the pad never
// has to be materialised: OrderedSum streams the elements in index order and
// only tracks which window each one falls into.  The plain PyTorch version
// (repro_torch.kernels.l1_topk2.ordered_sum) takes the same order, so kernel
// and plain version agree bit for bit.  Build with -fmad=false.
#pragma once

#define L1_POS 1e30f   // second-minimum mask value of the reference
#define L1_WIN 32      // window of the reference's tree reduction
#define L1_MAX_LEVELS 3

struct OrderedSum {
  int nwin;                 // windowed levels (0: plain sequential sum)
  int lo[L1_MAX_LEVELS];    // front padding of each windowed level
  int cur[L1_MAX_LEVELS];   // window currently being summed at each level
  float acc[L1_MAX_LEVELS];
  float top;

  __device__ explicit OrderedSum(int n) : nwin(0), top(0.f) {
    int m = n;
    while (m > L1_WIN && nwin < L1_MAX_LEVELS) {
      int pad = (L1_WIN - m % L1_WIN) % L1_WIN;
      lo[nwin] = pad / 2;
      cur[nwin] = 0;
      acc[nwin] = 0.f;
      m = (m + pad) / L1_WIN;
      ++nwin;
    }
  }

  // Add element i of level l (level 0 = the input axis).
  __device__ void add(int l, int i, float v) {
    while (true) {
      if (l == nwin) {
        top = top + v;
        return;
      }
      int w = (i + lo[l]) / L1_WIN;
      if (w == cur[l]) {
        acc[l] = acc[l] + v;
        return;
      }
      // element i opens the next window: the finished window's sum is the
      // next element of level l + 1
      float up = acc[l];
      int up_i = cur[l];
      acc[l] = 0.f + v;
      cur[l] = w;
      l += 1;
      i = up_i;
      v = up;
    }
  }

  __device__ float finish() {
    for (int l = 0; l < nwin; ++l) add(l + 1, cur[l], acc[l]);
    return top;
  }
};

// Row access for a dense (k, d) centroid block.
struct DenseCentroids {
  const float* c;
  int d;
  __device__ float operator()(int cl, int j) const { return c[(long)cl * d + j]; }
};

// Row access through a column index list: centroid cl, column idx[j] of a
// (k, F) block (the serve path reads only the selected columns).
struct GatheredCentroids {
  const float* c;
  const int* idx;
  int F;
  __device__ float operator()(int cl, int j) const {
    return c[(long)cl * F + idx[j]];
  }
};

// d1 = smallest distance, idx = its first index, d2 = smallest distance of
// the others (L1_POS when k == 1): the reference's min / argmin / masked min.
template <class Cent>
__device__ void l1_top2(const float* x, int d, int k, const Cent& cent,
                        float* d1_out, float* d2_out, int* idx_out) {
  float d1 = 0.f, d2 = L1_POS;
  int idx = 0;
  for (int cl = 0; cl < k; ++cl) {
    OrderedSum s(d);
    for (int j = 0; j < d; ++j) s.add(0, j, fabsf(x[j] - cent(cl, j)));
    float dist = s.finish();
    if (cl == 0) {
      d1 = dist;
    } else if (dist < d1) {
      d2 = fminf(d2, d1);
      d1 = dist;
      idx = cl;
    } else {
      d2 = fminf(d2, dist);
    }
  }
  *d1_out = d1;
  *d2_out = d2;
  *idx_out = idx;
}

// The scale-free utility margin of the reference (kmeans.classify).
__device__ __forceinline__ float l1_margin(float d1, float d2) {
  return (d2 - d1) / fmaxf(d1 + d2, 1e-9f);
}
