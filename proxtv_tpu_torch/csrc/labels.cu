// Kernel L1: the flat 4-connected components of a batch of 2D solutions,
// each pixel labelled with the minimum linear index of its component,
// written by hand for Hopper (sm_90a).
//
// No TPU kernel: it replaces the JAX package's XLA while_loop
// proxtv_tpu/ops/diffprox.py:_component_labels, the backward of tv2d_prox,
// which propagates the minimum label two hops a trip until a trip changes
// nothing (one device-to-host check of the loop condition a trip; the
// port's plain version, ops/kernels/labels.py, reads it on the host).  An
// edge is flat where |X[next] - X[here]| <= tol[b], the plain version's
// expression: an IEEE subtraction in X's type, its absolute value and one
// comparison, so the edges are the plain version's bit for bit (a NaN on
// either side is not flat).  The kernels that read X are written for its
// type T and built for float (component_labels) and double
// (component_labels_f64, the backward of a float64 tv2d_prox); the labels
// are int32 in both.
//
// What bounds it on this card: the function reads X once (4 bytes a pixel,
// 8 in float64) and writes the labels once (4 bytes a pixel): 8 MB at
// 1024^2, 2.5 us at 3.35 TB/s (12 MB, 3.8 us in float64).  The
// propagation needs a trip per two hops of a component's diameter (about
// 1000 trips on a flat 1024^2 image, 2^18 on a serpentine one);
// union-find needs none.
//
// Design: block-based union-find in three launches, with no host read.
// The labels array holds the parent pointers (per image linear indices),
// so no workspace is needed.
// * labels_local: a block owns a 32 x 32 tile, a warp a row.  It stages
//   the tile in shared memory with coalesced loads (4 KB, 8 KB in
//   float64).  A warp takes its
//   row's flat right edges as one ballot and points each pixel at the
//   start of its flat run (no atomics, trees one deep); then each flat
//   down edge unions the runs above and below (atomicMin on shared
//   memory), except where the pixel to its left has done so already (its
//   down edge and both right edges between them flat).  Each pixel's
//   local root goes out as its global parent.
// * labels_seams: one thread an edge across a tile border (the left and
//   top borders of every tile), re-classified from X; a flat one unions
//   the two trees in global memory.
// * labels_flatten: every pixel follows its chain to the root and writes
//   the root.
// Why the labels are the plain version's exactly, whatever order the
// blocks run in: a union hooks the larger of two roots under the smaller
// with atomicMin and retries from the value it displaced until it hooks a
// root, and path halving lowers a pointer to its grandparent, so every
// pointer starts at an index of its component no larger than its own (its
// run's start) and only decreases; a displaced link is re-joined by the
// same retry loop, so at the end of labels_seams each component is one
// tree.  Each tree's root is then its smallest index:
// the minimum linear index of the component, the integer the propagation
// converges to.  Pointer reads bypass L1 (__ldcg): other blocks write them
// in L2.  A stale read is never smaller than the true value, and a chain
// strictly decreases until it reaches a root, so no read goes past one.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;      // a block's tile: kTile x kTile pixels
constexpr int kThreads = 256;  // labels_seams, labels_flatten
constexpr int kMaxBlocks = 4096;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool flat(float here, float next, float tol) {
  return fabsf(__fsub_rn(next, here)) <= tol;
}
__device__ __forceinline__ bool flat(double here, double next, double tol) {
  return fabs(__dsub_rn(next, here)) <= tol;
}

// The parent arrays: the tile's in shared memory (Shared), an image's in
// global memory (Global), both written by other threads meanwhile.
struct Shared {
  int* p;
  __device__ __forceinline__ int ld(int x) const {
    return reinterpret_cast<volatile int*>(p)[x];
  }
};
struct Global {
  int* p;
  __device__ __forceinline__ int ld(int x) const { return __ldcg(p + x); }
};

// The root of x, with path halving: x's pointer drops to its grandparent,
// by atomicMin, which only lowers it.  (A plain store could raise it: in
// the last pass, over the root its owner has just written.)
template <class P>
__device__ __forceinline__ int find(P a, int x) {
  for (;;) {
    const int px = a.ld(x);
    if (px == x) return x;
    const int gx = a.ld(px);
    if (gx == px) return px;
    atomicMin(a.p + x, gx);
    x = gx;
  }
}

template <class P>
__device__ void unite(P a, int x, int y) {
  for (;;) {
    x = find(a, x);
    y = find(a, y);
    if (x == y) return;
    if (x > y) {
      const int t = x;
      x = y;
      y = t;
    }
    const int old = atomicMin(a.p + y, x);
    if (old == y) return;
    y = old;  // y was hooked elsewhere meanwhile: join that tree instead
  }
}

template <class T>
__global__ void __launch_bounds__(kTile* kTile)
    labels_local(const T* __restrict__ X, const T* __restrict__ tol,
                 int* __restrict__ lab, int M, int N, int tiles_x,
                 int tiles_y) {
  __shared__ T xs[kTile][kTile];
  __shared__ int ps[kTile * kTile];
  __shared__ unsigned rights[kTile];  // a row's flat right edges, a bit each
  const int tx = threadIdx.x, ty = threadIdx.y;  // lane, warp
  const unsigned blk = blockIdx.x;
  const int bx = blk % tiles_x, by = (blk / tiles_x) % tiles_y;
  const size_t b = blk / ((unsigned)tiles_x * tiles_y);
  const int x = bx * kTile + tx, y = by * kTile + ty;
  const bool in = x < N && y < M;
  const size_t base = b * M * N;
  const int l = ty * kTile + tx;  // row-major in the tile, as in the image
  if (in) xs[ty][tx] = __ldg(X + base + (size_t)y * N + x);
  const T t = __ldg(tol + b);
  __syncthreads();
  // The start of this pixel's flat run in the row: one past the last edge
  // before it that is not flat.  (A pixel in the image has only pixels in
  // the image to its left.)
  const unsigned right = __ballot_sync(
      kFull, in && tx + 1 < kTile && x + 1 < N &&
                 flat(xs[ty][tx], xs[ty][tx + 1], t));
  const unsigned breaks = ~right & ((1u << tx) - 1);
  ps[l] = ty * kTile + (breaks ? 32 - __clz(breaks) : 0);
  if (tx == 0) rights[ty] = right;
  __syncthreads();
  const bool down =
      in && ty + 1 < kTile && y + 1 < M && flat(xs[ty][tx], xs[ty + 1][tx], t);
  const unsigned downs = __ballot_sync(kFull, down);
  if (down) {
    const unsigned left = tx ? 1u << (tx - 1) : 0u;  // the edge to the left
    if (!(downs & right & rights[ty + 1] & left))
      unite(Shared{ps}, l, l + kTile);
  }
  __syncthreads();
  if (in) {
    const int r = find(Shared{ps}, l);
    lab[base + (size_t)y * N + x] =
        (by * kTile + r / kTile) * N + bx * kTile + r % kTile;
  }
}

// Edge k of an image: first the (tiles_x - 1) M edges across the vertical
// seams (seam s + 1 at column (s + 1) kTile, row y), then the
// (tiles_y - 1) N across the horizontal ones.
template <class T>
__global__ void __launch_bounds__(kThreads)
    labels_seams(const T* __restrict__ X, const T* __restrict__ tol,
                 int* lab, int M, int N, int tiles_x, long long per_image,
                 long long total) {
  const long long nv = (long long)(tiles_x - 1) * M;
  for (long long e = blockIdx.x * (long long)kThreads + threadIdx.x;
       e < total; e += (long long)gridDim.x * kThreads) {
    const long long b = e / per_image;
    const long long k = e - b * per_image;
    int here, next;
    if (k < nv) {
      here = (int)(k % M) * N + (int)(k / M + 1) * kTile - 1;
      next = here + 1;
    } else {
      const long long h = k - nv;
      next = (int)(h / N + 1) * kTile * N + (int)(h % N);
      here = next - N;
    }
    const size_t base = (size_t)b * M * N;
    if (flat(__ldg(X + base + here), __ldg(X + base + next), __ldg(tol + b)))
      unite(Global{lab + base}, here, next);
  }
}

__global__ void __launch_bounds__(kThreads)
    labels_flatten(int* lab, long long mn, long long total) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x;
       i < total; i += (long long)gridDim.x * kThreads) {
    const long long b = i / mn;
    int* p = lab + b * mn;
    const int x = (int)(i - b * mn);
    __stcg(p + x, find(Global{p}, x));  // the least value p[x] can take
  }
}

unsigned grid_for(long long total) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  return (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

template <class T>
int run(const T* X, const T* tol, int* labels, int B, int M, int N,
        cudaStream_t stream) {
  if (B <= 0 || M <= 0 || N <= 0) return 0;
  const long long mn = (long long)M * N;
  const int tiles_x = (N + kTile - 1) / kTile;
  const int tiles_y = (M + kTile - 1) / kTile;
  const long long tiles = (long long)tiles_x * tiles_y * B;
  if (mn > INT_MAX || tiles > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  labels_local<T><<<(unsigned)tiles, dim3(kTile, kTile), 0, stream>>>(
      X, tol, labels, M, N, tiles_x, tiles_y);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long per_image =
      (long long)(tiles_x - 1) * M + (long long)(tiles_y - 1) * N;
  if (per_image > 0) {
    labels_seams<T><<<grid_for(per_image * B), kThreads, 0, stream>>>(
        X, tol, labels, M, N, tiles_x, per_image, per_image * B);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  labels_flatten<<<grid_for(mn * B), kThreads, 0, stream>>>(labels, mn,
                                                            mn * B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// X: (B, M, N) float32, tol: (B,) float32, labels: (B, M, N) int32 (the
// output, also the parent array), all contiguous.  M N < 2^31 and
// B ceil(M / 32) ceil(N / 32) < 2^31 (a refused size returns
// cudaErrorInvalidValue; the Python wrapper checks the first).
extern "C" int component_labels(const float* X, const float* tol, int* labels,
                                int B, int M, int N, cudaStream_t stream) {
  return run<float>(X, tol, labels, B, M, N, stream);
}

// The same for float64 X and tol (the labels int32).
extern "C" int component_labels_f64(const double* X, const double* tol,
                                    int* labels, int B, int M, int N,
                                    cudaStream_t stream) {
  return run<double>(X, tol, labels, B, M, N, stream);
}
