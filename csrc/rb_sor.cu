// Red-black SOR sweeps for the pressure-correction inner stage, called from
// JAX through the XLA foreign function interface (ops/sor_kernel.py).
//
// Solves A delta = rhs from delta = 0 with the folded-Neumann formulation of
// ops/sor_kernel.py::_roll_sweeps_xla: the ghost ring stays zero and the
// missing neighbour of a boundary-adjacent cell is added back through a
// per-cell self-coefficient, so no ghost fill runs between half-sweeps.
// Colours follow the global checkerboard (i + j) % 2 with red (0) first.
//
// One thread block owns a tile of tile_i x tile_j cells.  It loads the tile
// plus a halo of depth 2k into shared memory, runs up to k red-black sweeps
// there with a block barrier between half-sweeps, and writes back only the
// tile's core.  Stale halo values corrupt one more ring of cells per
// half-sweep, so after at most 2k half-sweeps the core is exactly what
// whole-grid sweeps would give.  Blocks share nothing within a launch; the
// handler chains launches of at most k sweeps each through global memory.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

struct SweepArgs {
  int ni, nj;          // padded grid (i_max + 2, j_max + 2)
  int tile_i, tile_j;  // core cells written by one block
  int k;               // most sweeps of one launch; the halo is 2k deep
  float omega, coef, dx2_inv, dy2_inv;
};

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// d_in == nullptr starts from delta = 0.  The launch runs
// clamp(*n_total - launch * k, 0, k) sweeps: later launches of a call whose
// sweep count is short of the handler's bound only copy the field.
__global__ void __launch_bounds__(kBlockX * kBlockY)
rb_sor_tile(const float* __restrict__ d_in, const float* __restrict__ rhs,
            float* __restrict__ d_out, const int32_t* __restrict__ n_total,
            int launch, SweepArgs a) {
  extern __shared__ float smem[];
  const int halo = 2 * a.k;
  const int ei = a.tile_i + 2 * halo;
  const int ej = a.tile_j + 2 * halo;
  float* d = smem;
  float* r = smem + ei * ej;
  const int i0 = blockIdx.y * a.tile_i - halo;  // global row of local row 0
  const int j0 = blockIdx.x * a.tile_j - halo;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  for (int idx = tid; idx < ei * ej; idx += nthreads) {
    const int li = idx / ej;
    const int lj = idx - li * ej;
    const int gi = i0 + li;
    const int gj = j0 + lj;
    const bool in = gi >= 0 && gi < a.ni && gj >= 0 && gj < a.nj;
    const size_t g = static_cast<size_t>(gi) * a.nj + gj;
    d[idx] = (in && d_in != nullptr) ? d_in[g] : 0.0f;
    r[idx] = in ? rhs[g] : 0.0f;
  }
  const int sweeps = min(max(*n_total - launch * a.k, 0), a.k);
  __syncthreads();

  const float keep = 1.0f - a.omega;
  for (int h = 1; h <= 2 * sweeps; ++h) {
    const int color = (h - 1) & 1;
    // Cells closer than h to the tile edge are already stale: skip them.
    const int hi_i = ei - 1 - h;
    const int hi_j = ej - 1 - h;
    for (int li = h + threadIdx.y; li <= hi_i; li += blockDim.y) {
      const int gi = i0 + li;
      if (gi < 1 || gi > a.ni - 2) continue;
      const float row_coef =
          static_cast<float>((gi == 1) + (gi == a.ni - 2)) * a.dx2_inv;
      // First local column of this colour: (gi + j0 + lj) % 2 == color.
      const int lj0 = h + ((gi + j0 + h + color) & 1);
      for (int lj = lj0 + 2 * threadIdx.x; lj <= hi_j; lj += 2 * blockDim.x) {
        const int gj = j0 + lj;
        if (gj < 1 || gj > a.nj - 2) continue;
        const int c = li * ej + lj;
        const float dc = d[c];
        const float self_coef =
            row_coef +
            static_cast<float>((gj == 1) + (gj == a.nj - 2)) * a.dy2_inv;
        const float nb = (d[c - ej] + d[c + ej]) * a.dx2_inv +
                         (d[c - 1] + d[c + 1]) * a.dy2_inv + dc * self_coef;
        d[c] = keep * dc + a.coef * (nb - r[c]);
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < a.tile_i * a.tile_j; idx += nthreads) {
    const int ci = idx / a.tile_j;
    const int cj = idx - ci * a.tile_j;
    const int gi = i0 + halo + ci;
    const int gj = j0 + halo + cj;
    if (gi < a.ni && gj < a.nj) {
      d_out[static_cast<size_t>(gi) * a.nj + gj] =
          d[(ci + halo) * ej + cj + halo];
    }
  }
}

ffi::Error RbSorSweepsImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> rhs,
                           ffi::Buffer<ffi::S32> n_sweeps,
                           ffi::ResultBuffer<ffi::F32> out,
                           ffi::ResultBuffer<ffi::F32> scratch, int32_t k,
                           int32_t tile_i, int32_t tile_j, int32_t max_sweeps,
                           float omega, float coef, float dx2_inv,
                           float dy2_inv) {
  const auto dims = rhs.dimensions();
  if (dims.size() != 2) {
    return ffi::Error::InvalidArgument("rb_sor: rhs must be two-dimensional");
  }
  if (k < 1 || tile_i < 1 || tile_j < 1 || max_sweeps < 1) {
    return ffi::Error::InvalidArgument(
        "rb_sor: k, tile sizes and max_sweeps must be positive");
  }
  SweepArgs a{static_cast<int>(dims[0]), static_cast<int>(dims[1]),
              tile_i, tile_j, k, omega, coef, dx2_inv, dy2_inv};
  const int ei = tile_i + 4 * k;
  const int ej = tile_j + 4 * k;
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(ei) * ej;
  cudaError_t err = cudaFuncSetAttribute(
      rb_sor_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  const dim3 grid((a.nj + tile_j - 1) / tile_j, (a.ni + tile_i - 1) / tile_i);
  const dim3 block(kBlockX, kBlockY);
  const int launches = (max_sweeps + k - 1) / k;
  // Ping-pong between the two results so that the last launch writes `out`.
  float* bufs[2] = {out->typed_data(), scratch->typed_data()};
  const float* src = nullptr;
  for (int c = 0; c < launches; ++c) {
    float* dst = bufs[(launches - 1 - c) & 1];
    rb_sor_tile<<<grid, block, smem, stream>>>(src, rhs.typed_data(), dst,
                                               n_sweeps.typed_data(), c, a);
    src = dst;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(NspRbSorSweeps, RbSorSweepsImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Attr<int32_t>("k")
                                  .Attr<int32_t>("tile_i")
                                  .Attr<int32_t>("tile_j")
                                  .Attr<int32_t>("max_sweeps")
                                  .Attr<float>("omega")
                                  .Attr<float>("coef")
                                  .Attr<float>("dx2_inv")
                                  .Attr<float>("dy2_inv"));
